"""The whole-tree optimizer update: one CUDA launch a step (two for the
rules that need per-tensor norms) for every parameter of a (device,
dtype) group, its plain version, its launch count and the table builder.

Replaces what ``Optimizer.apply_pytree`` (paddle_tpu/optimizer/__init__.py
:155) gives the reference: one update over the whole parameter tree, which
XLA fuses into the jitted, donated train step
(paddle_tpu/hapi/engine.py:517).  It is no ``pallas_call``.  The rules are
those of the port's twelve optimizers; :func:`update_plain` is their
arithmetic, in eager ops in the reference's order, and the optimizers'
``_update`` call it.

Two kernels (csrc/multi_tensor_optim.cu), both bound by bytes:

- :func:`multi_tensor_step` (``multi_tensor_kernel``): the elementwise
  rules, SGD, Momentum (plain and Nesterov), Adam, AdamW, Adagrad, Adamax,
  Adadelta, RMSProp (plain and centered) and Ftrl, with the coupled decay
  of a float or ``L2Decay`` (g + c p) or ``L1Decay`` (g + c sign(p))
  applied to the gradient first.  Its result is bitwise the eager loop's
  on the card: it copies each eager op's float32 (or bf16) rounding.
  Blocks take chunks of elements (:func:`chunk_groups`), sized to the
  launch (:func:`tree_chunk`), so one large embedding and many small
  biases balance and a small tree still spreads over the SMs.
- :func:`multi_tensor_norm_step` (``norm_partials_kernel`` then
  ``norm_update_kernel``): Lamb (trust ratio ||p|| / ||r||), LarsMomentum
  (local lr from ||p|| and ||g||) and Dpsgd (per-tensor clip by ||g||,
  Gaussian noise).  The first launch writes each chunk's float32 partial
  sums of squares (Lamb also updates its moments there); the second sums a
  tensor's partials in a fixed order and updates.  Its chunk is
  :data:`CHUNK`.  No atomics, so a replay is bitwise repeatable; the
  norms' summation order is not torch's, so it holds the eager loop to
  :data:`NORM_RTOL` rather than bitwise.

Both read their scalars (:func:`hyper_floats`) from a float32
[:data:`N_SCALARS`] device tensor written from the host by
:func:`write_scalars` without a sync: the training engine's host prologue
writes the step's before each replay of its captured step, whose launches
hold the tensor's address, not the values.  The host builds a table of
per-tensor pointers and counts and passes it as one launch parameter: no
host sync.

Slots are updated IN PLACE (the loop replaced them with new tensors): the
reference's state arrays are immutable, so ``Optimizer.state_dict()``
hands out copies.  Slot dtypes are the reference's: Adam-family moments
float32, every other slot the parameter's dtype.  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ...framework.place import copy_to_device
from . import build
from .flash_attention import philox4x32_10

# the elementwise rules (multi_tensor_kernel), in the source's Kind order
KINDS = ("sgd", "momentum", "nesterov", "adam", "adamw", "adagrad",
         "adamax", "adadelta", "rmsprop", "rmsprop_centered", "ftrl")
# the rules that need per-tensor norms (norm_partials / norm_update)
NORM_KINDS = ("lamb", "lars", "dpsgd")
SLOTS = {"sgd": 0, "momentum": 1, "nesterov": 1, "adam": 2, "adamw": 2,
         "adagrad": 1, "adamax": 2, "adadelta": 2, "rmsprop": 3,
         "rmsprop_centered": 3, "ftrl": 2, "lamb": 2, "lars": 1,
         "dpsgd": 0}
DECAYS = ("none", "l2", "l1")     # the coupled decay: the source's decay
CHUNK = 1 << 16          # the most elements a block of multi_tensor_kernel
CHUNK_FLOOR = 4 * 256    # the least: one round of its 256 threads
BLOCKS_PER_SM = 2        # the blocks a launch aims at on each SM
MAX_TENSORS = 512        # tensors a launch: kMaxTensors of the source
_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_int) \
    + (ctypes.c_void_p,) * 5 + (ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p)
_NORM_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int) \
    + (ctypes.c_void_p,) * 4 + (ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_ulonglong, ctypes.c_void_p,
                                ctypes.c_void_p)
N_SCALARS = 16           # the kernels' Hyper
# rtol of the norm rules' kernel against the eager loop: the norms sum in
# another order (float32 partial sums of 65,536-element chunks), which
# moves ||p|| and ||r|| by a few float32 ulps; the ratio and the update
# inherit about twice that; a bf16 value rounds it away or to the next
# bf16 value, twice over a slot that accumulates steps (LARS's velocity):
# two bf16 ulps
NORM_RTOL = 1e-5
NORM_BF16_RTOL = 2 ** -6
# Ftrl's x ** lp as torch's pow(Tensor, Scalar) dispatches it on the card:
# sqrt, rsqrt, reciprocal and square have kernels of their own
_POW_MODES = {0.5: 1, -0.5: 2, -1.0: 3, 2.0: 4}


def bias_correction(beta, t):
    """1 - beta ** t in float32, the step as a float32 (the reference
    computes it on device from ``jnp.asarray(t, jnp.float32)``)."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(t))


def slot_dtype(kind, p_dtype):
    """The dtype of ``kind``'s slots for a parameter of ``p_dtype``: the
    reference's, float32 Adam moments and ``zeros_like(p)`` elsewhere."""
    return torch.float32 if kind in ("adam", "adamw") else p_dtype


def decay_plain(mode, coeff, p, g):
    """The coupled decay of the gradient (``Optimizer._apply_decay`` of a
    float or a regularizer): L2 ``g + c * p``, L1 ``g + c * sign(p)``."""
    if mode == "l2":
        return g + coeff * p
    if mode == "l1":
        return g + coeff * torch.sign(p)
    return g


def _norm(x):
    """The float32 L2 norm of ``x`` as a 0-d tensor."""
    return torch.linalg.vector_norm(x.float())


def dpsgd_noise_plain(seed, index, n, device="cpu"):
    """Dpsgd's standard normal noise for tensor ``index`` of a step, ``n``
    float32 values, as the kernel draws them: Philox4x32-10 keyed by
    ``seed`` (64 bits), counter (e // 4, index, 0, 0) for element e; words
    (0, 1) give elements 4k, 4k + 1 and words (2, 3) give 4k + 2, 4k + 3 by
    Box-Muller, u1 = (2 (w >> 9) + 1) 2^-24 in (0, 1) and u2 = (w >> 8)
    2^-24 in [0, 1): sqrt(-2 ln u1) (cos, sin)(2 pi u2)."""
    groups = -(-n // 4)
    c0 = torch.arange(groups, dtype=torch.int64, device=device)
    zero = torch.zeros_like(c0)
    key = (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF)
    words = philox4x32_10((c0, zero + index, zero, zero), key)
    out = []
    for a, b in ((words[0], words[1]), (words[2], words[3])):
        u1 = ((a >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24
        u2 = (b >> 8).to(torch.float32) * 2.0 ** -24
        r = torch.sqrt(-2.0 * torch.log(u1))
        theta = u2 * float(np.float32(2 * math.pi))
        out += [r * torch.cos(theta), r * torch.sin(theta)]
    z = torch.stack(out, 1).reshape(-1)
    return z[:n]


def update_plain(kind, p, g, slots, lr, t, hyper, seed=0, index=0):
    """One rule on one tensor in eager ops, in the reference's order:
    returns (new_p, new_slots) without touching p or the slots.  ``slots``
    in the rule's order (:data:`SLOTS`; float32 Adam moments, else p's
    dtype); ``hyper``: the rule's coefficients (``momentum``, ``beta1``,
    ``beta2``, ``epsilon``, ``weight_decay``, ``rho``, ``l1``, ``l2``,
    ``lr_power``, ``lars_coeff``, ``clip``, ``sigma``, ``batch_size``);
    Dpsgd's noise is :func:`dpsgd_noise_plain` of (``seed``, ``index``).
    The coupled decay is the caller's (:func:`decay_plain`)."""
    if kind == "sgd":
        return p - lr * g, []
    if kind in ("momentum", "nesterov"):
        mu = hyper["momentum"]
        v = mu * slots[0] + g
        if kind == "nesterov":
            return p - lr * (g + mu * v), [v]
        return p - lr * v, [v]
    if kind in ("adam", "adamw"):
        b1, b2 = hyper["beta1"], hyper["beta2"]
        g32 = g.float()
        m = b1 * slots[0] + (1 - b1) * g32
        v = b2 * slots[1] + (1 - b2) * g32.square()
        mhat = m / bias_correction(b1, t)
        vhat = v / bias_correction(b2, t)
        upd = lr * mhat / (vhat.sqrt() + hyper["epsilon"])
        new_p = p - upd.to(p.dtype)
        if kind == "adamw":
            # decoupled decay (the adamw flag in optimizers/adam_op.cc)
            new_p = new_p - lr * hyper["weight_decay"] * p
        return new_p, [m, v]
    if kind == "adagrad":
        m = slots[0] + g.square()
        return p - lr * g / (m.sqrt() + hyper["epsilon"]), [m]
    if kind == "adamax":
        b1, b2 = hyper["beta1"], hyper["beta2"]
        m = b1 * slots[0] + (1 - b1) * g
        u = torch.maximum(b2 * slots[1], g.abs())
        # lr / (1 - b1 ** t): a float32 scalar, as the reference forms it
        lr_t = float(np.float32(lr) / np.float32(bias_correction(b1, t)))
        return p - lr_t * m / (u + hyper["epsilon"]), [m, u]
    if kind == "adadelta":
        rho, eps = hyper["rho"], hyper["epsilon"]
        asg = rho * slots[0] + (1 - rho) * g.square()
        upd = g * (slots[1] + eps).sqrt() / (asg + eps).sqrt()
        asu = rho * slots[1] + (1 - rho) * upd.square()
        return p - lr * upd, [asg, asu]
    if kind in ("rmsprop", "rmsprop_centered"):
        rho, eps = hyper["rho"], hyper["epsilon"]
        ms = rho * slots[0] + (1 - rho) * g.square()
        if kind == "rmsprop_centered":
            mg = rho * slots[1] + (1 - rho) * g
            denom = (ms - mg.square() + eps).sqrt()
        else:
            mg = slots[1]
            denom = (ms + eps).sqrt()
        mom = hyper["momentum"] * slots[2] + lr * g / denom
        return p - mom, [ms, mg, mom]
    if kind == "ftrl":
        l1, l2, lp = hyper["l1"], hyper["l2"], -hyper["lr_power"]
        sq_new = slots[0] + g.square()
        sigma = (sq_new ** lp - slots[0] ** lp) / lr
        lin = slots[1] + g - sigma * p
        quad = sq_new ** lp / lr + 2 * l2
        pre = torch.sign(lin) * l1 - lin
        new_p = torch.where(lin.abs() > l1, pre / quad,
                            torch.zeros_like(pre))
        return new_p, [sq_new, lin]
    if kind == "lamb":
        b1, b2 = hyper["beta1"], hyper["beta2"]
        m = b1 * slots[0] + (1 - b1) * g
        v = b2 * slots[1] + (1 - b2) * g.square()
        # the bias-corrected moments are float32, as the reference's
        # division by its float32 step makes them
        mhat = m.float() / bias_correction(b1, t)
        vhat = v.float() / bias_correction(b2, t)
        r = mhat / (vhat.sqrt() + hyper["epsilon"]) \
            + hyper["weight_decay"] * p
        w_norm, r_norm = _norm(p), _norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return p - lr * trust * r, [m, v]
    if kind == "lars":
        wd, eps = hyper["weight_decay"], hyper["epsilon"]
        w_norm, g_norm = _norm(p), _norm(g)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            hyper["lars_coeff"] * w_norm / (g_norm + wd * w_norm + eps),
            torch.ones_like(w_norm))
        v = hyper["momentum"] * slots[0] + lr * local_lr * (g + wd * p)
        return p - v, [v]
    if kind == "dpsgd":
        clip = hyper["clip"]
        g = g / torch.clamp(_norm(g) / clip, min=1.0)
        noise = dpsgd_noise_plain(seed, index, p.numel(), p.device)
        noise = (noise * hyper["sigma"] * clip / hyper["batch_size"]) \
            .reshape(p.shape)
        return p - lr * (g + noise.to(g.dtype)), []
    raise ValueError(f"update_plain: no rule {kind!r}")


@torch.no_grad()
def multi_tensor_step_plain(kind, params, grads, slots, lr, t, hyper,
                            seed=0, base=0):
    """:func:`decay_plain` of ``hyper``'s ``decay`` and ``decay_coeff``,
    then :func:`update_plain` on each tensor, written back in place
    (Dpsgd's noise indices from ``base``, as the kernel's)."""
    mode, coeff = hyper.get("decay", "none"), hyper.get("decay_coeff", 0.0)
    live = base         # Dpsgd's noise index: the non-empty tensors before
    for p, g, s in zip(params, grads, slots):
        g = decay_plain(mode, coeff, p, g)
        new_p, new_s = update_plain(kind, p, g, s, lr, t, hyper, seed, live)
        live += p.numel() > 0
        p.copy_(new_p)
        for old, new in zip(s, new_s):
            old.copy_(new)
    return tuple(params)


def hyper_floats(kind, lr, t, hyper):
    """The kernels' sixteen scalars, each the float32 value its eager op
    uses (each Python expression formed in double first, then cast; a
    division of a CUDA tensor by a host scalar x multiplies by its
    reciprocal, formed in double and cast, ``float(1.0 / x)``, so that
    reciprocal is the scalar; the bias corrections, float32 values
    already, as ``1.0f / float(bc)``):
    0 lr, 1 beta1 (Momentum's and LARS's momentum, Adadelta's and RMSProp's
    rho), 2 1 - beta1, 3 beta2, 4 1 - beta2, 5 and 6 the bias corrections'
    reciprocals, 7 eps, 8 lr * AdamW's weight decay, 9 Lamb's or LARS's
    weight decay, 10-13 the rule's own (Adamax lr / (1 - beta1 ** t);
    RMSProp the momentum; Ftrl l1, 2 * l2, 1 / lr, -lr_power; LARS the
    coefficient; Dpsgd 1 / clip, sigma, clip, 1 / batch_size), 14 the
    coupled decay's coefficient."""
    f = np.float32
    h = hyper
    vals = [0.0] * N_SCALARS
    vals[0] = lr
    vals[14] = h.get("decay_coeff", 0.0)
    if kind in ("momentum", "nesterov"):
        vals[1] = h["momentum"]
    elif kind in ("adam", "adamw", "lamb"):
        b1, b2 = h["beta1"], h["beta2"]
        vals[1:8] = [b1, 1 - b1, b2, 1 - b2,
                     f(1.0) / f(bias_correction(b1, t)),
                     f(1.0) / f(bias_correction(b2, t)), h["epsilon"]]
        if kind == "adamw":
            vals[8] = lr * h["weight_decay"]
        if kind == "lamb":
            vals[9] = h["weight_decay"]
    elif kind == "adagrad":
        vals[7] = h["epsilon"]
    elif kind == "adamax":
        b1 = h["beta1"]
        vals[1:5] = [b1, 1 - b1, h["beta2"], 0.0]
        vals[7] = h["epsilon"]
        vals[10] = f(lr) / f(bias_correction(b1, t))
    elif kind in ("adadelta", "rmsprop", "rmsprop_centered"):
        vals[1:3] = [h["rho"], 1 - h["rho"]]
        vals[7] = h["epsilon"]
        if kind != "adadelta":
            vals[10] = h["momentum"]
    elif kind == "ftrl":
        vals[10:14] = [h["l1"], 2 * h["l2"], 1.0 / lr, -h["lr_power"]]
    elif kind == "lars":
        vals[1] = h["momentum"]
        vals[7] = h["epsilon"]
        vals[9] = h["weight_decay"]
        vals[10] = h["lars_coeff"]
    elif kind == "dpsgd":
        vals[10:14] = [1.0 / h["clip"], h["sigma"], h["clip"],
                       1.0 / h["batch_size"]]
    return tuple(float(f(v)) for v in vals)


def write_scalars(scalars, kind, lr, t, hyper):
    """Write :func:`hyper_floats` of (``kind``, ``lr``, step ``t``) into
    ``scalars`` (a float32 [16] tensor), on the current stream and without
    a host sync; the kernels that read them later in the stream see
    them."""
    copy_to_device(scalars, hyper_floats(kind, lr, t, hyper))
    return scalars


def make_scalars(device):
    """An (unwritten) float32 [16] tensor of kernel scalars on
    ``device``."""
    return torch.empty(N_SCALARS, dtype=torch.float32, device=device)


def tree_chunk(n, sm_count):
    """Elements a block of ``multi_tensor_kernel`` for a launch of ``n``
    elements on a card of ``sm_count`` SMs: enough blocks for
    :data:`BLOCKS_PER_SM` on every SM where the tree has the elements, in
    multiples of :data:`CHUNK_FLOOR` (one round of the block), at most
    :data:`CHUNK`.  A large tree keeps the largest chunk; a small one is
    cut finer, so that its largest tensor is not walked by a few blocks in
    many dependent rounds."""
    want = -(-n // (BLOCKS_PER_SM * sm_count))
    return min(CHUNK, max(CHUNK_FLOOR,
                          -(-want // CHUNK_FLOOR) * CHUNK_FLOOR))


def chunk_groups(numels, chunk=None, max_tensors=MAX_TENSORS, sm_count=None):
    """Split tensors of ``numels`` elements into launches: a list of
    (indices, chunk0, chunk), one per launch, of at most ``max_tensors``
    tensors each, empty tensors left out; ``chunk`` the launch's elements a
    chunk (the given one, else :func:`tree_chunk` of the launch's elements
    on ``sm_count`` SMs); ``chunk0[i]`` is the first chunk of the i-th
    tensor of the launch and ``chunk0[-1]`` the launch's chunks.  Chunk b
    of a launch is elements [c * chunk, min((c + 1) * chunk, n)) of the
    last tensor i with chunk0[i] <= b, c = b - chunk0[i]."""
    live = [i for i, n in enumerate(numels) if n > 0]
    groups = []
    for at in range(0, len(live), max_tensors):
        idx = live[at:at + max_tensors]
        size = chunk or tree_chunk(sum(numels[i] for i in idx), sm_count)
        chunk0 = [0]
        for i in idx:
            chunk0.append(chunk0[-1] + -(-numels[i] // size))
        groups.append((idx, chunk0, size))
    return groups


def sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def pow_mode(lr_power):
    """How torch's ``x ** -lr_power`` runs on the card (Ftrl): 1 sqrt, 2
    rsqrt, 3 reciprocal, 4 square, 0 ``powf``."""
    return _POW_MODES.get(float(-lr_power), 0)


def _check(kind, params, grads, slots):
    if kind not in KINDS + NORM_KINDS:
        raise ValueError(f"multi_tensor_step: no rule {kind!r}")
    p0 = params[0]
    if p0.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"multi_tensor_step: no kernel for {p0.dtype} "
                        "parameters (float32, bfloat16 and float16 only)")
    s_dtype = slot_dtype(kind, p0.dtype)
    for p, g, s in zip(params, grads, slots):
        if p.dtype != p0.dtype or p.device != p0.device \
                or not p.is_contiguous():
            raise ValueError("multi_tensor_step: parameters must be "
                             f"contiguous {p0.dtype} tensors on {p0.device}")
        if g.shape != p.shape or g.dtype != p.dtype \
                or g.device != p.device or not g.is_contiguous():
            raise ValueError("multi_tensor_step: a gradient must be a "
                             f"contiguous {tuple(p.shape)} {p.dtype} "
                             f"tensor on {p.device}")
        if len(s) != SLOTS[kind] or any(
                v.shape != p.shape or v.dtype != s_dtype
                or v.device != p.device or not v.is_contiguous()
                for v in s):
            raise ValueError(f"multi_tensor_step: {kind} takes "
                             f"{SLOTS[kind]} contiguous {s_dtype} slots "
                             f"of shape {tuple(p.shape)} on {p.device}")


def _check_disjoint(params):
    """Refuse parameters that share memory (one listed twice, or views of
    one buffer that overlap): one launch would update them from racing
    blocks."""
    spans = sorted((str(p.device), p.data_ptr(),
                    p.data_ptr() + p.numel() * p.element_size())
                   for p in params if p.numel())
    for (dev0, _, end0), (dev1, start1, _) in zip(spans, spans[1:]):
        if dev0 == dev1 and start1 < end0:
            raise ValueError("multi_tensor_step: parameters share memory "
                             "(one listed twice?); list each once")


def _on_cuda(kind, params, grads, slots, scalars):
    """Validate a call; True when it launches (CUDA tensors), False when
    it takes the plain version (CPU tensors)."""
    if not (len(params) == len(grads) == len(slots)):
        raise ValueError("multi_tensor_step: params, grads and slots "
                         "differ in length")
    devices = {p.device.type for p in params}
    if devices - {"cpu", "cuda"} or len(devices) > 1:
        raise RuntimeError("multi_tensor_step: no kernel for device "
                           f"{sorted(devices)}")
    _check_disjoint(params)
    if devices == {"cpu"}:
        return False
    _check(kind, params, grads, slots)
    if scalars is None or scalars.shape != (N_SCALARS,) \
            or scalars.dtype != torch.float32 \
            or scalars.device != params[0].device:
        raise ValueError("multi_tensor_step: scalars must be a float32 "
                         f"[{N_SCALARS}] tensor on {params[0].device}")
    return True


def _tables(params, grads, slots, nslots, idx):
    """The launch's pointer arrays (p, g, three slots), counts."""
    n = len(idx)
    ptrs = [(ctypes.c_void_p * n)() for _ in range(5)]
    for j, i in enumerate(idx):
        ptrs[0][j] = params[i].data_ptr()
        ptrs[1][j] = grads[i].data_ptr()
        for k in range(nslots):
            ptrs[2 + k][j] = slots[i][k].data_ptr()
    counts = (ctypes.c_longlong * n)(*(params[i].numel() for i in idx))
    return ptrs, counts


def multi_tensor_step(kind, params, grads, slots, lr, t, hyper,
                      scalars=None):
    """One ``kind`` update (:data:`KINDS`) of every tensor in ``params``
    (one dtype, one device), in place: ``grads`` in the parameters'
    dtype, ``slots`` a list per tensor (see :func:`update_plain`), ``lr``
    a float, ``t`` the step (the plain version's); ``hyper``'s ``decay``
    (:data:`DECAYS`) and ``decay_coeff`` the coupled decay.  On CUDA the
    kernel reads its scalars from ``scalars``, a float32 [16] tensor on
    the parameters' device that :func:`write_scalars` filled before it
    runs (``lr`` and ``t`` are not read there).  One launch per
    :data:`MAX_TENSORS` tensors.  Returns the parameters as a tuple."""
    if not params:
        return ()
    if kind not in KINDS:
        raise ValueError(f"multi_tensor_step: no rule {kind!r} (the norm "
                         "rules take multi_tensor_norm_step)")
    if not _on_cuda(kind, params, grads, slots, scalars):
        return multi_tensor_step_plain(kind, params, grads, slots, lr, t,
                                       hyper)
    fn = build.bind("multi_tensor_optim", "ptt_multi_tensor_step",
                    _ARGTYPES)
    code = KINDS.index(kind)
    decay = DECAYS.index(hyper.get("decay", "none"))
    pmode = pow_mode(hyper["lr_power"]) if kind == "ftrl" else 0
    dtype = build.dtype_code(params[0])
    stream = build.stream_of(params[0])
    sms = sm_count(params[0].device)
    for idx, chunk0, chunk in chunk_groups([p.numel() for p in params],
                                           sm_count=sms):
        ptrs, counts = _tables(params, grads, slots, SLOTS[kind], idx)
        err = fn(code, dtype, len(idx), *ptrs, counts,
                 (ctypes.c_int * (len(idx) + 1))(*chunk0), chunk, decay,
                 pmode, scalars.data_ptr(), stream)
        build.check(err, "multi_tensor_step")
        multi_tensor_step.launches += 1
    return tuple(params)


multi_tensor_step.launches = 0


def multi_tensor_norm_step(kind, params, grads, slots, lr, t, hyper,
                           scalars=None, seed=0, base=0):
    """One ``kind`` update (:data:`NORM_KINDS`: Lamb, LarsMomentum, Dpsgd)
    of every tensor in ``params``, in place, as :func:`multi_tensor_step`
    takes its arguments; ``seed`` keys Dpsgd's noise (the i-th non-empty
    tensor draws :func:`dpsgd_noise_plain` of (seed, base + i), ``base``
    the step's non-empty tensors in earlier calls).  On CUDA two launches
    per :data:`MAX_TENSORS` tensors, each counted: the partial sums of
    squares of every chunk into a float32 scratch of the caller's stream,
    then the update.  Returns the parameters as a tuple."""
    if not params:
        return ()
    if kind not in NORM_KINDS:
        raise ValueError(f"multi_tensor_norm_step: no rule {kind!r}")
    if not _on_cuda(kind, params, grads, slots, scalars):
        return multi_tensor_step_plain(kind, params, grads, slots, lr, t,
                                       hyper, seed, base)
    fn = build.bind("multi_tensor_optim", "ptt_multi_tensor_norm_step",
                    _NORM_ARGTYPES)
    code = NORM_KINDS.index(kind)
    dtype = build.dtype_code(params[0])
    stream = build.stream_of(params[0])
    for idx, chunk0, _ in chunk_groups([p.numel() for p in params], CHUNK):
        ptrs, counts = _tables(params, grads, slots, SLOTS[kind], idx)
        partials = torch.empty((chunk0[-1], 2), dtype=torch.float32,
                               device=params[0].device)
        err = fn(code, dtype, len(idx), base, *ptrs[:4], counts,
                 (ctypes.c_int * (len(idx) + 1))(*chunk0), CHUNK,
                 partials.data_ptr(), seed & (2 ** 64 - 1),
                 scalars.data_ptr(), stream)
        build.check(err, "multi_tensor_norm_step")
        multi_tensor_norm_step.launches += 2
        base += len(idx)
    return tuple(params)


multi_tensor_norm_step.launches = 0
