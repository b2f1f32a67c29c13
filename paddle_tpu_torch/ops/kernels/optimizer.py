"""The whole-tree optimizer update: one CUDA launch a step for every
parameter of a (device, dtype) group, its plain version, its launch
count and the table builder.

Replaces what ``Optimizer.apply_pytree`` (paddle_tpu/optimizer/__init__.py
:155) gives the reference: one update over the whole parameter tree, which
XLA fuses into the jitted, donated train step
(paddle_tpu/hapi/engine.py:517).  It is no ``pallas_call``.  The rules are
those of the port's ``SGD``, ``Momentum`` (plain and Nesterov), ``Adam``
and ``AdamW``; :func:`update_plain` is their arithmetic, in eager ops in
the reference's order, and the optimizers' ``_update`` call it.

The kernel (csrc/multi_tensor_optim.cu) is bound by bytes (bf16 AdamW: 22
bytes an element), for float32, bfloat16 and float16 parameters (float16:
AMP-O2 after ``amp.decorate``; Adam-family moments stay float32).  The host builds a table of per-tensor pointers and
counts and passes it as the launch's parameter: no host sync.  The nine
scalars (:func:`hyper_floats`) are a float32 [9] device tensor that the
kernel reads when it runs, written from the host by :func:`write_scalars`
without a sync: the training engine's host prologue writes the step's
before each replay of its captured step, whose launch holds the tensor's
address, not the values.  Blocks take fixed-size chunks of elements
(:func:`chunk_groups`), so one large embedding and many small biases
balance.  Its result is bitwise the eager loop's on the card: it copies
each eager op's float32 (or bf16) rounding, and gets each scalar as the
float32 value the eager op uses (:func:`hyper_floats`).

Slots are updated IN PLACE (the loop replaced them with new tensors): the
reference's state arrays are immutable, so ``Optimizer.state_dict()``
hands out copies.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...framework.place import copy_to_device
from . import build

KINDS = ("sgd", "momentum", "nesterov", "adam", "adamw")
SLOTS = {"sgd": 0, "momentum": 1, "nesterov": 1, "adam": 2, "adamw": 2}
CHUNK = 1 << 16          # elements a block
MAX_TENSORS = 512        # tensors a launch: kMaxTensors of the source
_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_int) \
    + (ctypes.c_void_p,) * 4 + (ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p)
N_SCALARS = 9            # the kernel's Hyper


def bias_correction(beta, t):
    """1 - beta ** t in float32, the step as a float32 (the reference
    computes it on device from ``jnp.asarray(t, jnp.float32)``)."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(t))


def update_plain(kind, p, g, slots, lr, t, hyper):
    """One rule on one tensor in eager ops, in the reference's order:
    returns (new_p, new_slots) without touching p or the slots.  ``slots``:
    Momentum's [velocity] (p's dtype), Adam's [moment1, moment2] (float32);
    ``hyper``: ``momentum`` or ``beta1``/``beta2``/``epsilon`` and AdamW's
    decoupled ``weight_decay``."""
    if kind == "sgd":
        return p - lr * g, []
    if kind in ("momentum", "nesterov"):
        mu = hyper["momentum"]
        v = mu * slots[0] + g
        if kind == "nesterov":
            return p - lr * (g + mu * v), [v]
        return p - lr * v, [v]
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


@torch.no_grad()
def multi_tensor_step_plain(kind, params, grads, slots, lr, t, hyper):
    """:func:`update_plain` on each tensor, written back in place."""
    for p, g, s in zip(params, grads, slots):
        new_p, new_s = update_plain(kind, p, g, s, lr, t, hyper)
        p.copy_(new_p)
        for old, new in zip(s, new_s):
            old.copy_(new)
    return tuple(params)


def hyper_floats(kind, lr, t, hyper):
    """The kernel's nine scalars, each the float32 value its eager op uses:
    lr, beta1 (or the momentum), 1 - beta1, beta2, 1 - beta2, the two
    bias corrections' reciprocals as the eager CUDA division by a host
    scalar forms them (``1.0f / float(bc)``), eps and lr * weight decay
    (each Python expression formed in double first, then cast)."""
    f = np.float32
    if kind in ("adam", "adamw"):
        b1, b2 = hyper["beta1"], hyper["beta2"]
        vals = (lr, b1, 1 - b1, b2, 1 - b2,
                f(1.0) / f(bias_correction(b1, t)),
                f(1.0) / f(bias_correction(b2, t)), hyper["epsilon"],
                lr * hyper.get("weight_decay", 0.0))
    else:
        vals = (lr, hyper.get("momentum", 0.0)) + (0.0,) * 7
    return tuple(float(f(v)) for v in vals)


def write_scalars(scalars, kind, lr, t, hyper):
    """Write :func:`hyper_floats` of (``kind``, ``lr``, step ``t``) into
    ``scalars`` (a float32 [9] tensor), on the current stream and without
    a host sync; the kernels that read them later in the stream see
    them."""
    copy_to_device(scalars, hyper_floats(kind, lr, t, hyper))
    return scalars


def make_scalars(device):
    """An (unwritten) float32 [9] tensor of kernel scalars on
    ``device``."""
    return torch.empty(N_SCALARS, dtype=torch.float32, device=device)


def chunk_groups(numels, chunk=CHUNK, max_tensors=MAX_TENSORS):
    """Split tensors of ``numels`` elements into launches: a list of
    (indices, chunk0), one per launch, of at most ``max_tensors`` tensors
    each, empty tensors left out; ``chunk0[i]`` is the first chunk of the
    i-th tensor of the launch and ``chunk0[-1]`` the launch's block count.
    Block b of a launch updates elements [c * chunk, min((c + 1) * chunk,
    n)) of the last tensor i with chunk0[i] <= b, c = b - chunk0[i]."""
    live = [i for i, n in enumerate(numels) if n > 0]
    groups = []
    for at in range(0, len(live), max_tensors):
        idx = live[at:at + max_tensors]
        chunk0 = [0]
        for i in idx:
            chunk0.append(chunk0[-1] + -(-numels[i] // chunk))
        groups.append((idx, chunk0))
    return groups


def _check(kind, params, grads, slots):
    if kind not in KINDS:
        raise ValueError(f"multi_tensor_step: no rule {kind!r}")
    p0 = params[0]
    if p0.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"multi_tensor_step: no kernel for {p0.dtype} "
                        "parameters (float32, bfloat16 and float16 only)")
    slot_dtype = torch.float32 if SLOTS[kind] == 2 else p0.dtype
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
                v.shape != p.shape or v.dtype != slot_dtype
                or v.device != p.device or not v.is_contiguous()
                for v in s):
            raise ValueError(f"multi_tensor_step: {kind} takes "
                             f"{SLOTS[kind]} contiguous {slot_dtype} slots "
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


def multi_tensor_step(kind, params, grads, slots, lr, t, hyper,
                      scalars=None):
    """One ``kind`` update of every tensor in ``params`` (one dtype, one
    device), in place: ``grads`` in the parameters' dtype, ``slots`` a
    list per tensor (see :func:`update_plain`), ``lr`` a float, ``t`` the
    step (the plain version's).  On CUDA the kernel reads its scalars
    from ``scalars``, a float32 [9] tensor on the parameters' device
    that :func:`write_scalars` filled before it runs (``lr`` and ``t``
    are not read there).  One launch per :data:`MAX_TENSORS` tensors.
    Returns the parameters as a tuple."""
    if not (len(params) == len(grads) == len(slots)):
        raise ValueError("multi_tensor_step: params, grads and slots "
                         "differ in length")
    if not params:
        return ()
    devices = {p.device.type for p in params}
    if devices - {"cpu", "cuda"} or len(devices) > 1:
        raise RuntimeError("multi_tensor_step: no kernel for device "
                           f"{sorted(devices)}")
    _check_disjoint(params)
    if devices == {"cpu"}:
        return multi_tensor_step_plain(kind, params, grads, slots, lr, t,
                                       hyper)
    _check(kind, params, grads, slots)
    if scalars is None or scalars.shape != (N_SCALARS,) \
            or scalars.dtype != torch.float32 \
            or scalars.device != params[0].device:
        raise ValueError("multi_tensor_step: scalars must be a float32 "
                         f"[{N_SCALARS}] tensor on {params[0].device}")
    fn = build.bind("multi_tensor_optim", "ptt_multi_tensor_step",
                    _ARGTYPES)
    code = KINDS.index(kind)
    dtype = build.dtype_code(params[0])
    stream = build.stream_of(params[0])
    nslots = SLOTS[kind]
    for idx, chunk0 in chunk_groups([p.numel() for p in params]):
        n = len(idx)
        ptrs = [(ctypes.c_void_p * n)() for _ in range(4)]
        for j, i in enumerate(idx):
            ptrs[0][j] = params[i].data_ptr()
            ptrs[1][j] = grads[i].data_ptr()
            for k in range(nslots):
                ptrs[2 + k][j] = slots[i][k].data_ptr()
        err = fn(code, dtype, n, *ptrs,
                 (ctypes.c_longlong * n)(*(params[i].numel() for i in idx)),
                 (ctypes.c_int * (n + 1))(*chunk0), CHUNK,
                 scalars.data_ptr(), stream)
        build.check(err, "multi_tensor_step")
        multi_tensor_step.launches += 1
    return tuple(params)


multi_tensor_step.launches = 0
