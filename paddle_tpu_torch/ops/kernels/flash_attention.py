"""Flash attention, forward and backward, causal or not, with an optional
additive mask, over S_q queries and S_k keys: CUDA kernels, plain
versions, launch counts and the autograd Functions that join them.

Replaces paddle_tpu/ops/pallas/flash_attention.py ``_fwd_kernel`` (via
``_fwd_call``), ``_dq_kernel`` and ``_dkv_kernel`` (via ``_bwd_call``) in
all their forms (causal or not, ``has_bias`` or not), with ``_mha`` and
``_mha_masked`` and their custom_vjps as the autograd Function, and
``flash_attention`` (:412, here :func:`attention`) and ``_fold_mask`` as
the public entry.  At prefill and training shapes the bound is
operations (4*D flops per visible (query, key) pair forward, 6*D in dq,
8*D in dk/dv) against one read of q, k, v (and dO).

- Forward (csrc/flash_attention.cu): one block per (batch*head, query
  tile), float32 online softmax over key tiles staged in shared memory,
  stopping at the diagonal when causal; writes O and LSE [B*H, S_q]
  float32.
- Backward (csrc/flash_attention_bwd.cu): two kernels with no atomics, so
  the gradients are the same from run to run.  dq: one block per
  (batch*head, query tile), walking key tiles.  dk/dv: one block per
  (batch*head, key tile), walking query tiles.  Both recompute
  p = exp(s - lse) in float32.  delta = rowsum(dO * O) is computed here
  in PyTorch (:func:`flash_attention_delta`), as the reference computes
  it in XLA.
- The forward, dq and dk/dv each have two hand-written kernels: bf16
  operands whose base pointers and (b, s, h) strides are 16-byte
  multiples (the fused qkv's slices, separate projections: every path of
  the models) run on the tensor cores (``mma.sync`` with float32
  accumulators, P and dS rounded to bf16 before the second product, as
  the reference rounds them); float32, and bf16 that is not so aligned,
  run on the CUDA cores.
  The C entry decides from dtype and alignment alone;
  :func:`variant_launches` reports which kernel the launches took.
- Scores follow the reference's ``_scores``: scale, add the bias, then
  the causal replace, top-left aligned as the reference's
  ``_causal_mask``: query i sees key j iff j <= i, whatever S_q and S_k.
  The bias is float32 [B, H, S_q, S_k], usually an ``expand``ed view: the
  kernels read it through its four strides, so a [B, 1, 1, S_k] padding
  mask costs S_k floats per batch row, not the reference's folded
  [B*H, S_q, S_k].  A bool mask becomes 0 / -1e30 (:func:`fold_mask`).
  The mask is data: its gradient is zero.
- Dropout on the softmax weights (the reference's composite,
  paddle_tpu/ops/fused.py: ``keep = bernoulli(1 - p)``, then
  ``where(keep, w / (1 - p), 0)`` before ``w . V``) runs inside all three
  kernels: the keep mask is a pure function of (seed, b*H + h, q, k, p),
  whatever S_q and S_k
  (csrc/dropout.cuh, Philox4x32-10; :func:`dropout_keep_plain` here), so
  dq and dk/dv draw the forward's mask again instead of storing it.  The
  LSE is of the weights before dropout; dv takes the dropped, rescaled
  weights, and dP = dO V^T is masked and rescaled the same way before
  dS.  Each call draws its seed from the framework generator
  (framework/random.py ``dropout_seed``); the autograd Functions keep the
  seed, not a mask.  A seed is an int (Philox key; counter word 3 is 0)
  or, inside the training engine's step, a ``StepSeed``: a key fixed for
  the engine and a device int32 counter that the kernels read as word 3
  when they run, so the step captured as a CUDA graph draws new masks at
  every replay (csrc/dropout.cuh).

Every kernel reads the paddle layout through strides (q, O, dO and dq
[B, S_q, H, D]; k, v, dk and dv [B, S_k, H, D]), so the fused qkv
projection's slices need no transpose or copy, and the backward can write
dq, dk, dv straight into one packed [B, S, 3, H, D] gradient
(:func:`causal_attention_packed`).  Self-attention (S_q == S_k) and the
cross form (S_q != S_k: the encoder-decoder's cross-attention, S_q = 64
against S_k = 72 in Transformer-base training, and a cached decode step,
S_q = 1 against the cache) take the same kernels.  Any S_q, S_k >= 1;
head dim 16, 32, 64 or 128; k and v have q's batch and heads (grouped
heads are not ported).

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
or raises.  The Functions build a graph only when grad mode is on and an
input requires grad; serving under ``torch.no_grad()`` calls the forward
kernel directly.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...framework import random as _random
from ...utils import flops
from . import build

HEAD_DIMS = (16, 32, 64, 128)
NEG_INF = -1e30       # what a False entry of a bool mask adds (reference)
_BIAS_ARGTYPES = (ctypes.c_void_p,) + (ctypes.c_longlong,) * 4
# B, S_q, S_k, H, D, sm_scale, causal, dropout key, step word's pointer
# and p, dtype, stream
_TAIL_ARGTYPES = (ctypes.c_int,) * 5 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_void_p,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) * 9 \
    + (ctypes.c_void_p,) * 2 + _BIAS_ARGTYPES + _TAIL_ARGTYPES
_DQ_ARGTYPES = (ctypes.c_void_p,) * 8 + _BIAS_ARGTYPES + _TAIL_ARGTYPES
_DKV_ARGTYPES = (ctypes.c_void_p,) * 9 + _BIAS_ARGTYPES + _TAIL_ARGTYPES


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None \
        else float(sm_scale)


# Philox4x32-10 (Salmon et al., SC'11), as csrc/dropout.cuh computes it
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(m, x):
    """(high, low) 32-bit words of the product of the constant ``m`` and
    ``x`` (an int64 tensor of 32-bit values).  int64 cannot hold
    0xD2511F53 * 0xFFFFFFFF, so x is split into 16-bit halves: no partial
    product passes 2^49."""
    a = m * (x & 0xFFFF)
    t = m * (x >> 16) + (a >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (a & 0xFFFF)


def philox4x32_10(counter, key):
    """The four output words of Philox4x32-10 for ``counter`` (four int64
    tensors of 32-bit values, broadcastable) and ``key`` (two ints)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for i in range(10):
        if i:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _check_dropout(dropout_p):
    if not 0.0 <= dropout_p <= 1.0:
        raise ValueError(f"flash_attention: dropout_p {dropout_p} is not in "
                         "[0, 1]")


def _seed_args(name, seed, device):
    """(64-bit key, pointer to the counter's fourth word or None) of a
    seed as the C entries take it: an int, or a ``StepSeed`` whose counter
    is an int32 [1] tensor on ``device``."""
    if isinstance(seed, _random.StepSeed):
        c = seed.counter
        if c.shape != (1,) or c.dtype != torch.int32 or c.device != device:
            raise ValueError(f"{name}: a StepSeed's counter must be an int32 "
                             f"[1] tensor on {device}, got {tuple(c.shape)} "
                             f"{c.dtype} on {c.device}")
        return seed.key, c.data_ptr()
    return int(seed), None


def _key_and_step(seed):
    """(key, counter word 3) of a seed, for the plain versions (reading a
    CUDA counter is a host sync: the plain versions are references)."""
    if isinstance(seed, _random.StepSeed):
        return seed.key, int(seed.counter.reshape(())) & _U32
    return int(seed), 0


def dropout_threshold(p):
    """round(p * 2^16) of p as the kernels receive it (float32): a 16-bit
    draw below it drops its (query, key) pair."""
    p32 = torch.tensor(float(p), dtype=torch.float32).item()
    return math.floor(p32 * 65536.0 + 0.5)


def dropout_scale(p):
    """1 / (1 - p) in float32, as the kernels compute it."""
    p32 = torch.tensor(float(p), dtype=torch.float32)
    return (1.0 / (1.0 - p32)).item()


def dropout_keep_plain(seed, B, H, S, p, device="cpu", S_k=None):
    """The kernels' keep mask (csrc/dropout.cuh) as a bool [B, H, S, S_k]
    tensor (True = kept) over S queries and ``S_k`` keys (``S`` when None),
    in int64 arithmetic.  Philox4x32-10 keyed by the 64-bit key of
    ``seed``, counter (k // 8, q, b*H + h, step), step 0 for an int seed
    and a ``StepSeed``'s counter value: its four words hold the eight
    16-bit draws of keys 8 * (k // 8) + e, draw e the low (e even) or high
    half of word e // 2; a pair is kept when its draw is at least
    :func:`dropout_threshold`.  No word depends on S or S_k, so a mask is
    the top-left corner of any larger one."""
    seed, step = _key_and_step(seed)
    S_k = S if S_k is None else S_k
    planes, groups = B * H, -(-S_k // 8)

    def ax(n, dim):
        shape = [1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)

    c0, c1, c2 = ax(groups, 2), ax(S, 1), ax(planes, 0)
    words = philox4x32_10(
        (c0, c1, c2, torch.full((), step, dtype=torch.int64, device=device)),
        (seed & _U32, (seed >> 32) & _U32))
    w = torch.stack(torch.broadcast_tensors(*words), -1)  # [P, S, G, 4]
    draws = torch.stack((w & 0xFFFF, w >> 16), -1).reshape(
        planes, S, 8 * groups)[..., :S_k]
    return (draws >= dropout_threshold(p)).reshape(B, H, S, S_k)


def _dropped(w, keep, p):
    """The weights after dropout: w / (1 - p) where kept, else 0."""
    return torch.where(keep, w * dropout_scale(p), 0.0)


def _scores_plain(q, k, causal, bias, sm_scale):
    """The reference's ``_scores`` in float32 [B, H, S_q, S_k]: scale, add
    the bias, then the causal replace, top-left aligned (query i sees key
    j <= i), by -inf, which gives the kernels' 0."""
    S_q, S_k = q.shape[1], k.shape[1]
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        * _scale(q, sm_scale)
    if bias is not None:
        s = s + bias
    if causal:
        visible = torch.ones(S_q, S_k, dtype=torch.bool,
                             device=q.device).tril()
        s = s.masked_fill(~visible, float("-inf"))
    return s


def flash_attention_plain(q, k, v, causal=True, bias=None, sm_scale=None,
                          dropout_p=0.0, seed=0):
    """Softmax attention of q [B, S_q, H, D] over k, v [B, S_k, H, D] in
    float32.  Returns (out [B, S_q, H, D] in q's dtype, lse [B*H, S_q]
    float32).  The softmax is normalised by its sum, as the kernels' is,
    not by exp(lse): for a row masked everywhere by -1e30,
    lse = -1e30 + log(S_k) rounds to -1e30 and exp(s - lse) would sum V
    instead of averaging it.  A row with no
    visible key at all (an all -inf bias) gives 0 (the reference's
    ``l_safe``).  ``dropout_p`` > 0: the weights take the mask of
    (``seed``, ``dropout_p``) before V; the LSE is of the weights before
    dropout."""
    B, S_q, H, D = q.shape
    s = _scores_plain(q, k, causal, bias, sm_scale)
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == float("-inf"), 0.0, m)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    l = torch.where(l == 0, 1.0, l)
    w = e / l
    if dropout_p > 0:
        w = _dropped(w, dropout_keep_plain(seed, B, H, S_q, dropout_p,
                                           q.device, S_k=k.shape[1]),
                     dropout_p)
    out = torch.einsum("bhst,bthd->bshd", w, v.float())
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse.reshape(B * H, S_q)


def flash_attention_delta(o, do):
    """delta = rowsum(dO * O) in float32, as [B*H, S_q] (the reference's
    ``_bwd_call`` computes it in XLA before the two kernels)."""
    B, S, H, _ = o.shape
    delta = (do.float() * o.float()).sum(-1)          # [B, S, H]
    return delta.permute(0, 2, 1).reshape(B * H, S).contiguous()


def _bwd_plain_terms(q, k, v, do, lse, delta, causal, bias, sm_scale,
                     dropout_p, seed):
    """The weights dv takes and ds = p * (dP - delta) * scale, float32
    [B, H, S_q, S_k], from the forward's lse and the caller's delta:
    p = exp(s - lse) and dP = dO.V^T, or with dropout the weights
    p * z / (1 - p) and dP * z / (1 - p), z the forward's keep mask."""
    B, S_q, H, D = q.shape
    s = _scores_plain(q, k, causal, bias, sm_scale)
    p = torch.exp(s - lse.reshape(B, H, S_q, 1))
    dp = torch.einsum("bshd,bthd->bhst", do.float(), v.float())
    pd = p
    if dropout_p > 0:
        keep = dropout_keep_plain(seed, B, H, S_q, dropout_p, q.device,
                                  S_k=k.shape[1])
        pd, dp = _dropped(p, keep, dropout_p), _dropped(dp, keep, dropout_p)
    ds = p * (dp - delta.reshape(B, H, S_q, 1)) * _scale(q, sm_scale)
    return pd, ds


def flash_attention_dq_plain(q, k, v, do, lse, delta, causal=True,
                             bias=None, sm_scale=None, dropout_p=0.0,
                             seed=0):
    """dq = ds . k, [B, S_q, H, D] in q's dtype."""
    _, ds = _bwd_plain_terms(q, k, v, do, lse, delta, causal, bias,
                             sm_scale, dropout_p, seed)
    return torch.einsum("bhst,bthd->bshd", ds, k.float()).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, causal=True,
                              bias=None, sm_scale=None, dropout_p=0.0,
                              seed=0):
    """(dk = ds^T . q, dv = p^T . dO), [B, S_k, H, D] in k's dtype (p
    after dropout)."""
    p, ds = _bwd_plain_terms(q, k, v, do, lse, delta, causal, bias,
                             sm_scale, dropout_p, seed)
    dk = torch.einsum("bhst,bshd->bthd", ds, q.float())
    dv = torch.einsum("bhst,bshd->bthd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True, bias=None,
                              sm_scale=None, dropout_p=0.0, seed=0):
    """(dq, dk, dv) from the forward's O and LSE."""
    delta = flash_attention_delta(o, do)
    form = dict(causal=causal, bias=bias, sm_scale=sm_scale,
                dropout_p=dropout_p, seed=seed)
    dq = flash_attention_dq_plain(q, k, v, do, lse, delta, **form)
    return (dq, *flash_attention_dkv_plain(q, k, v, do, lse, delta, **form))


def _check(name, q, k, queries=(), keys=()):
    """q [B, S_q, H, D] and the tensors of its shape (``queries``: dO,
    O, dq), k [B, S_k, H, D] and the tensors of its shape (``keys``: v,
    dk, dv): one dtype and device, unit stride over D."""
    B, S_q, H, D = q.shape
    if k.dim() != 4 or (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(f"{name}: k {tuple(k.shape)} must be [{B}, S_k, "
                         f"{H}, {D}] for q {tuple(q.shape)}")
    for ref, group in ((q, queries), (k, (k, *keys))):
        for t in group:
            if t.shape != ref.shape or t.dtype != q.dtype \
                    or t.device != q.device:
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                                 f"{t.device} does not match "
                                 f"{tuple(ref.shape)} {q.dtype} on "
                                 f"{q.device}")
    for t in (q, *queries, k, *keys):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: every [B, S, H, D] operand needs unit "
                             "stride over the head dim")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"{name}: batch*heads {B * H} > 65535")


def _check_stats(name, q, *stats):
    B, S_q, H, _ = q.shape
    for t in stats:
        if t.shape != (B * H, S_q) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: lse and delta must be contiguous "
                             f"float32 [{B * H}, {S_q}] tensors on "
                             f"{q.device}")


def _bias_args(name, q, k, bias):
    """(pointer, b, h, q, k strides) of a float32 [B, H, S_q, S_k] bias,
    any strides; NULL and zeros without one."""
    if bias is None:
        return (None, 0, 0, 0, 0)
    B, S_q, H, _ = q.shape
    S_k = k.shape[1]
    if bias.shape != (B, H, S_q, S_k) or bias.dtype != torch.float32 \
            or bias.device != q.device:
        raise ValueError(f"{name}: bias must be a float32 [{B}, {H}, {S_q}, "
                         f"{S_k}] tensor (any strides) on {q.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    return (bias.data_ptr(), *bias.stride())


def _device(name, q):
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    return q.device.type


def _count(fn, q, k, dropout_p):
    """One launch of the kernel behind wrapper ``fn``: its count, its
    count with dropout and its count of the cross form (S_q != S_k)."""
    fn.launches += 1
    fn.dropout_launches += dropout_p > 0
    fn.cross_launches += q.shape[1] != k.shape[1]


def flash_attention_flops(q, k, v, causal=True, bias=None, *_, **__):
    """The plain version's flops over P = B*H*S_q*S_k scores: the two
    products (2 P D each), the scaling, the bias and the causal fill (P
    each, when present), the softmax's max, subtraction, sum and divide
    (P each), and 5 a row for the row guards and the LSE."""
    B, S_q, H, D = q.shape
    rows = B * H * S_q
    P = rows * k.shape[1]
    return 4 * P * D + (5 + (bias is not None) + bool(causal)) * P \
        + 5 * rows


@flops.counted(flash_attention_flops)
def flash_attention(q, k, v, causal=True, bias=None, sm_scale=None,
                    dropout_p=0.0, seed=0):
    """The forward kernel: attention of q [B, S_q, H, D] over k, v
    [B, S_k, H, D] (paddle layout, any strides with a unit stride over D),
    causal (the GPT path's form, the default; top-left aligned) or not,
    plus an optional float32 [B, H, S_q, S_k] bias, and dropout
    ``dropout_p`` on the weights with the mask of ``seed`` (an int or a
    ``StepSeed``).  Returns (out [B, S_q, H, D] contiguous, lse
    [B*H, S_q] float32).  No graph: see :func:`attention`."""
    _check_dropout(dropout_p)
    if _device("flash_attention", q) == "cpu":
        return flash_attention_plain(q, k, v, causal, bias, sm_scale,
                                     dropout_p, seed)
    B, S_q, H, D = q.shape
    S_k = k.shape[1]
    _check("flash_attention", q, k, keys=(v,))
    bias_args = _bias_args("flash_attention", q, k, bias)
    key, step = _seed_args("flash_attention", seed, q.device)
    out = torch.empty((B, S_q, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S_q), dtype=torch.float32, device=q.device)
    fn = build.bind("flash_attention", "ptt_flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             out.data_ptr(), lse.data_ptr(), *bias_args, B, S_q, S_k, H, D,
             _scale(q, sm_scale), int(causal), key, step, dropout_p,
             build.dtype_code(q), build.stream_of(q))
    build.check(err, "flash_attention")
    _count(flash_attention, q, k, dropout_p)
    return out, lse


def flash_attention_dq(q, k, v, do, lse, delta, out=None, causal=True,
                       bias=None, sm_scale=None, dropout_p=0.0, seed=0):
    """dq, written into ``out`` (a [B, S_q, H, D] view with unit stride
    over D, allocated when None).  Returns it.  ``dropout_p`` and
    ``seed``: the forward's."""
    _check_dropout(dropout_p)
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if _device("flash_attention_dq", q) == "cpu":
        return out.copy_(flash_attention_dq_plain(
            q, k, v, do, lse, delta, causal, bias, sm_scale, dropout_p,
            seed))
    B, S_q, H, D = q.shape
    _check("flash_attention_dq", q, k, queries=(do, out), keys=(v,))
    _check_stats("flash_attention_dq", q, lse, delta)
    bias_args = _bias_args("flash_attention_dq", q, k, bias)
    key, step = _seed_args("flash_attention_dq", seed, q.device)
    fn = build.bind("flash_attention_bwd", "ptt_flash_attention_dq",
                    _DQ_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), out.data_ptr(),
             build.strides(q, k, v, do, out), *bias_args, B, S_q,
             k.shape[1], H, D, _scale(q, sm_scale), int(causal), key, step,
             dropout_p, build.dtype_code(q), build.stream_of(q))
    build.check(err, "flash_attention_dq")
    _count(flash_attention_dq, q, k, dropout_p)
    return out


def flash_attention_dkv(q, k, v, do, lse, delta, out=None, causal=True,
                        bias=None, sm_scale=None, dropout_p=0.0, seed=0):
    """(dk, dv), written into ``out`` (two [B, S_k, H, D] views with unit
    stride over D, allocated when None).  ``dropout_p`` and ``seed``: the
    forward's."""
    _check_dropout(dropout_p)
    if out is None:
        out = tuple(torch.empty(k.shape, dtype=k.dtype, device=k.device)
                    for _ in range(2))
    dk, dv = out
    if _device("flash_attention_dkv", q) == "cpu":
        pk, pv = flash_attention_dkv_plain(q, k, v, do, lse, delta, causal,
                                           bias, sm_scale, dropout_p, seed)
        return dk.copy_(pk), dv.copy_(pv)
    B, S_q, H, D = q.shape
    _check("flash_attention_dkv", q, k, queries=(do,), keys=(v, dk, dv))
    _check_stats("flash_attention_dkv", q, lse, delta)
    bias_args = _bias_args("flash_attention_dkv", q, k, bias)
    key, step = _seed_args("flash_attention_dkv", seed, q.device)
    fn = build.bind("flash_attention_bwd", "ptt_flash_attention_dkv",
                    _DKV_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             build.strides(q, k, v, do, dk, dv), *bias_args, B, S_q,
             k.shape[1], H, D, _scale(q, sm_scale), int(causal), key, step,
             dropout_p, build.dtype_code(q), build.stream_of(q))
    build.check(err, "flash_attention_dkv")
    _count(flash_attention_dkv, q, k, dropout_p)
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, out=None, causal=True,
                        bias=None, sm_scale=None, dropout_p=0.0, seed=0):
    """(dq, dk, dv) from the forward's O and LSE, by the dq kernel and the
    dk/dv kernel.  ``out``: three views to write into (dq of q's shape, dk
    and dv of k's); by default the slices of one packed [B, S, 3, H, D]
    tensor, which needs S_q == S_k."""
    if out is None:
        if q.shape != k.shape:
            raise ValueError("flash_attention_bwd: S_q != S_k needs out=")
        B, S, H, D = q.shape
        out = torch.empty((B, S, 3, H, D), dtype=q.dtype,
                          device=q.device).unbind(2)
    do = do.contiguous()
    delta = flash_attention_delta(o, do)
    form = dict(causal=causal, bias=bias, sm_scale=sm_scale,
                dropout_p=dropout_p, seed=seed)
    dq = flash_attention_dq(q, k, v, do, lse, delta, out=out[0], **form)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, out=out[1:],
                                 **form)
    return dq, dk, dv


def dropout_keep(seed, B, H, S, p, device, S_k=None):
    """The keep mask as the kernels draw it, bool [B, H, S, S_k] (``S_k``
    None: S): on a CUDA device written by the kernels' own device function
    (a test entry: no path calls it, so it counts no launches), on the CPU
    :func:`dropout_keep_plain`."""
    _check_dropout(p)
    device = torch.device(device)
    S_k = S if S_k is None else S_k
    if device.type == "cpu":
        return dropout_keep_plain(seed, B, H, S, p, device, S_k=S_k)
    if device.type != "cuda":
        raise RuntimeError(f"dropout_keep: no kernel for device {device}")
    out = torch.empty((B, H, S, S_k), dtype=torch.bool, device=device)
    key, step = _seed_args("dropout_keep", seed, out.device)
    fn = build.bind("flash_attention", "ptt_flash_dropout_mask",
                    (ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p,
                     ctypes.c_float, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p))
    err = fn(out.data_ptr(), key, step, p, B * H, S, S_k,
             build.stream_of(out))
    build.check(err, "dropout_keep")
    return out


def fold_mask(mask, B, H, S_q, S_k):
    """The reference's ``_fold_mask``: a bool (True = attend) or additive
    mask of rank <= 4 that broadcasts to [B, H, S_q, S_k] becomes the
    float32 additive bias (False -> -1e30), returned as an ``expand``ed
    [B, H, S_q, S_k] view with stride 0 over the broadcast dims (the
    reference folds it to [B*Hm, S_q, S_k] in memory)."""
    m = mask
    if m.dtype == torch.bool:
        m = torch.where(m, 0.0, NEG_INF)
    m = m.float()
    if m.dim() > 4:
        raise ValueError(f"flash_attention: mask rank {mask.dim()} "
                         "unsupported")
    m = m.reshape((1,) * (4 - m.dim()) + tuple(m.shape))
    try:
        return m.expand(B, H, S_q, S_k)
    except RuntimeError:
        raise ValueError(f"flash_attention: mask shape {tuple(mask.shape)} "
                         f"does not broadcast to ({B}, {H}, {S_q}, {S_k})")


class _Attention(torch.autograd.Function):
    """``_mha`` / ``_mha_masked`` with their custom_vjps: saves q, k, v,
    the bias, O and LSE, and the dropout's seed (the backward kernels draw
    its mask again); the bias's cotangent is zero (None)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale, dropout_p, seed):
        out, lse = flash_attention(q, k, v, causal, bias, sm_scale,
                                   dropout_p, seed)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.form = dict(causal=causal, sm_scale=sm_scale,
                        dropout_p=dropout_p, seed=seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        grads = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                      for t in (q, k, v))
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, out=grads,
                                         bias=bias, **ctx.form)
        return dq, dk, dv, None, None, None, None, None


class _PackedCausalAttention(torch.autograd.Function):
    """Causal attention over the fused projection qkv [B, S, 3, H, D]: the
    backward kernels write dq, dk, dv into the slices of one gradient of
    qkv's shape, so the three slices cost no extra copy or sum."""

    @staticmethod
    def forward(ctx, qkv, dropout_p, seed):
        out, lse = flash_attention(*qkv.unbind(2), dropout_p=dropout_p,
                                   seed=seed)
        ctx.save_for_backward(qkv, out, lse)
        ctx.dropout = dict(dropout_p=dropout_p, seed=seed)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        grad = torch.empty_like(qkv)
        flash_attention_bwd(*qkv.unbind(2), out, lse, do,
                            out=grad.unbind(2), **ctx.dropout)
        return grad, None, None


def _seed_for(dropout_p):
    """Each call with dropout draws its own mask's seed; 0 without."""
    _check_dropout(dropout_p)
    return _random.dropout_seed() if dropout_p > 0 else 0


def attention(q, k, v, causal=False, sm_scale=None, mask=None,
              dropout_p=0.0):
    """The reference's public ``flash_attention`` (:412): q [B, S_q, H, D]
    over k, v [B, S_k, H, D] -> [B, S_q, H, D], S_q == S_k or not (the
    cross-attention of an encoder-decoder, a cached decode step);
    ``mask`` is bool (True = attend) or additive, broadcastable to
    [B, H, S_q, S_k], composable with ``causal`` (top-left aligned: query
    i sees key j <= i); ``dropout_p`` > 0 drops the weights (the
    reference's composite form, :mod:`ops.fused`), with a mask of its own
    for each call, also under ``torch.no_grad()``.  Differentiable in q,
    k and v.  Grouped heads (k with fewer heads than q) are not ported."""
    B, S_q, H, _ = q.shape
    if k.shape[2] != H:
        raise NotImplementedError("flash_attention: GQA head mismatch")
    if v.shape != k.shape:
        raise ValueError(f"flash_attention: v {tuple(v.shape)} does not "
                         f"match k {tuple(k.shape)}")
    bias = None if mask is None else fold_mask(mask.to(q.device), B, H, S_q,
                                               k.shape[1])
    seed = _seed_for(dropout_p)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, bias, causal, sm_scale, dropout_p,
                                seed)
    return flash_attention(q, k, v, causal, bias, sm_scale, dropout_p,
                           seed)[0]


def causal_attention(q, k, v):
    """Causal attention over q, k, v [B, S, H, D]; differentiable."""
    return attention(q, k, v, causal=True)


def causal_attention_packed(qkv, dropout_p=0.0):
    """Causal attention over the fused projection qkv [B, S, 3, H, D];
    differentiable, with one packed gradient."""
    seed = _seed_for(dropout_p)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _PackedCausalAttention.apply(qkv, dropout_p, seed)
    return flash_attention(*qkv.unbind(2), dropout_p=dropout_p,
                           seed=seed)[0]


# the entries whose C code chooses between a CUDA-core kernel (index 0) and
# a tensor-core kernel (index 1): name -> (library, counting symbol)
VARIANTS = ("simt", "mma")
VARIANT_COUNTERS = {
    "flash_attention": ("flash_attention",
                        "ptt_flash_attention_fwd_variant_launches"),
    "flash_attention_dq": ("flash_attention_bwd",
                           "ptt_flash_attention_dq_variant_launches"),
    "flash_attention_dkv": ("flash_attention_bwd",
                            "ptt_flash_attention_dkv_variant_launches"),
}


def variant_launches():
    """{"flash_attention": {"simt": n, "mma": n}, "flash_attention_dq":
    {...}, "flash_attention_dkv": {...}}: how many launches took the
    CUDA-core kernel and the tensor-core kernel since the libraries were
    loaded, as the C entries counted them (builds the libraries if they
    are not built yet)."""
    return build.variant_counts(VARIANT_COUNTERS, VARIANTS)


def dropout_launches():
    """{entry: launches with dropout} of the three attention wrappers
    (each also counted in its ``launches``)."""
    return {fn.__name__: fn.dropout_launches
            for fn in (flash_attention, flash_attention_dq,
                       flash_attention_dkv)}


def cross_launches():
    """{entry: launches of the cross form, S_q != S_k} of the three
    attention wrappers (each also counted in its ``launches``)."""
    return {fn.__name__: fn.cross_launches
            for fn in (flash_attention, flash_attention_dq,
                       flash_attention_dkv)}


for _fn in (flash_attention, flash_attention_dq, flash_attention_dkv):
    _fn.launches = _fn.dropout_launches = _fn.cross_launches = 0
