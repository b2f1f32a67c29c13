"""Flash attention, forward and backward, causal or not, with an optional
additive mask: CUDA kernels, plain versions, launch counts and the
autograd Functions that join them.

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
  stopping at the diagonal when causal; writes O and LSE [B*H, S]
  float32.
- Backward (csrc/flash_attention_bwd.cu): two kernels with no atomics, so
  the gradients are the same from run to run.  dq: one block per
  (batch*head, query tile), walking key tiles.  dk/dv: one block per
  (batch*head, key tile), walking query tiles.  Both recompute
  p = exp(s - lse) in float32.  delta = rowsum(dO * O) is computed here
  in PyTorch (:func:`flash_attention_delta`), as the reference computes
  it in XLA.
- The forward and dk/dv each have two hand-written kernels: bf16 operands
  whose base pointers and (b, s, h) strides are 16-byte multiples (the
  fused qkv's slices, separate projections: every path of the models)
  run on the tensor cores (``mma.sync`` with float32 accumulators, P and
  dS rounded to bf16 before the second product, as the reference rounds
  them); float32, and bf16 that is not so aligned, run on the CUDA cores.
  The C entry decides from dtype and alignment alone;
  :func:`variant_launches` reports which kernel the launches took.
- Scores follow the reference's ``_scores``: scale, add the bias, then
  the causal replace.  The bias is float32 [B, H, S, S], usually an
  ``expand``ed view: the kernels read it through its four strides, so a
  [B, 1, 1, S] padding mask costs S floats per batch row, not the
  reference's folded [B*H, S, S].  A bool mask becomes 0 / -1e30
  (:func:`fold_mask`).  The mask is data: its gradient is zero.

Every kernel reads the paddle [B, S, H, D] layout through strides, so the
fused qkv projection's slices need no transpose or copy, and the backward
can write dq, dk, dv straight into one packed [B, S, 3, H, D] gradient
(:func:`causal_attention_packed`).  Any S >= 1; head dim 16, 32, 64 or
128; self-attention only (S_q == S_k).

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
or raises.  The Functions build a graph only when grad mode is on and an
input requires grad; serving under ``torch.no_grad()`` calls the forward
kernel directly.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 128)
NEG_INF = -1e30       # what a False entry of a bool mask adds (reference)
_BIAS_ARGTYPES = (ctypes.c_void_p,) + (ctypes.c_longlong,) * 4
_TAIL_ARGTYPES = (ctypes.c_int,) * 4 + (ctypes.c_float, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p)
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) * 9 \
    + (ctypes.c_void_p,) * 2 + _BIAS_ARGTYPES + _TAIL_ARGTYPES
_DQ_ARGTYPES = (ctypes.c_void_p,) * 8 + _BIAS_ARGTYPES + _TAIL_ARGTYPES
_DKV_ARGTYPES = (ctypes.c_void_p,) * 9 + _BIAS_ARGTYPES + _TAIL_ARGTYPES


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None \
        else float(sm_scale)


def _scores_plain(q, k, causal, bias, sm_scale):
    """The reference's ``_scores`` in float32 [B, H, S, S]: scale, add the
    bias, then the causal replace (by -inf, which gives the kernels' 0)."""
    S = q.shape[1]
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        * _scale(q, sm_scale)
    if bias is not None:
        s = s + bias
    if causal:
        visible = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~visible, float("-inf"))
    return s


def flash_attention_plain(q, k, v, causal=True, bias=None, sm_scale=None):
    """Softmax attention over [B, S, H, D] in float32.  Returns (out
    [B, S, H, D] in q's dtype, lse [B*H, S] float32).  The softmax is
    normalised by its sum, as the kernels' is, not by exp(lse): for a
    row masked everywhere by -1e30, lse = -1e30 + log(S) rounds to -1e30
    and exp(s - lse) would sum V instead of averaging it.  A row with no
    visible key at all (an all -inf bias) gives 0 (the reference's
    ``l_safe``)."""
    B, S, H, D = q.shape
    s = _scores_plain(q, k, causal, bias, sm_scale)
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == float("-inf"), 0.0, m)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    l = torch.where(l == 0, 1.0, l)
    out = torch.einsum("bhst,bthd->bshd", e / l, v.float())
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse.reshape(B * H, S)


def flash_attention_delta(o, do):
    """delta = rowsum(dO * O) in float32, as [B*H, S] (the reference's
    ``_bwd_call`` computes it in XLA before the two kernels)."""
    B, S, H, _ = o.shape
    delta = (do.float() * o.float()).sum(-1)          # [B, S, H]
    return delta.permute(0, 2, 1).reshape(B * H, S).contiguous()


def _bwd_plain_terms(q, k, v, do, lse, delta, causal, bias, sm_scale):
    """p = exp(s - lse) and ds = p * (dO.V^T - delta) * scale, float32
    [B, H, S, S], from the forward's lse and the caller's delta."""
    B, S, H, D = q.shape
    s = _scores_plain(q, k, causal, bias, sm_scale)
    p = torch.exp(s - lse.reshape(B, H, S, 1))
    dp = torch.einsum("bshd,bthd->bhst", do.float(), v.float())
    ds = p * (dp - delta.reshape(B, H, S, 1)) * _scale(q, sm_scale)
    return p, ds


def flash_attention_dq_plain(q, k, v, do, lse, delta, causal=True,
                             bias=None, sm_scale=None):
    """dq = ds . k over [B, S, H, D], in q's dtype."""
    _, ds = _bwd_plain_terms(q, k, v, do, lse, delta, causal, bias,
                             sm_scale)
    return torch.einsum("bhst,bthd->bshd", ds, k.float()).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, causal=True,
                              bias=None, sm_scale=None):
    """(dk = ds^T . q, dv = p^T . dO) over [B, S, H, D], in k's dtype."""
    p, ds = _bwd_plain_terms(q, k, v, do, lse, delta, causal, bias,
                             sm_scale)
    dk = torch.einsum("bhst,bshd->bthd", ds, q.float())
    dv = torch.einsum("bhst,bshd->bthd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True, bias=None,
                              sm_scale=None):
    """(dq, dk, dv) from the forward's O and LSE."""
    delta = flash_attention_delta(o, do)
    form = dict(causal=causal, bias=bias, sm_scale=sm_scale)
    dq = flash_attention_dq_plain(q, k, v, do, lse, delta, **form)
    return (dq, *flash_attention_dkv_plain(q, k, v, do, lse, delta, **form))


def _check(name, q, *others):
    B, S, H, D = q.shape
    for t in others:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not match q {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
    for t in (q, *others):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: every [B, S, H, D] operand needs unit "
                             "stride over the head dim")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"{name}: batch*heads {B * H} > 65535")


def _check_stats(name, q, *stats):
    B, S, H, _ = q.shape
    for t in stats:
        if t.shape != (B * H, S) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: lse and delta must be contiguous "
                             f"float32 [{B * H}, {S}] tensors on {q.device}")


def _bias_args(name, q, bias):
    """(pointer, b, h, q, k strides) of a float32 [B, H, S, S] bias, any
    strides; NULL and zeros without one."""
    if bias is None:
        return (None, 0, 0, 0, 0)
    B, S, H, _ = q.shape
    if bias.shape != (B, H, S, S) or bias.dtype != torch.float32 \
            or bias.device != q.device:
        raise ValueError(f"{name}: bias must be a float32 [{B}, {H}, {S}, "
                         f"{S}] tensor (any strides) on {q.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    return (bias.data_ptr(), *bias.stride())


def _device(name, q):
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    return q.device.type


def flash_attention(q, k, v, causal=True, bias=None, sm_scale=None):
    """The forward kernel: attention over q/k/v [B, S, H, D] (paddle
    layout, any strides with a unit stride over D), causal (the GPT
    path's form, the default) or not, plus an optional float32
    [B, H, S, S] bias.  Returns (out [B, S, H, D] contiguous, lse
    [B*H, S] float32).  No graph: see :func:`attention`."""
    if _device("flash_attention", q) == "cpu":
        return flash_attention_plain(q, k, v, causal, bias, sm_scale)
    B, S, H, D = q.shape
    _check("flash_attention", q, k, v)
    bias_args = _bias_args("flash_attention", q, bias)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    fn = build.bind("flash_attention", "ptt_flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             out.data_ptr(), lse.data_ptr(), *bias_args, B, S, H, D,
             _scale(q, sm_scale), int(causal), build.dtype_code(q),
             build.stream_of(q))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_dq(q, k, v, do, lse, delta, out=None, causal=True,
                       bias=None, sm_scale=None):
    """dq, written into ``out`` (a [B, S, H, D] view with unit stride over
    D, allocated when None).  Returns it."""
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if _device("flash_attention_dq", q) == "cpu":
        return out.copy_(flash_attention_dq_plain(
            q, k, v, do, lse, delta, causal, bias, sm_scale))
    B, S, H, D = q.shape
    _check("flash_attention_dq", q, k, v, do, out)
    _check_stats("flash_attention_dq", q, lse, delta)
    bias_args = _bias_args("flash_attention_dq", q, bias)
    fn = build.bind("flash_attention_bwd", "ptt_flash_attention_dq",
                    _DQ_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), out.data_ptr(),
             build.strides(q, k, v, do, out), *bias_args, B, S, H, D,
             _scale(q, sm_scale), int(causal), build.dtype_code(q),
             build.stream_of(q))
    build.check(err, "flash_attention_dq")
    flash_attention_dq.launches += 1
    return out


def flash_attention_dkv(q, k, v, do, lse, delta, out=None, causal=True,
                        bias=None, sm_scale=None):
    """(dk, dv), written into ``out`` (two [B, S, H, D] views with unit
    stride over D, allocated when None)."""
    if out is None:
        out = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                    for _ in range(2))
    dk, dv = out
    if _device("flash_attention_dkv", q) == "cpu":
        pk, pv = flash_attention_dkv_plain(q, k, v, do, lse, delta, causal,
                                           bias, sm_scale)
        return dk.copy_(pk), dv.copy_(pv)
    B, S, H, D = q.shape
    _check("flash_attention_dkv", q, k, v, do, dk, dv)
    _check_stats("flash_attention_dkv", q, lse, delta)
    bias_args = _bias_args("flash_attention_dkv", q, bias)
    fn = build.bind("flash_attention_bwd", "ptt_flash_attention_dkv",
                    _DKV_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             build.strides(q, k, v, do, dk, dv), *bias_args, B, S, H, D,
             _scale(q, sm_scale), int(causal), build.dtype_code(q),
             build.stream_of(q))
    build.check(err, "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, out=None, causal=True,
                        bias=None, sm_scale=None):
    """(dq, dk, dv) from the forward's O and LSE, by the dq kernel and the
    dk/dv kernel.  ``out``: three [B, S, H, D] views to write into; by
    default the slices of one packed [B, S, 3, H, D] tensor."""
    if out is None:
        B, S, H, D = q.shape
        out = torch.empty((B, S, 3, H, D), dtype=q.dtype,
                          device=q.device).unbind(2)
    do = do.contiguous()
    delta = flash_attention_delta(o, do)
    form = dict(causal=causal, bias=bias, sm_scale=sm_scale)
    dq = flash_attention_dq(q, k, v, do, lse, delta, out=out[0], **form)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, out=out[1:],
                                 **form)
    return dq, dk, dv


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
    the bias, O and LSE; the bias's cotangent is zero (None)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale):
        out, lse = flash_attention(q, k, v, causal, bias, sm_scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        grads = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                      for t in (q, k, v))
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, out=grads,
                                         causal=ctx.causal, bias=bias,
                                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None


class _PackedCausalAttention(torch.autograd.Function):
    """Causal attention over the fused projection qkv [B, S, 3, H, D]: the
    backward kernels write dq, dk, dv into the slices of one gradient of
    qkv's shape, so the three slices cost no extra copy or sum."""

    @staticmethod
    def forward(ctx, qkv):
        out, lse = flash_attention(*qkv.unbind(2))
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        grad = torch.empty_like(qkv)
        flash_attention_bwd(*qkv.unbind(2), out, lse, do,
                            out=grad.unbind(2))
        return grad


def attention(q, k, v, causal=False, sm_scale=None, mask=None):
    """The reference's public ``flash_attention`` (:412): q, k, v
    [B, S, H, D] -> [B, S, H, D]; ``mask`` is bool (True = attend) or
    additive, broadcastable to [B, H, S, S], composable with ``causal``.
    Differentiable in q, k and v.  Cross-attention (S_q != S_k) and
    grouped heads are not ported."""
    B, S, H, _ = q.shape
    if k.shape[1] != S or v.shape[1] != S:
        raise NotImplementedError(
            f"flash_attention: cross-attention (S_q {S} != S_k "
            f"{k.shape[1]}) is not ported yet")
    if k.shape[2] != H:
        raise NotImplementedError("flash_attention: GQA head mismatch")
    bias = None if mask is None else fold_mask(mask.to(q.device), B, H, S,
                                               S)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, bias, causal, sm_scale)
    return flash_attention(q, k, v, causal, bias, sm_scale)[0]


def causal_attention(q, k, v):
    """Causal attention over q, k, v [B, S, H, D]; differentiable."""
    return attention(q, k, v, causal=True)


def causal_attention_packed(qkv):
    """Causal attention over the fused projection qkv [B, S, 3, H, D];
    differentiable, with one packed gradient."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _PackedCausalAttention.apply(qkv)
    return flash_attention(*qkv.unbind(2))[0]


def variant_launches():
    """{"flash_attention": {"simt": n, "mma": n}, "flash_attention_dkv":
    {...}}: how many launches took the CUDA-core kernel and the
    tensor-core kernel since the libraries were loaded, as the C entries
    counted them (builds the libraries if they are not built yet)."""
    out = {}
    for name, lib, symbol in (
            ("flash_attention", "flash_attention",
             "ptt_flash_attention_fwd_variant_launches"),
            ("flash_attention_dkv", "flash_attention_bwd",
             "ptt_flash_attention_dkv_variant_launches")):
        fn = getattr(build.library(lib), symbol)
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
        out[name] = {"simt": fn(0), "mma": fn(1)}
    return out


flash_attention.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
