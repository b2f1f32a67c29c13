"""Causal flash attention, forward and backward: CUDA kernels, plain
versions, launch counts and the autograd Functions that join them.

Replaces paddle_tpu/ops/pallas/flash_attention.py ``_fwd_kernel`` (via
``_fwd_call``), ``_dq_kernel`` and ``_dkv_kernel`` (via ``_bwd_call``) on
their causal, unmasked form, with ``_mha_fwd``/``_mha_bwd`` as the
autograd Function.  At prefill and training shapes the bound is
operations (4*S^2*D/2 per head forward, 6 and 8 * S^2*D/2 in dq and
dk/dv) against one read of q, k, v (and dO).

- Forward (csrc/flash_attention.cu): one block per (batch*head, 64-row
  query tile), float32 online softmax over 32-key tiles staged in shared
  memory, stopping at the diagonal; writes O and LSE [B*H, S] float32.
- Backward (csrc/flash_attention_bwd.cu): two kernels with no atomics, so
  the gradients are the same from run to run.  dq: one block per
  (batch*head, query tile), walking key tiles up to the diagonal.  dk/dv:
  one block per (batch*head, key tile), walking query tiles from the
  diagonal to S.  Both recompute p = exp(s - lse) in float32.
  delta = rowsum(dO * O) is computed here in PyTorch
  (:func:`flash_attention_delta`), as the reference computes it in XLA.

Every kernel reads the paddle [B, S, H, D] layout through strides, so the
fused qkv projection's slices need no transpose or copy, and the backward
writes dq, dk, dv straight into one packed [B, S, 3, H, D] gradient
(:func:`causal_attention_packed`).  Any S >= 1; head dim 16, 32, 64 or
128.

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
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) * 9 \
    + (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 4 \
    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
_DQ_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 4 \
    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
_DKV_ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 4 \
    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def flash_attention_plain(q, k, v):
    """Causal softmax attention over [B, S, H, D] in float32.  Returns
    (out [B, S, H, D] in q's dtype, lse [B*H, S] float32)."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, -1e30)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhst,bthd->bshd", p, v.float())
    return out.to(q.dtype), lse.reshape(B * H, S)


def flash_attention_delta(o, do):
    """delta = rowsum(dO * O) in float32, as [B*H, S] (the reference's
    ``_bwd_call`` computes it in XLA before the two kernels)."""
    B, S, H, _ = o.shape
    delta = (do.float() * o.float()).sum(-1)          # [B, S, H]
    return delta.permute(0, 2, 1).reshape(B * H, S).contiguous()


def _bwd_plain_terms(q, k, v, do, lse, delta):
    """p = exp(s - lse) and ds = p * (dO.V^T - delta) * scale, float32
    [B, H, S, S], from the forward's lse and the caller's delta."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.exp(s - lse.reshape(B, H, S, 1))
    dp = torch.einsum("bshd,bthd->bhst", do.float(), v.float())
    ds = p * (dp - delta.reshape(B, H, S, 1)) * scale
    return p, ds


def flash_attention_dq_plain(q, k, v, do, lse, delta):
    """dq = ds . k over [B, S, H, D], in q's dtype."""
    _, ds = _bwd_plain_terms(q, k, v, do, lse, delta)
    return torch.einsum("bhst,bthd->bshd", ds, k.float()).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta):
    """(dk = ds^T . q, dv = p^T . dO) over [B, S, H, D], in k's dtype."""
    p, ds = _bwd_plain_terms(q, k, v, do, lse, delta)
    dk = torch.einsum("bhst,bshd->bthd", ds, q.float())
    dv = torch.einsum("bhst,bshd->bthd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """(dq, dk, dv) of causal attention from the forward's O and LSE."""
    delta = flash_attention_delta(o, do)
    dq = flash_attention_dq_plain(q, k, v, do, lse, delta)
    return (dq, *flash_attention_dkv_plain(q, k, v, do, lse, delta))


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


def _device(name, q):
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    return q.device.type


def flash_attention(q, k, v):
    """Causal attention, q/k/v [B, S, H, D] (paddle layout, any strides
    with a unit stride over D).  Returns (out [B, S, H, D] contiguous,
    lse [B*H, S] float32).  No graph: see :func:`causal_attention`."""
    if _device("flash_attention", q) == "cpu":
        return flash_attention_plain(q, k, v)
    B, S, H, D = q.shape
    _check("flash_attention", q, k, v)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    fn = build.bind("flash_attention", "ptt_flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             out.data_ptr(), lse.data_ptr(), B, S, H, D,
             1.0 / math.sqrt(D), build.dtype_code(q), build.stream_of(q))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_dq(q, k, v, do, lse, delta, out=None):
    """dq of causal attention, written into ``out`` (a [B, S, H, D] view
    with unit stride over D, allocated when None).  Returns it."""
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if _device("flash_attention_dq", q) == "cpu":
        return out.copy_(flash_attention_dq_plain(q, k, v, do, lse, delta))
    B, S, H, D = q.shape
    _check("flash_attention_dq", q, k, v, do, out)
    _check_stats("flash_attention_dq", q, lse, delta)
    fn = build.bind("flash_attention_bwd", "ptt_flash_attention_dq",
                    _DQ_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), out.data_ptr(),
             build.strides(q, k, v, do, out), B, S, H, D,
             1.0 / math.sqrt(D), build.dtype_code(q), build.stream_of(q))
    build.check(err, "flash_attention_dq")
    flash_attention_dq.launches += 1
    return out


def flash_attention_dkv(q, k, v, do, lse, delta, out=None):
    """(dk, dv) of causal attention, written into ``out`` (two [B, S, H,
    D] views with unit stride over D, allocated when None)."""
    if out is None:
        out = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                    for _ in range(2))
    dk, dv = out
    if _device("flash_attention_dkv", q) == "cpu":
        pk, pv = flash_attention_dkv_plain(q, k, v, do, lse, delta)
        return dk.copy_(pk), dv.copy_(pv)
    B, S, H, D = q.shape
    _check("flash_attention_dkv", q, k, v, do, dk, dv)
    _check_stats("flash_attention_dkv", q, lse, delta)
    fn = build.bind("flash_attention_bwd", "ptt_flash_attention_dkv",
                    _DKV_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             build.strides(q, k, v, do, dk, dv), B, S, H, D,
             1.0 / math.sqrt(D), build.dtype_code(q), build.stream_of(q))
    build.check(err, "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, out=None):
    """(dq, dk, dv) of causal attention from the forward's O and LSE, by
    the dq kernel and the dk/dv kernel.  ``out``: three [B, S, H, D]
    views to write into; by default the slices of one packed
    [B, S, 3, H, D] tensor."""
    if out is None:
        B, S, H, D = q.shape
        out = torch.empty((B, S, 3, H, D), dtype=q.dtype,
                          device=q.device).unbind(2)
    do = do.contiguous()
    delta = flash_attention_delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, out=out[0])
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, out=out[1:])
    return dq, dk, dv


class _CausalAttention(torch.autograd.Function):
    """``_mha`` with its custom_vjp: saves q, k, v, O and LSE."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        return flash_attention_bwd(*ctx.saved_tensors, do)


class _PackedCausalAttention(torch.autograd.Function):
    """The same over the fused projection qkv [B, S, 3, H, D]: the
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


def causal_attention(q, k, v):
    """Causal attention over q, k, v [B, S, H, D]; differentiable."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _CausalAttention.apply(q, k, v)
    return flash_attention(q, k, v)[0]


def causal_attention_packed(qkv):
    """Causal attention over the fused projection qkv [B, S, 3, H, D];
    differentiable, with one packed gradient."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _PackedCausalAttention.apply(qkv)
    return flash_attention(*qkv.unbind(2))[0]


flash_attention.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
