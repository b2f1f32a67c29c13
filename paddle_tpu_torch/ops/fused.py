"""Fused transformer-path ops (port of paddle_tpu/ops/fused.py: the entries
the GPT and BERT serving and training paths call).

Dispatch depends only on the tensor's device: a CPU tensor takes the
kernel module's plain PyTorch version, a CUDA tensor launches the
hand-written kernel or raises.  There is no flag and no fallback.  The
reference's ``paddle_pallas_fallbacks_total`` counter becomes a per-kernel
launch count on each wrapper (ops/kernels).  Each op is differentiable:
the kernel modules join forward and backward kernels in autograd
Functions, as the reference's custom_vjps do.  The matmuls around the
kernels stay ``torch.matmul``, as the reference leaves them to XLA (the
FFN's through AMP's ``white_cast``, as the reference's).
"""
from __future__ import annotations

import torch

from .kernels import bias_gelu as _bg
from .kernels import flash_attention as _fa
from .kernels import layer_norm as _ln
from .kernels import paged_attention as _pa
from .kernels import softmax_xent as _sx


def layer_norm(x, weight, bias, epsilon=1e-5):
    return _ln.layer_norm(x, weight, bias, epsilon)


def _dropout(y, dropout_p, training):
    if dropout_p <= 0.0 or not training:
        return y
    return torch.nn.functional.dropout(y, dropout_p, training=True)


def bias_gelu(x, bias, dropout_p=0.0, training=True):
    """gelu(x + bias) (exact erf form), optionally followed by dropout."""
    return _dropout(_bg.bias_gelu(x, bias), dropout_p, training)


def linear_bias_gelu(x, weight, bias, dropout_p=0.0, training=True):
    """gelu(x @ weight + bias): the FFN expansion with its fused
    epilogue.  ``bias`` may be None: then the plain erf GeLU of the
    matmul (the reference computes it in XLA, outside any kernel).  The
    matmul goes through the same AMP white_cast as
    ``nn.functional.linear``; the bias keeps its dtype (a float32 bias
    beside a 16-bit product under ``auto_cast`` O1 is the kernel's mixed
    form)."""
    from ..amp import white_cast

    y = torch.matmul(*white_cast(x, weight))
    if bias is None:
        return _dropout(torch.nn.functional.gelu(y), dropout_p, training)
    return bias_gelu(y, bias, dropout_p=dropout_p, training=training)


def softmax_cross_entropy(logits, label, ignore_index=-100):
    """Per-token softmax cross entropy over the last axis with hard
    labels, through the softmax_xent kernels (the reference's Pallas
    route; its shard_map branch waits for the distributed slice).
    Returns the loss with logits' leading shape, in logits' dtype."""
    return _sx.softmax_xent(logits, label, ignore_index=ignore_index)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """query [B, S_q, H, D] over key and value [B, S_k, H, D], [B, S_q,
    H, D] out (paddle layout), through the flash-attention kernels:
    self-attention (S_q == S_k) or cross-attention and a cached decode
    step (S_q != S_k), causal (top-left aligned) or not, with an optional
    bool (True = attend) or additive mask broadcastable to
    [B, H, S_q, S_k], and in training dropout ``dropout_p`` on the
    softmax weights, inside the kernels (the reference's composite:
    ``where(keep, w / (1 - p), 0)`` before ``w . V``)."""
    return _fa.attention(query, key, value, causal=is_causal,
                         mask=attn_mask,
                         dropout_p=dropout_p if training else 0.0)


def packed_causal_attention(qkv, dropout_p=0.0, training=True):
    """Causal attention over the fused projection qkv [B, S, 3, H, D]
    (q, k, v = its three slices); [B, S, H, D] out.  The same function as
    :func:`scaled_dot_product_attention` on the slices, with the gradient
    written as one packed [B, S, 3, H, D] tensor."""
    return _fa.causal_attention_packed(
        qkv, dropout_p=dropout_p if training else 0.0)


def paged_decode_attention(q, k_pages, v_pages, rows, pos, seq_cap):
    """q [slots, 1, nh, hd] (the step's query, after the scatter of its
    K/V); k_pages/v_pages [num_pages, page_size, nh, hd]; rows [slots,
    pages_per_slot] int32 (-1 = unmapped); pos [slots] int32 inclusive
    extent; seq_cap static.  Returns [slots, 1, nh, hd]."""
    return _pa.paged_decode_attention(q[:, 0], k_pages, v_pages, rows, pos,
                                      seq_cap)[:, None]


# ---------------------------------------------------------------------------
# fused LM-head matmul + cross entropy, chunked over the vocab
# ---------------------------------------------------------------------------
def _flce_forward(h, w, labels, chunk):
    """Online log-sum-exp over vocab chunks (reference ``_flce_impl``):
    the float32 [N, V] logits never exist at once.  Returns (per-token
    loss, lse), both float32 [N]."""
    hf = h.float()
    n, v = h.shape[0], w.shape[1]
    m = torch.full((n,), float("-inf"), dtype=torch.float32,
                   device=h.device)
    s = torch.zeros(n, dtype=torch.float32, device=h.device)
    picked = torch.zeros(n, dtype=torch.float32, device=h.device)
    for base in range(0, v, chunk):
        z = hf @ w[:, base:base + chunk].float()            # [N, c]
        c = z.shape[1]
        m_new = torch.maximum(m, z.amax(-1))
        s = s * torch.exp(m - m_new) \
            + torch.exp(z - m_new[:, None]).sum(-1)
        in_chunk = (labels >= base) & (labels < base + c)
        local = (labels - base).clamp(0, c - 1)
        picked = picked + torch.where(
            in_chunk, z.gather(1, local[:, None])[:, 0], 0.0)
        m = m_new
    lse = torch.log(s) + m
    return lse - picked, lse


def _flce_backward(h, w, labels, lse, g, chunk):
    """Reference ``_flce_bwd``: per chunk, recompute z, dz = (softmax -
    onehot) * g, and accumulate dh += dz . w_c^T, dw_c = h^T . dz, all in
    float32."""
    hf = h.float()
    gf = g.float()[:, None]
    dh = torch.zeros(hf.shape, dtype=torch.float32, device=h.device)
    dw = torch.empty(w.shape, dtype=torch.float32, device=h.device)
    for base in range(0, w.shape[1], chunk):
        wcf = w[:, base:base + chunk].float()
        dz = torch.exp(hf @ wcf - lse[:, None])             # softmax chunk
        c = dz.shape[1]
        in_chunk = (labels >= base) & (labels < base + c)
        local = (labels - base).clamp(0, c - 1)
        # subtract the one-hot with a scatter, not a host-side select
        dz.scatter_add_(1, local[:, None], -in_chunk.float()[:, None])
        dz = dz * gf
        dh += dz @ wcf.t()
        dw[:, base:base + c] = hf.t() @ dz
    return dh.to(h.dtype), dw.to(w.dtype)


class _FusedLinearCrossEntropy(torch.autograd.Function):
    """custom_vjp of the reference (``_flce``): saves h, w, the labels and
    the float32 lse; the backward recomputes each chunk's logits."""

    @staticmethod
    def forward(ctx, h, w, labels, chunk):
        loss, lse = _flce_forward(h, w, labels, chunk)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.chunk = chunk
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        dh, dw = _flce_backward(h, w, labels, lse, g, ctx.chunk)
        return dh, dw, None, None


def fused_linear_cross_entropy(hidden, weight, labels, chunk_size=8192):
    """loss = cross_entropy(hidden @ weight, labels), streamed over vocab
    chunks of ``chunk_size``; the products run in float32 through
    ``torch.matmul`` (TF32 is the caller's setting), as the reference
    computes them in XLA outside any kernel.

    hidden [..., H], weight [H, V], labels [...] int.  Returns the
    per-token float32 loss with hidden's leading shape."""
    lead = hidden.shape[:-1]
    h = hidden.reshape(-1, hidden.shape[-1])
    li = labels.reshape(-1).long()
    return _FusedLinearCrossEntropy.apply(h, weight, li,
                                          int(chunk_size)).reshape(lead)
