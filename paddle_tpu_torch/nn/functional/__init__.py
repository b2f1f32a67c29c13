"""nn.functional (port of paddle_tpu/nn/functional/__init__.py): here
linear, relu, tanh, gelu, softmax and log_softmax, layer_norm, embedding,
dropout, cross_entropy and scaled_dot_product_attention; convolution
(``conv``), pooling (``pooling``), batch/instance/group norm and the
others (``norm``), the other activations (``activation``) and losses
(``loss``) in the modules of this package, all exported here.

``layer_norm`` routes a 1-D scale+shift through ops/fused.py, which
launches the CUDA kernel for a CUDA tensor, as the reference routes it to
the Pallas kernel (nn/functional/__init__.py:616).  ``cross_entropy`` with
hard labels, no class weight, softmax and the last axis goes to the
softmax_xent kernels the same way (:823), and ``scaled_dot_product_attention``
to the flash-attention kernels (:1098).
"""
from __future__ import annotations

import torch

from ._util import reduce_loss as _reduce_loss
from .activation import (celu, elu, glu, gumbel_softmax,  # noqa: F401
                         hardshrink, hardsigmoid, hardswish, hardtanh,
                         label_smooth, leaky_relu, log_sigmoid, maxout, mish,
                         one_hot, prelu, relu6, relu_, selu, sigmoid, silu,
                         softplus, softshrink, softsign, swish, tanhshrink,
                         thresholded_relu)
from .conv import (conv1d, conv1d_transpose, conv2d,  # noqa: F401
                   conv2d_transpose, conv3d, conv3d_transpose)
from .loss import (binary_cross_entropy,  # noqa: F401
                   binary_cross_entropy_with_logits, cosine_embedding_loss,
                   cosine_similarity, ctc_loss, hinge_embedding_loss, kl_div,
                   l1_loss, margin_ranking_loss, mse_loss, nll_loss,
                   sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost)
from .norm import (batch_norm, group_norm, instance_norm,  # noqa: F401
                   local_response_norm, normalize)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_max_pool2d, avg_pool1d, avg_pool2d,
                      avg_pool3d, max_pool1d, max_pool2d, max_pool3d)


def linear(x, weight, bias=None, name=None):
    """paddle convention: weight shape [in_features, out_features].  A
    matmul of the AMP white list: under ``amp.auto_cast`` x and the
    weight are cast to the AMP dtype, and the bias to the product's."""
    from ...amp import white_cast

    if x.shape[-1] != weight.shape[0]:
        raise ValueError(
            f"linear: input last dim vs weight in_features: got "
            f"{x.shape[-1]}, expected {weight.shape[0]}")
    y = torch.matmul(*white_cast(x, weight))
    return y if bias is None else y + bias.to(y.dtype)


def relu(x, name=None):
    return torch.relu(x)


def tanh(x, name=None):
    return torch.tanh(x)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtype)
    return torch.softmax(x, axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    """``dtype`` is accepted and unused, as in the reference."""
    return torch.log_softmax(x, axis)


def gelu(x, approximate=False, name=None):
    """Exact erf GeLU by default (paddle's default)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    ns = (normalized_shape,) if isinstance(normalized_shape, int) \
        else tuple(normalized_shape)
    if tuple(x.shape[len(x.shape) - len(ns):]) != tuple(ns):
        raise ValueError(f"layer_norm: trailing dims {tuple(x.shape)} vs "
                         f"normalized_shape {ns}")
    if len(ns) == 1 and weight is not None and bias is not None:
        from ...ops import fused

        return fused.layer_norm(x, weight, bias, epsilon)
    dims = tuple(range(x.dim() - len(ns), x.dim()))
    mean = x.mean(dims, keepdim=True)
    var = (x - mean).square().mean(dims, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


class _Embedding(torch.autograd.Function):
    """The lookup with a weight gradient summed in one fixed order.
    PyTorch's CUDA embedding backward sums the colliding rows of a
    float32 table in an order that varies from call to call when the table
    has few rows (BERT's 2 and ERNIE's 4 segment types over a 4096-token
    batch: the gradient moved by ~1e-7 between two calls, measured on an
    H100), and a float16 table's the same way (two AMP-O2 ERNIE runs from
    one seed drifted apart after 25 steps), so two runs, or a captured
    step and its eager twin, are not bitwise equal.  Here the gradient is
    ``index_put_`` with ``accumulate=True``, which sorts the ids and sums
    each id's rows in order, in float32, then takes the table's dtype.
    bf16 tables keep PyTorch's backward, which gave the same bits in every
    call measured (it also accumulates in float32)."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return torch.nn.functional.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        d = grad.shape[-1]
        gw = torch.zeros(ctx.rows, d, dtype=torch.float32,
                         device=grad.device).index_put_(
            (ids.reshape(-1),), grad.reshape(-1, d).float(),
            accumulate=True)
        return None, gw.to(grad.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x``; the rows of ids equal to
    ``padding_idx`` are zeros (so they take no gradient), as in the
    reference (:225).  ``sparse`` is accepted and unused, as there."""
    if x.is_floating_point():
        raise TypeError(
            f"embedding: ids must be an integer tensor, got dtype {x.dtype}")
    if weight.dtype != torch.bfloat16 and torch.is_grad_enabled() \
            and weight.requires_grad:
        out = _Embedding.apply(x.long(), weight)
    else:
        out = torch.nn.functional.embedding(x.long(), weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """The reference's dropout (:767): each entry kept with probability
    ``1 - p``; ``axis`` (an int or a sequence) draws one keep mask over
    those dimensions only, shared along the others.  ``mode``
    ``"upscale_in_train"`` scales the kept entries by ``1 / (1 - p)`` in
    training and leaves eval alone; ``"downscale_in_infer"`` does not
    scale in training and multiplies by ``1 - p`` in eval (Paddle's
    definition).  The mask draws from torch's generator of ``x``'s
    device; with no ``axis`` in ``upscale_in_train`` mode it is
    ``torch.nn.functional.dropout``'s."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not training:
        return x * (1.0 - p) if mode == "downscale_in_infer" else x
    if p == 0.0:
        return x
    if axis is None and mode == "upscale_in_train":
        return torch.nn.functional.dropout(x, p, training=True)
    axes = range(x.dim()) if axis is None else \
        [a % x.dim() for a in ([axis] if isinstance(axis, int) else axis)]
    shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = torch.empty(shape, device=x.device).bernoulli_(1.0 - p).bool()
    if mode == "upscale_in_train":
        x = x / (1.0 - p)
    return torch.where(keep, x, x.new_zeros(()))


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Softmax cross entropy (reference :823).  Hard labels with no
    weight, softmax on and the last axis go through
    ops/fused.softmax_cross_entropy (the kernels) and reduce as the
    reference's kernel route does: ``mean`` is a plain mean over every
    entry.  Soft labels, class weights and ``use_softmax=False`` are the
    reference's composite math in PyTorch (no kernel exists for them
    there either), where ``mean`` is over the valid entries unless
    ``ignore_index == -100`` and there is no weight."""
    if not soft_label and label.is_floating_point():
        raise TypeError(
            "cross_entropy: hard labels must be integer class ids (got "
            f"dtype {label.dtype}); pass soft_label=True for probability "
            "targets")
    from ...ops import fused

    nd = input.dim()
    ax = axis % nd
    if use_softmax and not soft_label and weight is None \
            and ax == nd - 1:
        raw = fused.softmax_cross_entropy(input, label, ignore_index)
        return _reduce_loss(raw, reduction)
    if use_softmax:
        logp = torch.log_softmax(input, ax)
    else:
        logp = torch.log(input.clamp(1e-15, 1.0))
    if soft_label:
        raw = -(label * logp).sum(ax)
        return _reduce_loss(raw, reduction)
    li = label.long()
    if li.dim() == nd:
        li = li.squeeze(ax)
    valid = li != ignore_index
    picked = logp.gather(ax, li.clamp(0, logp.shape[ax] - 1).unsqueeze(ax))
    raw = torch.where(valid, -picked.squeeze(ax), 0.0)
    cw = None
    if weight is not None:
        cw = torch.where(valid, weight[li.clamp_min(0)], 0.0)
        raw = raw * cw
    if reduction == "none":
        return raw
    if reduction == "sum":
        return raw.sum()
    if ignore_index == -100 and weight is None:
        return raw.mean()
    denom = cw.sum() if cw is not None else valid.float().sum()
    return raw.sum() / denom


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """query [B, S_q, H, D] over key and value [B, S_k, H, D] (paddle
    layout; S_q == S_k or not), ``attn_mask`` broadcastable to
    [B, H, S_q, S_k], through the flash-attention kernels
    (ops/fused.py)."""
    from ...ops import fused

    return fused.scaled_dot_product_attention(
        query, key, value, attn_mask=attn_mask, dropout_p=dropout_p,
        is_causal=is_causal, training=training)
