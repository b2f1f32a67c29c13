"""Losses (port of paddle_tpu/nn/functional/__init__.py:900-1103:
``softmax_with_cross_entropy`` and ``nll_loss`` through ``ctc_loss``;
``cross_entropy``, which reaches the softmax cross-entropy kernels, lives
in the package's ``__init__``).  jnp math in the reference, PyTorch's ops
here with the reference's formulas: log terms clipped at 1e-12 (not
PyTorch's -100 clamp), ``nll_loss``'s mean over the weight of the
targets that count, ``smooth_l1_loss``'s delta as PyTorch's beta,
``kl_div``'s ``batchmean`` over the first dim.

``ctc_loss`` takes the reference's logits [T, B, C] (it applies
log_softmax itself) and runs PyTorch's CTC over them; ``mean`` divides
each loss by its label length first, as the reference's and PyTorch's
do.  The reference sums its alpha recursion with a 1e-30 floor inside
the log, so an alignment that cannot exist costs about 69 a step there
and inf here.
"""
from __future__ import annotations

import torch

from ._util import reduce_loss

_F = torch.nn.functional
_EPS = 1e-12


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    from . import cross_entropy, softmax

    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    """input [N, C] or [N, C, d1, ...] log-probabilities; ``mean`` divides
    by the summed weight of the targets not ignored (an all-ignored batch
    is 0 / 0 = NaN, as in the reference and PyTorch)."""
    logp = input.movedim(1, -1) if input.dim() > 2 else input
    lab = label.long()
    ign = lab == ignore_index
    safe = torch.where(ign, torch.zeros_like(lab), lab)
    loss = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    wt = weight[safe] if weight is not None else torch.ones_like(loss)
    wt = torch.where(ign, torch.zeros_like(wt), wt)
    wl = torch.where(ign, torch.zeros_like(loss), loss * wt)
    if reduction == "mean":
        return wl.sum() / wt.sum()
    if reduction == "sum":
        return wl.sum()
    return wl


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return reduce_loss((input - label).square(), reduction)


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return reduce_loss((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    d = (input - label).abs()
    raw = torch.where(d < delta, 0.5 * d.square() / delta, d - 0.5 * delta)
    return reduce_loss(raw, reduction)


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean", name=None):
    loss = -(label * torch.log(input.clamp_min(_EPS))
             + (1 - label) * torch.log((1 - input).clamp_min(_EPS)))
    if weight is not None:
        loss = loss * weight
    return reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    pos, neg = _F.logsigmoid(logit), _F.logsigmoid(-logit)
    if pos_weight is not None:
        loss = -(pos_weight * label * pos + (1 - label) * neg)
    else:
        loss = -(label * pos + (1 - label) * neg)
    if weight is not None:
        loss = loss * weight
    return reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):  # noqa: A002
    raw = label * (torch.log(label.clamp_min(_EPS)) - input)
    if reduction == "batchmean":
        return raw.sum() / input.shape[0]
    return reduce_loss(raw, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    return reduce_loss((-label * (input - other) + margin).clamp_min(0.0),
                       reduction)


def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean", name=None):
    raw = torch.where(label == 1, input, (margin - input).clamp_min(0.0))
    return reduce_loss(raw, reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = (x1 * x2).sum(axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / (n1 * n2).clamp_min(eps)


def cosine_embedding_loss(input1, input2, label, margin=0,
                          reduction="mean", name=None):
    sim = cosine_similarity(input1, input2, axis=1)
    raw = torch.where(label == 1, 1 - sim, (sim - margin).clamp_min(0.0))
    return reduce_loss(raw, reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = -(label * _F.logsigmoid(logit)
           + (1 - label) * _F.logsigmoid(-logit))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * (1 - p_t).pow(gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return reduce_loss(loss, reduction)


def square_error_cost(input, label):  # noqa: A002
    return (input - label).square()


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """log_probs: the reference's [T, B, C] logits (normalised here);
    labels [B, L] padded; ``norm_by_times`` is accepted and unused, as in
    the reference."""
    lp = torch.log_softmax(log_probs.float(), -1)
    raw = _F.ctc_loss(lp, labels.long(), input_lengths.long(),
                      label_lengths.long(), blank=blank, reduction="none")
    if reduction == "mean":
        return (raw / label_lengths.clamp_min(1).to(raw.dtype)).mean()
    return reduce_loss(raw, reduction)


# ``cross_entropy``, which the package's ``__init__`` defines, under this
# module's path too (the reference's ``loss`` module re-exports it); read
# at access: this module is imported before the package defines it
def __getattr__(name):
    if name == "cross_entropy":
        from .. import functional
        return functional.cross_entropy
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
