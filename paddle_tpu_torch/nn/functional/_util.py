"""Helpers shared by the functional modules (the reference's
``_norm_tuple`` and ``_check_dim``, paddle_tpu/nn/functional/__init__.py)."""
from __future__ import annotations

import numpy as np


def norm_tuple(v, n):
    """An int -> n copies; a sequence -> a tuple of ints."""
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(u) for u in v)


def _check_dim(got, want, op, what):
    """A named ValueError where the reference raises one, instead of the
    backend's own shape error."""
    if got is not None and want is not None and int(got) != int(want):
        raise ValueError(f"{op}: {what}: got {got}, expected {want}")


def reduce_loss(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
