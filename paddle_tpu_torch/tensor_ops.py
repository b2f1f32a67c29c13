"""The Paddle tensor API over torch tensors (port of the subset of
paddle_tpu/tensor_ops.py the ported models call: ``matmul`` and
``flatten``)."""
from __future__ import annotations

import torch


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """x @ y, each optionally transposed over its last two dims; a matmul
    of the AMP white list: under ``amp.auto_cast`` its floating inputs are
    cast to the AMP dtype first (:func:`amp.white_cast`, as the
    reference's ``matmul`` does)."""
    from .amp import white_cast

    a, b = white_cast(x, y)
    if transpose_x and a.dim() > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Dims ``start_axis`` to ``stop_axis`` (inclusive) merged into one
    (the reference's ``flatten``, paddle_tpu/tensor_ops.py:422)."""
    nd = x.dim()
    if nd == 0:
        return x.reshape(1)
    return x.flatten(start_axis % nd, stop_axis % nd)
