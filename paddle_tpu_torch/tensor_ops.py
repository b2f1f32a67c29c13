"""The Paddle tensor API over torch tensors (port of the subset of
paddle_tpu/tensor_ops.py the ported models call: ``matmul``)."""
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
