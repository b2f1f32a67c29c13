"""Pooling (port of paddle_tpu/nn/functional/__init__.py:448-600: ``_pool``,
max/avg 1D/2D/3D, the adaptive pools).

The reference lowers pooling to ``lax.reduce_window`` (an XLA op, not a
Pallas kernel), so the port calls PyTorch's pools, keeping the reference's
semantics where PyTorch's differ:

- ``ceil_mode``: the reference widens the right pad until the last window
  fits ((size - k) % stride more), and keeps every window, one that
  starts in the padding too; PyTorch's ``ceil_mode`` drops such a window.
  The port pads explicitly (max with -inf, avg with zeros) and pools with
  no padding, so it keeps the reference's windows.
- ``exclusive`` (the default) divides each window's sum by its count of
  real elements (the widened pad is not counted); ``exclusive=False`` by
  the kernel's size, for every window.
- A symmetric pad no wider than half the kernel and no ceil widening is
  PyTorch's own ``padding`` (the same function, without the copy).
- ``adaptive_max_pool2d`` and ``adaptive_avg_pool1d`` are the reference's
  windows of H // out, strided by H // out (so a size that out does not
  divide gives H // (H // out) outputs, not out: ROADMAP.md §C);
  ``adaptive_avg_pool2d`` takes the bins floor(i * H / out) to
  ceil((i + 1) * H / out), as PyTorch's adaptive pool does.
- ``return_mask`` is accepted and ignored, as in the reference.
"""
from __future__ import annotations

import torch

from ._util import norm_tuple
from .conv import _conv_padding, pad_spatial, same_pads

_F = torch.nn.functional
_MAX = {1: _F.max_pool1d, 2: _F.max_pool2d, 3: _F.max_pool3d}
_AVG = {1: _F.avg_pool1d, 2: _F.avg_pool2d, 3: _F.avg_pool3d}


def _pool(x, kernel, stride, padding, nsp, data_format, op, ceil_mode=False,
          count_include_pad=True):
    channel_last = data_format[-1] == "C"
    kernel = norm_tuple(kernel, nsp)
    stride = norm_tuple(stride if stride is not None else kernel, nsp)
    pads = _conv_padding(padding, nsp)
    if channel_last:
        x = x.movedim(-1, 1)
    sizes = x.shape[2:]
    if pads == "VALID":
        pads = [(0, 0)] * nsp
    elif pads == "SAME":
        pads = same_pads(sizes, kernel, stride, (1,) * nsp)
    if ceil_mode:
        wide = []
        for (lo, hi), n, k, s in zip(pads, sizes, kernel, stride):
            rem = (n + lo + hi - k) % s
            wide.append((lo, hi + (s - rem if rem else 0)))
        pads = wide
    native = all(lo == hi and 0 <= lo <= k // 2
                 for (lo, hi), k in zip(pads, kernel))
    if op == "max":
        if native:
            out = _MAX[nsp](x, kernel, stride, [lo for lo, _ in pads])
        else:
            out = _MAX[nsp](pad_spatial(x, pads, float("-inf")), kernel,
                            stride)
    elif native:
        out = _AVG[nsp](x, kernel, stride, [lo for lo, _ in pads],
                        count_include_pad=count_include_pad)
    else:
        out = _AVG[nsp](pad_spatial(x, pads), kernel, stride)
        if not count_include_pad:
            # the share of real elements in each window
            ones = torch.ones((1, 1) + tuple(sizes), dtype=x.dtype,
                              device=x.device)
            out = out / _AVG[nsp](pad_spatial(ones, pads), kernel, stride)
    return out.movedim(1, -1) if channel_last else out


def _fmt1d(data_format):
    return "NCW" if data_format in ("NCL", "NCW") else "NWC"


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, _fmt1d(data_format),
                 "max", ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, "max",
                 ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, "max",
                 ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, _fmt1d(data_format),
                 "avg", ceil_mode, count_include_pad=not exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, "avg",
                 ceil_mode, count_include_pad=not exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, "avg",
                 ceil_mode, count_include_pad=not exclusive)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    channel_last = data_format[-1] == "C"
    if channel_last:
        x = x.movedim(-1, 1)
    out = _F.adaptive_avg_pool2d(x, norm_tuple(output_size, 2))
    return out.movedim(1, -1) if channel_last else out


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    oh, ow = norm_tuple(output_size, 2)
    k = (x.shape[2] // oh, x.shape[3] // ow)
    return _F.max_pool2d(x, k, k)


def adaptive_avg_pool1d(x, output_size, name=None):
    o = output_size if isinstance(output_size, int) else output_size[0]
    k = x.shape[-1] // o
    return _F.avg_pool1d(x, k, k)
