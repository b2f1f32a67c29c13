"""Convolution (port of paddle_tpu/nn/functional/__init__.py:263-446:
``_conv_padding``, ``_conv``, conv1d/2d/3d and their ``_transpose``
forms).

The reference lowers every form to one XLA ``conv_general_dilated``: a
transposed conv is a conv over the stride-dilated input with the kernel's
I/O swapped and flipped.  Convolution is an XLA op there, not a Pallas
kernel, so the port calls PyTorch's own ``F.conv*d`` /
``F.conv_transpose*d`` (cuDNN on the card), as it keeps ``torch.matmul``
for the GEMMs.  The weight layouts are the reference's and PyTorch's
alike: [out_c, in_c / groups, *k] for a conv, [in_c, out_c / groups, *k]
for a transposed one.

Padding takes every form of the reference: an int, one int a spatial dim,
2 x nsp ints (before and after each dim), a list of pairs with or without
the batch and channel entries, and ``"SAME"`` / ``"VALID"`` (XLA's rules:
``SAME`` puts the odd element of padding after).  PyTorch pads
symmetrically only, so an asymmetric pad is an explicit ``F.pad`` first
(negative entries crop, as XLA's do).  A transposed conv with a pad PyTorch
cannot express is the full transposed conv, then cropped (or padded with
zeros) to the reference's extent.  NHWC (``data_format`` ending in "C")
moves the channel axis to 1 and back.
"""
from __future__ import annotations

import numpy as np
import torch

from ._util import _check_dim, norm_tuple

_F = torch.nn.functional
_CONV = {1: _F.conv1d, 2: _F.conv2d, 3: _F.conv3d}
_CONV_T = {1: _F.conv_transpose1d, 2: _F.conv_transpose2d,
           3: _F.conv_transpose3d}


def _conv_padding(padding, nsp):
    """The reference's padding forms -> ``"SAME"``, ``"VALID"`` or a list
    of nsp (before, after) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (int, np.integer)):
        return [(int(padding), int(padding))] * nsp
    padding = list(padding)
    if all(isinstance(p, (list, tuple)) for p in padding):
        pairs = [(int(p[0]), int(p[1])) for p in padding]
        if len(pairs) == nsp + 2:
            pairs = pairs[2:]
        return pairs
    if len(padding) == nsp:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * nsp:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(nsp)]
    raise ValueError(f"bad padding {padding}")


def same_pads(sizes, kernel, stride, dilation):
    """XLA's ``SAME``: output ceil(in / stride), the odd element of the
    total pad after."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, stride, dilation):
        k_eff = d * (k - 1) + 1
        total = max((-(-n // s) - 1) * s + k_eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_spatial(x, pairs, value=0.0):
    """``x`` [N, C, *sp] padded (or, for negative entries, cropped) by the
    (before, after) pair of each spatial dim."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    if not any(flat):
        return x
    return _F.pad(x, flat, value=value)


def _transpose(x, w, b, stride, pads, output_padding, dilation, groups,
               nsp):
    k = w.shape[2:]
    if isinstance(pads, str):
        # XLA's string pads of the dilated-input form, which XLA takes at
        # stride 1 only: SAME keeps the input's extent, VALID crops
        # k_eff - 1 each side
        if any(s != 1 for s in stride):
            raise ValueError(
                f"string padding {pads!r} is not implemented for a "
                f"transposed convolution of stride {stride} (as in the "
                "reference): give the padding as numbers")
        pairs = []
        for kk, d in zip(k, dilation):
            e = d * (kk - 1)
            pairs.append((e - e // 2, e // 2) if pads == "SAME" else (e, e))
        op = (0,) * nsp
    else:
        pairs, op = pads, norm_tuple(output_padding, nsp)
    sym = all(lo == hi >= 0 for lo, hi in pairs) and all(
        0 <= o < max(s, d) for o, s, d in zip(op, stride, dilation))
    if sym:
        return _CONV_T[nsp](x, w, b, stride, [lo for lo, _ in pairs], op,
                            groups, dilation)
    full = _CONV_T[nsp](x, w, None, stride, 0, 0, groups, dilation)
    out = pad_spatial(full, [(-lo, o - hi) for (lo, hi), o in zip(pairs,
                                                                  op)])
    # the padded or cropped form adds the bias after the pad (a padded
    # border holds the bias too)
    return out if b is None else out + b.reshape((1, -1) + (1,) * nsp)


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format,
          nsp, transpose=False, output_padding=0):
    """The six conv entries (the reference's ``_conv``): x in NC* or N*C,
    weight in the reference's layout; under ``amp.auto_cast`` x and the
    weight are cast to the AMP dtype (a matmul-like op of the white list,
    as the reference's ``white_cast``), the bias to the output's."""
    from ...amp import white_cast

    channel_last = data_format[-1] == "C"
    want = weight.shape[0] if transpose else weight.shape[1] * groups
    _check_dim(x.shape[-1 if channel_last else 1], want,
               f"conv{nsp}d{'_transpose' if transpose else ''}",
               f"input channels ({data_format}) vs weight layout")
    stride = norm_tuple(stride, nsp)
    dilation = norm_tuple(dilation, nsp)
    pads = _conv_padding(padding, nsp)
    x, w = white_cast(x, weight)
    b = None if bias is None else bias.to(x.dtype)
    if channel_last:
        x = x.movedim(-1, 1)
    if transpose:
        out = _transpose(x, w, b, stride, pads, output_padding, dilation,
                         groups, nsp)
    else:
        if pads == "VALID":
            pads = [(0, 0)] * nsp
        elif pads == "SAME":
            pads = same_pads(x.shape[2:], w.shape[2:], stride, dilation)
        if all(lo == hi >= 0 for lo, hi in pads):
            out = _CONV[nsp](x, w, b, stride, [lo for lo, _ in pads],
                             dilation, groups)
        else:
            out = _CONV[nsp](pad_spatial(x, pads), w, b, stride, 0,
                             dilation, groups)
    return out.movedim(1, -1) if channel_last else out


def _fmt1d(data_format):
    return "NCW" if data_format in ("NCL", "NCW") else "NWC"


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 _fmt1d(data_format), 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3)


def _transpose_output_padding(x, weight, stride, padding, dilation,
                              output_size, nsp, data_format):
    """A requested ``output_size`` -> per-dim output_padding (out = (in -
    1) * s - 2 * p + d * (k - 1) + 1 + output_padding), as the
    reference's."""
    sizes = ([output_size] * nsp if isinstance(output_size, int)
             else list(output_size))
    channel_last = data_format[-1] == "C"
    in_sp = list(x.shape[1:1 + nsp] if channel_last else x.shape[2:2 + nsp])
    k_sp = list(weight.shape[-nsp:])
    s, p, d = (norm_tuple(v, nsp) for v in (stride, padding, dilation))
    out_pad = []
    for i in range(nsp):
        base = (in_sp[i] - 1) * s[i] - 2 * p[i] + d[i] * (k_sp[i] - 1) + 1
        op_i = int(sizes[i]) - base
        if not 0 <= op_i < s[i] + 1:
            raise ValueError(
                f"output_size[{i}]={sizes[i]} unreachable: base deconv "
                f"size is {base}, output_padding must be in [0, {s[i]}]")
        out_pad.append(op_i)
    return out_pad


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 _fmt1d(data_format), 1, transpose=True,
                 output_padding=output_padding)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW", name=None):
    if output_size is not None:
        output_padding = _transpose_output_padding(
            x, weight, stride, padding, dilation, output_size, 2,
            data_format)
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2, transpose=True,
                 output_padding=output_padding)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCDHW", name=None):
    if output_size is not None:
        output_padding = _transpose_output_padding(
            x, weight, stride, padding, dilation, output_size, 3,
            data_format)
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3, transpose=True,
                 output_padding=output_padding)
