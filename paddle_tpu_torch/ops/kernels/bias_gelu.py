"""Fused bias + exact-erf GeLU, forward and backward: CUDA kernels, plain
versions, launch counts and the autograd Function that joins them.

Replaces paddle_tpu/ops/pallas/bias_gelu.py ``_fwd_kernel`` and
``_bwd_kernel`` (via ``_row_call``; ``_bg_fwd``/``_bg_bwd`` are the
custom_vjp).  Both are bound by bytes: the forward reads x and writes y,
the backward reads x and dy and writes dx, once per element.  The kernels
(csrc/bias_gelu.cu) do the add, the erf and the derivative in float32,
for any row count; the backward recomputes u = x + b from the saved input
instead of saving u.  Each C entry, forward and backward, picks one of two
kernels from the width and the alignment alone (:func:`variant_launches`
reports which): ``vec`` (every operand on a 16-byte boundary and F a
multiple of one 16-byte vector: every path of the models) indexes by
(row, 16-byte column vector), loads its bias vector once and keeps
several rows' loads in flight (the backward 8; the forward 8, 4, 2 or 1,
the most that still gives two blocks a SM, so a decode step's R = 8 is
spread over 48 blocks); ``scalar``, the grid-stride loop, takes any other
width or alignment.  db
is dx's row-sum accumulated in float32 inside one torch reduction, with no
float32 copy of dx, as the reference leaves it to XLA
(``jnp.sum(dx.astype(jnp.float32), axis=0)``, where the convert fuses into
the reduction).

x and dy are float32, bfloat16 or float16; the bias is x's dtype, or
float32 beside 16-bit x (AMP-O1: the FFN's 16-bit matmul output beside its
float32 bias, added in float32 as bias_gelu.py:42 adds it); y and dx are
x's dtype, db the bias's (``sum(dx.astype(f32)).astype(b.dtype)``,
:87).

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
or raises.  :func:`bias_gelu` builds the autograd graph only when grad
mode is on and an input requires grad; serving under ``torch.no_grad()``
calls the forward kernel directly.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...utils import flops
from . import build
from .layer_norm import weight_dtype_ok

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_FWD_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_void_p)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p)


def bias_gelu_plain(x, bias):
    """gelu_erf(x + bias) in float32, cast back to x's dtype."""
    u = x.float() + bias.float()
    return (0.5 * u * (1.0 + torch.erf(u * _INV_SQRT2))).to(x.dtype)


def bias_gelu_bwd_plain(x, bias, dy):
    """dy * gelu'(x + bias) in float32, cast back to x's dtype."""
    u = x.float() + bias.float()
    cdf = 0.5 * (1.0 + torch.erf(u * _INV_SQRT2))
    pdf = torch.exp(-0.5 * u * u) * _INV_SQRT_2PI
    return (dy.float() * (cdf + u * pdf)).to(x.dtype)


def _check(name, x, bias, *others):
    n = x.shape[-1]
    if bias.shape != (n,) or not weight_dtype_ok(x, bias) \
            or bias.device != x.device or not bias.is_contiguous():
        raise ValueError(f"{name}: bias must be a contiguous [{n}] tensor "
                         f"on {x.device} of x's dtype {x.dtype} (or float32 "
                         f"beside 16-bit x), got {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}")
    for t in (x, *others):
        if t.shape != x.shape or t.dtype != x.dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: x and dy must be contiguous "
                             f"{tuple(x.shape)} {x.dtype} tensors on "
                             f"{x.device}")


def bias_gelu_flops(x, *_, **__):
    """The plain version's flops: the bias add, the scaling of erf's
    argument, 1 + erf, the halving and the product (erf: 0)."""
    return 5 * x.numel()


@flops.counted(bias_gelu_flops)
def _forward(x, bias):
    """The forward kernel (CUDA) or plain version (CPU), no graph."""
    if x.device.type == "cpu":
        return bias_gelu_plain(x, bias)
    if x.device.type != "cuda":
        raise RuntimeError(f"bias_gelu: no kernel for device {x.device}")
    _check("bias_gelu", x, bias)
    y = torch.empty_like(x)
    fn = build.bind("bias_gelu", "ptt_bias_gelu_fwd", _FWD_ARGTYPES)
    err = fn(x.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel(),
             x.shape[-1], build.dtype_code(x), build.dtype_code(bias),
             build.stream_of(x))
    build.check(err, "bias_gelu")
    bias_gelu.launches += 1
    return y


def bias_gelu_bwd(x, bias, dy):
    """dx = dy * gelu'(x + bias) over x, dy [..., F] with bias [F]."""
    if x.device.type == "cpu":
        return bias_gelu_bwd_plain(x, bias, dy)
    if x.device.type != "cuda":
        raise RuntimeError(f"bias_gelu_bwd: no kernel for device {x.device}")
    _check("bias_gelu_bwd", x, bias, dy)
    dx = torch.empty_like(x)
    fn = build.bind("bias_gelu", "ptt_bias_gelu_bwd", _BWD_ARGTYPES)
    err = fn(x.data_ptr(), bias.data_ptr(), dy.data_ptr(), dx.data_ptr(),
             x.numel(), x.shape[-1], build.dtype_code(x),
             build.dtype_code(bias), build.stream_of(x))
    build.check(err, "bias_gelu_bwd")
    bias_gelu_bwd.launches += 1
    return dx


class _BiasGelu(torch.autograd.Function):
    """custom_vjp of the reference (``_bg``): saves x and bias; the
    backward runs the backward kernel, and db = sum(dx) in float32."""

    @staticmethod
    def forward(ctx, x, bias):
        ctx.save_for_backward(x, bias)
        return _forward(x, bias)

    @staticmethod
    def backward(ctx, dy):
        x, bias = ctx.saved_tensors
        dx = bias_gelu_bwd(x, bias, dy.contiguous())
        db = None
        if ctx.needs_input_grad[1]:
            db = bias_gelu_db(dx).to(bias.dtype)
        return dx, db


def bias_gelu_db(dx):
    """db = dx's sum over every row [..., F] -> [F], accumulated in float32
    by one reduction that reads dx as it is (no float32 copy of dx)."""
    return dx.reshape(-1, dx.shape[-1]).sum(0, dtype=torch.float32)


def bias_gelu(x, bias):
    """gelu(x + bias) over x [..., F] with bias [F]; differentiable."""
    if torch.is_grad_enabled() and (x.requires_grad or bias.requires_grad):
        return _BiasGelu.apply(x, bias)
    return _forward(x, bias)


bias_gelu.launches = 0
bias_gelu_bwd.launches = 0


# the C entries of the forward and the backward choose between the scalar
# grid-stride kernel (index 0) and the 16-byte vector kernel (index 1):
# name -> (library, counting symbol)
VARIANTS = ("scalar", "vec")
VARIANT_COUNTERS = {
    "bias_gelu": ("bias_gelu", "ptt_bias_gelu_fwd_variant_launches"),
    "bias_gelu_bwd": ("bias_gelu", "ptt_bias_gelu_bwd_variant_launches")}


def variant_launches():
    """{"bias_gelu": {"scalar": n, "vec": n}, "bias_gelu_bwd": {...}}: how
    many forward and backward launches took each kernel since the library
    was loaded, as the C entries counted them (builds the library if it is
    not built yet)."""
    return build.variant_counts(VARIANT_COUNTERS, VARIANTS)
