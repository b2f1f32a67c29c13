"""LayerNorm: forward CUDA kernel, plain versions, launch count, and the
autograd Function whose backward is plain PyTorch.

Replaces paddle_tpu/ops/pallas/layer_norm.py ``_ln_kernel`` (via
``_ln_fwd_call``).  Bound by bytes (one read of x, one write of y);
csrc/layer_norm.cu computes two-pass float32 statistics with any row
count and width, in one of two kernels that its C entry chooses from the
width and alignment alone: one warp a row holding the row in registers as
16-byte vectors (x, y, w, b on 16-byte boundaries, N a multiple of 8 bf16
or 4 float32 and at most 2048 or 1024: every path of the models), or one
block a row with scalar loads (any other case); :func:`variant_launches`
reports which kernel the launches took.  In training it also
writes each row's mean and rstd (float32), the residuals of the backward,
as ``_ln_fwd`` saves them.  The backward (``_ln_bwd``) is closed-form XLA
math in the reference, with no Pallas kernel; here it is the same math in
PyTorch (:func:`layer_norm_bwd_plain`) on both devices.

x is float32, bfloat16 or float16; weight and bias are x's dtype, or
float32 beside 16-bit x (the MLM head's LayerNorm under ``auto_cast``
O1), and y is x's dtype (:func:`weight_dtype_ok`).

A CPU tensor takes the plain forward; a CUDA tensor launches the kernel
or raises — there is no fallback between the two.  :func:`layer_norm`
builds the autograd graph only when grad mode is on and an input requires
grad; serving under ``torch.no_grad()`` launches the kernel without the
statistics.
"""
from __future__ import annotations

import ctypes

import torch

from ...utils import flops
from . import build

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p)
_16BIT = (torch.bfloat16, torch.float16)


def weight_dtype_ok(x, w):
    """Whether the kernels take a weight (or bias) of ``w``'s dtype beside
    x: x's own dtype, or float32 beside 16-bit x (AMP-O1: a float32
    parameter meets a 16-bit activation; the Pallas kernels read it as
    float32 and write x's dtype)."""
    return w.dtype == x.dtype or (w.dtype == torch.float32
                                  and x.dtype in _16BIT)


def _plain_with_stats(x, weight, bias, epsilon):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + epsilon)
    y = (xf - mean) * rstd * weight.float() + bias.float()
    return y.to(x.dtype), mean.reshape(-1), rstd.reshape(-1)


def layer_norm_plain(x, weight, bias, epsilon=1e-5):
    """LN over the last dim in float32, cast back to x's dtype."""
    return _plain_with_stats(x, weight, bias, epsilon)[0]


def layer_norm_bwd_plain(x, weight, mean, rstd, dy):
    """The reference's ``_ln_bwd`` over x, dy [..., N], weight [N] and the
    forward's float32 row statistics [rows].  Returns (dx, dw, db): dx in
    x's dtype, dw and db in the weight's (layer_norm.py:92)."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    dyf = dy.reshape(-1, n).float()
    xhat = (xf - mean[:, None]) * rstd[:, None]
    wdy = dyf * weight.float()
    c1 = wdy.mean(-1, keepdim=True)
    c2 = (wdy * xhat).mean(-1, keepdim=True)
    dx = (wdy - c1 - xhat * c2) * rstd[:, None]
    dw = (dyf * xhat).sum(0)
    db = dyf.sum(0)
    return (dx.reshape(x.shape).to(x.dtype), dw.to(weight.dtype),
            db.to(weight.dtype))


def _flops(x, *_, **__):
    n = x.numel()
    return flops.layer_norm_flops(n, n // max(x.shape[-1], 1))


@flops.counted(_flops)
def _forward(x, weight, bias, epsilon, stats):
    """The kernel (CUDA) or plain version (CPU), no graph.  Returns y, or
    (y, mean, rstd) when ``stats``."""
    if x.device.type == "cpu":
        out = _plain_with_stats(x, weight, bias, epsilon)
        return out if stats else out[0]
    n = x.shape[-1]
    if x.device.type != "cuda":
        raise RuntimeError(f"layer_norm: no kernel for device {x.device}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (n,) or not weight_dtype_ok(x, t) \
                or t.dtype != weight.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"layer_norm: {name} must be a contiguous [{n}] "
                             f"tensor on {x.device} of x's dtype {x.dtype} "
                             "(or float32 beside 16-bit x), as the other "
                             f"one, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if not x.is_contiguous():
        raise ValueError("layer_norm: x must be contiguous")
    rows = x.numel() // max(n, 1)
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = torch.empty(rows, dtype=torch.float32, device=x.device)
        rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    fn = build.bind("layer_norm", "ptt_layer_norm_fwd", _ARGTYPES)
    err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
             mean.data_ptr() if stats else None,
             rstd.data_ptr() if stats else None, rows, n, float(epsilon),
             build.dtype_code(x), build.dtype_code(weight),
             build.stream_of(x))
    build.check(err, "layer_norm")
    layer_norm.launches += 1
    return (y, mean, rstd) if stats else y


class _LayerNorm(torch.autograd.Function):
    """custom_vjp of the reference (``_ln``): the forward saves x, weight
    and the kernel's mean/rstd; the backward is ``_ln_bwd``'s math."""

    @staticmethod
    def forward(ctx, x, weight, bias, epsilon):
        y, mean, rstd = _forward(x, weight, bias, epsilon, stats=True)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd_plain(x, weight, mean, rstd, dy)
        return dx, dw, db, None


def layer_norm(x, weight, bias, epsilon=1e-5):
    """LN over the last dim of x [..., N] with scale/shift [N];
    differentiable."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, epsilon)
    return _forward(x, weight, bias, epsilon, stats=False)


# the C entry chooses between the block-per-row kernel (index 0) and the
# warp-per-row vector kernel (index 1): name -> (library, counting symbol,
# variants)
VARIANTS = ("block", "warp")
VARIANT_COUNTERS = {"layer_norm": ("layer_norm",
                                   "ptt_layer_norm_variant_launches",
                                   VARIANTS)}


def variant_launches():
    """{"layer_norm": {"block": n, "warp": n}}: how many launches took each
    kernel since the library was loaded, as the C entry counted them
    (builds the library if it is not built yet)."""
    return build.variant_counts(VARIANT_COUNTERS)


layer_norm.launches = 0
