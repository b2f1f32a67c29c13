"""Softmax cross entropy with hard labels, forward and backward: CUDA
kernels, plain versions, launch counts and the autograd Function that
joins them.

Replaces paddle_tpu/ops/pallas/softmax_xent.py ``_fwd_kernel`` (via
``_fwd_call``) and ``_bwd_kernel`` (via ``_bwd_call``), with ``_sxent``
and its custom_vjp as the autograd Function and ``softmax_xent`` (:172)
as the public entry.  Both kernels are bound by bytes: the forward reads
the [N, V] logits once, the backward reads them once and writes dz once.

- Forward (csrc/softmax_xent.cu ``ptt_softmax_xent_fwd``): one block per
  row (one warp for V < 2048), 16-byte vector reads, a float32 running
  max and sum of exp per thread merged by a block reduction; the label's
  logit is read directly.  Writes loss and lse, float32 [N]; rows with
  the ignore index give loss 0.
- Backward (``ptt_softmax_xent_bwd``): a grid over rows x column chunks,
  dz = (exp(z - lse) - onehot) * g in z's dtype, exact zeros on ignored
  rows.

The logits' leading dims may have any strides that collapse into two
(``logits[:, :-1]`` of the GPT loss does): the kernels address row r at
(r / inner) * so + (r % inner) * si, so such a view is read in place.
Any N and any V (the NSP head's V = 2 included): the reference's -1e30
lane padding and ignore-index row padding were TPU tiling artefacts.
A label outside [0, V) that is not the ignore index picks 0, as the
reference's one-hot select does.

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ...utils import flops
from . import build

_FWD_ARGTYPES = (ctypes.c_void_p,) + (ctypes.c_longlong,) * 4 \
    + (ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
_BWD_ARGTYPES = (ctypes.c_void_p,) + (ctypes.c_longlong,) * 4 \
    + (ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong) \
    + (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_void_p)


def softmax_xent_plain(z, labels, ignore_index=-100):
    """z [..., V] (any strides), labels int [N] over z's N leading
    entries.  Returns (loss, lse), float32 [N]."""
    V = z.shape[-1]
    zf = z.reshape(-1, V).float()
    lse = torch.logsumexp(zf, -1)
    in_range = (labels >= 0) & (labels < V)
    picked = zf.gather(1, labels.clamp(0, V - 1)[:, None])[:, 0]
    picked = torch.where(in_range, picked, 0.0)
    loss = torch.where(labels == ignore_index, 0.0, lse - picked)
    return loss, lse


def softmax_xent_bwd_plain(z, labels, lse, g, ignore_index=-100):
    """dz = (softmax(z) - onehot(labels)) * g, 0 on ignored rows, with z's
    shape and dtype; lse and g float32 [N]."""
    V = z.shape[-1]
    zf = z.reshape(-1, V).float()
    onehot = labels[:, None] == torch.arange(V, device=z.device)
    dz = (torch.exp(zf - lse[:, None]) - onehot.float()) \
        * g.float()[:, None]
    dz = torch.where((labels == ignore_index)[:, None], 0.0, dz)
    return dz.to(z.dtype).reshape(z.shape)


def _rows(z):
    """(z, inner, so, si): row r of z [..., V] starts at element
    (r / inner) * so + (r % inner) * si.  A z whose vocab axis is strided,
    or whose leading dims do not collapse into two strided ones, is
    copied contiguous first."""
    if z.stride(-1) != 1:
        z = z.contiguous()
    dims = []                            # (size, stride), outer first
    for size, stride in zip(z.shape[:-1], z.stride()[:-1]):
        if size == 1:
            continue
        if dims and dims[-1][1] == size * stride:
            dims[-1] = (dims[-1][0] * size, stride)
        else:
            dims.append((size, stride))
    if len(dims) > 2:
        z = z.contiguous()
        dims = [(z.numel() // z.shape[-1], z.shape[-1])]
    if not dims:
        return z, 1, 0, 0
    if len(dims) == 1:
        return z, dims[0][0], 0, dims[0][1]
    return z, dims[1][0], dims[0][1], dims[1][1]


def _check(name, z, labels, *stats):
    n = z.numel() // max(z.shape[-1], 1)
    if labels.shape != (n,) or labels.dtype != torch.int64 \
            or labels.device != z.device or not labels.is_contiguous():
        raise ValueError(f"{name}: labels must be a contiguous int64 [{n}] "
                         f"tensor on {z.device}, got {tuple(labels.shape)} "
                         f"{labels.dtype} on {labels.device}")
    for t in stats:
        if t.shape != (n,) or t.dtype != torch.float32 \
                or t.device != z.device or not t.is_contiguous():
            raise ValueError(f"{name}: lse and g must be contiguous float32 "
                             f"[{n}] tensors on {z.device}")
    if n >= 2 ** 31 or z.shape[-1] >= 2 ** 31:
        raise ValueError(f"{name}: {n} rows of {z.shape[-1]} is too large")


def _device(name, z):
    if z.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for device {z.device}")
    return z.device.type


def softmax_xent_flops(z, labels, *_, **__):
    """The plain version's flops: logsumexp (3 an element, 1 a row) and
    8 a row for the label's range checks, pick and masking."""
    n = labels.numel()
    return 3 * n * z.shape[-1] + 9 * n


@flops.counted(softmax_xent_flops)
def softmax_xent_fwd(z, labels, ignore_index=-100):
    """The forward kernel: z [..., V] float32, bfloat16 or float16
    (leading dims of any strides), labels int64 [N] contiguous.  Returns
    (loss, lse), float32 [N].  No graph: see :func:`softmax_xent`."""
    if _device("softmax_xent", z) == "cpu":
        return softmax_xent_plain(z, labels, ignore_index)
    _check("softmax_xent", z, labels)
    z, inner, so, si = _rows(z)
    n, V = labels.shape[0], z.shape[-1]
    loss = torch.empty(n, dtype=torch.float32, device=z.device)
    lse = torch.empty(n, dtype=torch.float32, device=z.device)
    fn = build.bind("softmax_xent", "ptt_softmax_xent_fwd", _FWD_ARGTYPES)
    err = fn(z.data_ptr(), so, si, inner, n, V, labels.data_ptr(),
             int(ignore_index), loss.data_ptr(), lse.data_ptr(),
             build.dtype_code(z), build.stream_of(z))
    build.check(err, "softmax_xent")
    softmax_xent_fwd.launches += 1
    return loss, lse


def softmax_xent_bwd(z, labels, lse, g, ignore_index=-100):
    """The backward kernel: dz with z's shape (contiguous) and dtype, from
    the forward's lse and the loss's cotangent g (float32 [N])."""
    if _device("softmax_xent_bwd", z) == "cpu":
        return softmax_xent_bwd_plain(z, labels, lse, g, ignore_index)
    _check("softmax_xent_bwd", z, labels, lse, g)
    shape = z.shape
    z, inner, so, si = _rows(z)
    n, V = labels.shape[0], z.shape[-1]
    dz = torch.empty(shape, dtype=z.dtype, device=z.device)
    fn = build.bind("softmax_xent", "ptt_softmax_xent_bwd", _BWD_ARGTYPES)
    err = fn(z.data_ptr(), so, si, inner, n, V, labels.data_ptr(),
             int(ignore_index), lse.data_ptr(), g.data_ptr(), dz.data_ptr(),
             build.dtype_code(z), build.stream_of(z))
    build.check(err, "softmax_xent_bwd")
    softmax_xent_bwd.launches += 1
    return dz


class _SoftmaxXent(torch.autograd.Function):
    """``_sxent`` with its custom_vjp: saves z, the labels and the float32
    lse; the backward runs the backward kernel."""

    @staticmethod
    def forward(ctx, z, labels, ignore_index):
        loss, lse = softmax_xent_fwd(z, labels, ignore_index)
        ctx.save_for_backward(z, labels, lse)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        z, labels, lse = ctx.saved_tensors
        dz = softmax_xent_bwd(z, labels, lse, g.float().contiguous(),
                              ctx.ignore_index)
        return dz, None, None


def softmax_xent(logits, labels, ignore_index=-100):
    """Per-token softmax cross entropy over the last axis: logits [..., V],
    labels int [...] (a trailing size-1 axis is squeezed).  Returns the
    loss with logits' leading shape, in logits' dtype; differentiable in
    the logits."""
    lead = tuple(logits.shape[:-1])
    if labels.dim() == logits.dim():
        labels = labels.squeeze(-1)
    if tuple(labels.shape) != lead:
        raise ValueError(f"softmax_xent: labels {tuple(labels.shape)} vs "
                         f"logits lead {lead}")
    if labels.is_floating_point():
        raise TypeError("softmax_xent: labels must be integer class ids, "
                        f"got {labels.dtype}")
    lab = labels.reshape(-1).to(device=logits.device,
                                dtype=torch.int64).contiguous()
    if lab.numel() == 0:
        return torch.zeros(lead, dtype=logits.dtype, device=logits.device)
    if torch.is_grad_enabled() and logits.requires_grad:
        loss = _SoftmaxXent.apply(logits, lab, int(ignore_index))
    else:
        loss = softmax_xent_fwd(logits, lab, int(ignore_index))[0]
    return loss.reshape(lead).to(logits.dtype)


softmax_xent_fwd.launches = 0
softmax_xent_bwd.launches = 0
