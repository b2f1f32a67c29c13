"""check_finite_and_unscale over a list of gradients: the CUDA kernel, its
plain version and its launch count.

Replaces what the reference's dynamic loss scaling computes in XLA:
``GradScaler.unscale_`` (paddle_tpu/amp/__init__.py:127-139: ``g * inv``
and ``jnp.any(~jnp.isfinite(g))`` for each parameter, each flag read back
to the host) and the functional ``check_finite_and_unscale`` (:187-197),
which XLA fuses into the jitted step.  It is no ``pallas_call``.  The
kernel (csrc/amp.cu) is bound by bytes: each element read and written
once.

:func:`check_finite_and_unscale_` multiplies every gradient by the
float32 device word ``inv_scale`` in place, in float32 rounded to the
gradient's dtype, and sets the int32 device word ``found_inf`` to 1 when
an unscaled element is inf or NaN (it never clears it: the caller zeroes
it first).  One launch for each (device, dtype) group of
:data:`~.optimizer.MAX_TENSORS` tensors, with the optimizer kernel's
table of pointers and chunking; no host sync.  Its result is bitwise the
plain version's, ``(g.float() * inv_scale).to(g.dtype)``.  In place where
the reference returns new arrays: the port's gradients are the tensors the
optimizer reads next.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .optimizer import CHUNK, _check_disjoint, chunk_groups

_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@torch.no_grad()
def check_finite_and_unscale_plain(grads, inv_scale, found_inf):
    """Each gradient g becomes ``(g.float() * inv_scale).to(g.dtype)`` in
    place; ``found_inf`` (int32 [1]) becomes 1 where an unscaled element is
    not finite.  Element by element the kernel's arithmetic, in eager
    ops, without a host sync."""
    for g in grads:
        u = (g.float() * inv_scale.to(g.device)).to(g.dtype)
        found_inf.copy_(torch.where(torch.isfinite(u).all().to(
            found_inf.device), found_inf, 1))
        g.copy_(u)
    return found_inf


def _check(grads, inv_scale, found_inf):
    dev = grads[0].device
    for g in grads:
        if g.dtype not in DTYPES or g.device != dev \
                or not g.is_contiguous():
            raise ValueError("check_finite_and_unscale_: gradients must be "
                             "contiguous float32, bfloat16 or float16 "
                             f"tensors on one device, got {g.dtype} on "
                             f"{g.device}")
    for name, t, dtype in (("inv_scale", inv_scale, torch.float32),
                           ("found_inf", found_inf, torch.int32)):
        if t.shape != (1,) or t.dtype != dtype or t.device != dev:
            raise ValueError(f"check_finite_and_unscale_: {name} must be a "
                             f"{dtype} [1] tensor on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def check_finite_and_unscale_(grads, inv_scale, found_inf):
    """Unscale ``grads`` (a list of tensors on one device) in place by the
    float32 [1] tensor ``inv_scale`` and set the int32 [1] tensor
    ``found_inf`` to 1 if an unscaled element is not finite.  On CUDA one
    launch per dtype group (of at most MAX_TENSORS tensors).  Returns
    ``found_inf``."""
    grads = [g for g in grads if g.numel()]
    if not grads:
        return found_inf
    devices = {g.device.type for g in grads}
    if devices - {"cpu", "cuda"} or len({g.device for g in grads}) > 1:
        raise RuntimeError("check_finite_and_unscale_: no kernel for "
                           f"devices {sorted(str(g.device) for g in grads)}")
    _check_disjoint(grads)
    if devices == {"cpu"}:
        return check_finite_and_unscale_plain(grads, inv_scale, found_inf)
    _check(grads, inv_scale, found_inf)
    fn = build.bind("amp", "ptt_check_finite_and_unscale", _ARGTYPES)
    stream = build.stream_of(grads[0])
    for dtype in DTYPES:
        group = [g for g in grads if g.dtype == dtype]
        for idx, chunk0, _ in chunk_groups([g.numel() for g in group],
                                           CHUNK):
            n = len(idx)
            err = fn(build.dtype_code(group[0]), n,
                     (ctypes.c_void_p * n)(*(group[i].data_ptr()
                                             for i in idx)),
                     (ctypes.c_longlong * n)(*(group[i].numel()
                                               for i in idx)),
                     (ctypes.c_int * (n + 1))(*chunk0), CHUNK,
                     inv_scale.data_ptr(), found_inf.data_ptr(), stream)
            build.check(err, "check_finite_and_unscale_")
            check_finite_and_unscale_.launches += 1
    return found_inf


check_finite_and_unscale_.launches = 0
