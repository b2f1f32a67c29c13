"""Device placement (port of paddle_tpu/framework/place.py).

The port's entry points run on the card: ``device=None`` resolves to
``cuda`` and raises where CUDA is absent — never a silent CPU fallback.
The CPU is used only when a caller names it (the tests do).
"""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``cuda``; raises RuntimeError when this host has no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions instead")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` -> :func:`default_device`; a named CUDA device is checked
    for availability the same way."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available on this host")
    return dev


def copy_to_device(dst, src):
    """``dst.copy_(src)`` from host data without blocking the host: ``src``
    (a CPU tensor, array or list) is staged in pinned memory and copied on
    the current stream when the stream reaches it.  The staging buffer is
    PyTorch's caching host allocator's, which keeps it until the copy has
    run (one buffer refilled for every copy could be overwritten while an
    earlier copy from it is still queued).  A ``src`` already pinned (the
    DataLoader's reader pins each batch of a fit on the card,
    io.pin_batch) is copied from as it is: ``pin_memory()`` returns a
    pinned tensor itself.  A CPU ``dst`` is filled at once; a CUDA ``src``
    is copied on the device.  Returns ``dst``."""
    src = torch.as_tensor(src, dtype=dst.dtype)
    if dst.device.type == "cuda" and src.device.type == "cpu":
        return dst.copy_(src.pin_memory(), non_blocking=True)
    return dst.copy_(src)
