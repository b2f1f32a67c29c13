"""The version and device identity of ``/healthz`` (port of
``runtime_health`` in paddle_tpu/monitor/server.py; the monitor's own HTTP
server is not ported yet, ROADMAP.md A11).

The reference reports ``jax_version``; the port reports ``torch_version``
in its place, with the CUDA card's name and count.
"""
from __future__ import annotations

import os
import threading

__all__ = ["runtime_health"]

_runtime_identity = None
_identity_lock = threading.Lock()


def runtime_health() -> dict:
    """Version/device identity for /healthz — the fields a fleet sweep
    compares to detect version skew.  Device enumeration is cached after
    the first call so scrapes stay cheap, and every field degrades to a
    placeholder rather than failing the health check."""
    global _runtime_identity
    if _runtime_identity is None:
        with _identity_lock:
            if _runtime_identity is None:
                ident = {}
                try:
                    from .. import __version__ as _ver
                    ident["version"] = _ver
                except Exception:  # noqa: BLE001
                    ident["version"] = "unknown"
                try:
                    import torch
                    ident["torch_version"] = torch.__version__
                    n = torch.cuda.device_count() \
                        if torch.cuda.is_available() else 0
                    ident["device_kind"] = torch.cuda.get_device_name(0) \
                        if n else "cpu"
                    ident["device_count"] = n
                except Exception:  # noqa: BLE001 - health must answer
                    ident["torch_version"] = "unavailable"
                    ident["device_kind"] = "unavailable"
                    ident["device_count"] = 0
                _runtime_identity = ident
    out = dict(_runtime_identity)
    out["pid"] = os.getpid()
    return out
