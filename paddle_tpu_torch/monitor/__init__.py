"""paddle_tpu_torch.monitor — request tracing and the runtime identity of
``/healthz`` (port of the parts of paddle_tpu/monitor that serving uses:
``tracing.py`` whole and ``runtime_health``).  ``TrainTelemetry``,
``MonitorServer``, the flight recorder and ``perf`` are not ported yet
(ROADMAP.md A11).
"""
from __future__ import annotations

from . import tracing
from .server import runtime_health
from .tracing import NullSpan, Span, Tracer, default_tracer

__all__ = ["reset", "runtime_health", "Tracer", "Span", "NullSpan",
           "default_tracer", "tracing"]


def reset():
    """Tear down the process singletons (tests): the next
    ``default_tracer()`` re-reads the flags."""
    tracing.reset()
