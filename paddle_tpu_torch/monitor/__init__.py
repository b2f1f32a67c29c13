"""paddle_tpu_torch.monitor — request tracing, the crash flight recorder
and the runtime identity of ``/healthz`` (port of the parts of
paddle_tpu/monitor that serving uses: ``tracing.py`` and ``flightrec.py``
whole, and ``runtime_health``).  ``TrainTelemetry``, ``MonitorServer`` and
``perf`` are not ported yet (ROADMAP.md A11).
"""
from __future__ import annotations

from . import flightrec, tracing
from .flightrec import FlightRecorder
from .server import runtime_health
from .tracing import NullSpan, Span, Tracer, default_tracer

__all__ = ["reset", "runtime_health", "Tracer", "Span", "NullSpan",
           "default_tracer", "tracing", "FlightRecorder", "flightrec"]


def reset():
    """Tear down the process singletons (tests): the next
    ``default_tracer()`` re-reads the flags; the flight recorder is
    dropped."""
    tracing.reset()
    flightrec.reset()
