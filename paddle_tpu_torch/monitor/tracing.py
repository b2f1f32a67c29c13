"""Request-scoped span tracing (port of paddle_tpu/monitor/tracing.py,
whole): trace/span ids, W3C traceparent propagation, probabilistic head
sampling, chrome-trace export.

Dependency-free (stdlib only): a ``Span`` is a dict-sized object stamped
with the host clock; ending it appends one summary dict to the tracer's
ring and notifies listeners.  Sampling is *head* sampling decided from the
trace_id itself —

    int(trace_id[:8], 16) < FLAGS_trace_sample_rate * 2**32

— so every process that sees the same trace_id (client, server, engine)
independently reaches the same keep/drop decision without coordination.
Unsampled requests cost one shared no-op ``NullSpan``; with
``FLAGS_trace_sample_rate 0`` the tracer is fully disabled.

Context propagates over HTTP via the W3C ``traceparent`` header
(https://www.w3.org/TR/trace-context/):

    00-<32 hex trace_id>-<16 hex parent span_id>-<2 hex flags>

with flag bit 0x01 = sampled.  serving/client.py injects it on every
predict/generate; serving/server.py adopts it so the server-side span
tree joins the caller's trace.  Every timestamp is taken on the host: a
span never waits for the device.
"""
from __future__ import annotations

import collections
import os
import threading
import time

from ..framework import flags as _flags

__all__ = ["Span", "NullSpan", "Tracer", "default_tracer", "reset",
           "format_traceparent", "parse_traceparent", "sample_decision"]

_MAX_EVENTS_PER_SPAN = 512  # per-token decode events stay bounded


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def format_traceparent(trace_id: str, span_id: str, sampled: bool) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def parse_traceparent(header):
    """-> (trace_id, parent_span_id, sampled) or None on any malformed
    input (a bad header must never fail the request it rode in on)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags_hex = parts[:4]
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(version, 16)
        int(trace_id, 16)
        int(span_id, 16)
        flag_bits = int(flags_hex, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, bool(flag_bits & 0x01)


def sample_decision(trace_id: str, rate: float) -> bool:
    """Deterministic head-sampling from the id: every participant that
    derives the decision from the same trace_id agrees."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    try:
        return int(trace_id[:8], 16) < rate * 0x100000000
    except (ValueError, TypeError):
        return False


class Span:
    """One timed operation in a trace.  Context-manager; `child()` for
    sub-operations, `event()` for point-in-time annotations (per-token
    marks), `end()` exactly once (idempotent)."""

    __slots__ = ("_tracer", "trace_id", "span_id", "parent_id", "name",
                 "attrs", "events", "t0_wall", "t0", "dur_ms", "tid",
                 "_ended")

    sampled = True

    def __init__(self, tracer, name, trace_id, parent_id=None, attrs=None):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = _new_id(8)
        self.parent_id = parent_id
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self.events = []          # (name, t_ms offset, attrs-or-None)
        self.t0_wall = time.time()
        self.t0 = time.perf_counter()
        self.dur_ms = 0.0
        self.tid = threading.get_ident()
        self._ended = False

    @property
    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id, True)

    def set_attr(self, key, value):
        self.attrs[key] = value

    def event(self, name, **attrs):
        if len(self.events) < _MAX_EVENTS_PER_SPAN:
            self.events.append(
                (name, (time.perf_counter() - self.t0) * 1e3,
                 attrs or None))
        else:
            self.attrs["events_dropped"] = \
                self.attrs.get("events_dropped", 0) + 1

    def child(self, name, **attrs) -> "Span":
        return Span(self._tracer, name, self.trace_id,
                    parent_id=self.span_id, attrs=attrs or None)

    def end(self, status: str = None):
        if self._ended:
            return
        self._ended = True
        self.dur_ms = (time.perf_counter() - self.t0) * 1e3
        if status is not None:
            self.attrs["status"] = status
        self._tracer._record(self)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end(status="error" if exc_type is not None else None)
        return False


class NullSpan:
    """No-op span with the full Span surface, returned for unsampled
    traces.  Carries the (trace_id, span_id) pair when the trace exists
    but was head-sampled OUT, so the unsampled `traceparent` still
    propagates the consistent drop decision downstream."""

    __slots__ = ("trace_id", "span_id")

    sampled = False
    dur_ms = 0.0

    def __init__(self, trace_id=None, span_id=None):
        self.trace_id = trace_id
        self.span_id = span_id

    @property
    def traceparent(self):
        if self.trace_id is None:
            return None
        return format_traceparent(self.trace_id,
                                  self.span_id or "f" * 16, False)

    def set_attr(self, key, value):
        pass

    def event(self, name, **attrs):
        pass

    def child(self, name, **attrs) -> "NullSpan":
        return self

    def end(self, status: str = None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = NullSpan()


class Tracer:
    """Head-sampling span recorder over a bounded ring of finished
    spans.  Thread-safe: spans start/end on HTTP handler threads, the
    batcher, the decode loop, and the training thread concurrently."""

    def __init__(self, sample_rate: float = None, max_spans: int = None):
        if sample_rate is None:
            sample_rate = float(
                _flags.flag("FLAGS_trace_sample_rate", 0.01) or 0.0)
        if max_spans is None:
            max_spans = int(
                _flags.flag("FLAGS_trace_buffer_spans", 2048) or 2048)
        self.sample_rate = float(sample_rate)
        self.max_spans = max(1, int(max_spans))
        self._spans = collections.deque(maxlen=self.max_spans)
        self._lock = threading.Lock()
        self._listeners = []
        self.spans_finished = 0

    @property
    def enabled(self) -> bool:
        return self.sample_rate > 0.0

    def add_listener(self, fn):
        """fn(span_dict) on every recorded span end (flight recorder)."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def start_span(self, name, *, traceparent=None, parent=None,
                   attrs=None, sampled=None):
        """Root-or-child span entry point.

        `parent=` an in-process Span/NullSpan continues it directly;
        `traceparent=` adopts a remote context (its sampled flag WINS —
        the caller already decided); otherwise a fresh trace is started
        and head-sampled, or forced by `sampled=True` (training fits:
        few per process, always worth recording when tracing is on).
        """
        if not self.enabled:
            return _NULL
        if parent is not None:
            if not parent.sampled:
                return parent if isinstance(parent, NullSpan) else _NULL
            return Span(self, name, parent.trace_id,
                        parent_id=parent.span_id, attrs=attrs)
        ctx = parse_traceparent(traceparent) if traceparent else None
        if ctx is not None:
            trace_id, parent_id, keep = ctx
            if not keep:
                return NullSpan(trace_id, parent_id)
            return Span(self, name, trace_id, parent_id=parent_id,
                        attrs=attrs)
        trace_id = _new_id(16)
        if sampled is None:
            sampled = sample_decision(trace_id, self.sample_rate)
        if not sampled:
            return NullSpan(trace_id, _new_id(8))
        return Span(self, name, trace_id, attrs=attrs)

    # -- recording ---------------------------------------------------------
    def _record(self, span: Span):
        rec = {
            "name": span.name,
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "ts_ms": round(span.t0_wall * 1e3, 3),
            "dur_ms": round(span.dur_ms, 3),
            "tid": span.tid,
            "attrs": span.attrs,
            "events": [
                {"name": n, "t_ms": round(t, 3), **(a or {})}
                for n, t, a in span.events],
        }
        with self._lock:
            self._spans.append(rec)
            self.spans_finished += 1
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(rec)
            except Exception:  # noqa: BLE001 - a broken listener must
                pass           # never fail the traced operation

    # -- queries -----------------------------------------------------------
    def spans(self, trace_id: str = None, limit: int = None) -> list[dict]:
        """Finished spans, oldest first; optionally one trace only."""
        with self._lock:
            out = list(self._spans)
        if trace_id:
            out = [s for s in out if s["trace_id"] == trace_id]
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

    def trace_ids(self) -> list[str]:
        """Distinct trace ids present in the ring, oldest first."""
        seen = []
        for s in self.spans():
            if s["trace_id"] not in seen:
                seen.append(s["trace_id"])
        return seen

    def clear(self):
        with self._lock:
            self._spans.clear()

    def chrome_trace(self, trace_id: str = None) -> dict:
        """Perfetto/chrome://tracing-loadable document: one complete "X"
        event per span (ts/dur in microseconds), one instant "i" event
        per span event."""
        pid = os.getpid()
        events = []
        for s in self.spans(trace_id=trace_id):
            ts_us = s["ts_ms"] * 1e3
            args = dict(s["attrs"])
            args.update({"trace_id": s["trace_id"],
                         "span_id": s["span_id"],
                         "parent_id": s["parent_id"]})
            events.append({"ph": "X", "cat": "paddle", "name": s["name"],
                           "ts": ts_us, "dur": s["dur_ms"] * 1e3,
                           "pid": pid, "tid": s["tid"], "args": args})
            for ev in s["events"]:
                events.append({
                    "ph": "i", "cat": "paddle", "s": "t",
                    "name": f'{s["name"]}/{ev["name"]}',
                    "ts": ts_us + ev["t_ms"] * 1e3,
                    "pid": pid, "tid": s["tid"]})
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "metadata": {"tracer": "paddle_tpu_torch.monitor.tracing",
                             "sample_rate": self.sample_rate}}


_default: Tracer | None = None
_default_lock = threading.Lock()


def default_tracer() -> Tracer:
    """Process-wide tracer, built lazily from FLAGS_trace_sample_rate /
    FLAGS_trace_buffer_spans at first use."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = Tracer()
    return _default


def reset():
    """Drop the process singleton so the next default_tracer() re-reads
    flags (tests)."""
    global _default
    with _default_lock:
        _default = None
