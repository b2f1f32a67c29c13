"""Crash flight recorder (port of paddle_tpu/monitor/flightrec.py, whole):
a bounded in-memory ring of recent events, dumped as one JSON postmortem
to `FLAGS_telemetry_dir/flightrec-<pid>.json`.

The recorder keeps the last `FLAGS_flightrec_records` discrete events
(pure-python dicts, safe to record from any thread) and writes the dump
atomically on the way down or on request:

  * serving drain      — ServingServer.shutdown records ``drain`` and
                         dumps after the engines stop
  * fleet accounting   — the replica supervisor (serving/fleet.py) dumps
                         ``replica_lost`` with the cumulative ``down_s``
                         at every death and every respawn
  * uncaught crash     — a chained sys.excepthook
  * normal exit        — an atexit fallback, so healthy processes also
                         leave their accounting
  * exit 75 / 86 / 91  — named by the int a signal handler may latch
                         (`latch_exit`) and the atexit fallback reads

Signal discipline: nothing here registers a signal handler and nothing
here may be called FROM one — handlers latch an int (`latch_exit`, a
single assignment) and the dump happens from regular code.

The dump's format is the reference's (version 1): it embeds a goodput
pre-accounting derived from the process-wide metrics registry — wall_s vs
train_s (step-histogram sum) vs compile_s (first-step gauge) vs
ckpt_stall_s — that the reference's `distributed/goodput.py` aggregates.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import socket
import sys
import threading
import time
import traceback

from ..framework import flags as _flags
from ..utils.metrics import default_registry

__all__ = ["FlightRecorder", "configure", "get_recorder", "record",
           "dump", "latch_exit", "install_hooks", "reset"]

DUMP_VERSION = 1

# exit-code → dump reason for the atexit fallback (values mirror
# distributed/resilience.py PREEMPTED/WATCHDOG/DURABILITY exit codes;
# literal ints to keep this module import-light)
_EXIT_REASONS = {75: "preempt", 86: "watchdog", 91: "durability"}


class FlightRecorder:
    """Bounded ring of recent runtime events + one-shot JSON dump."""

    def __init__(self, directory: str = None, max_records: int = None):
        if directory is None:
            directory = str(_flags.flag("FLAGS_telemetry_dir") or "") or "."
        if max_records is None:
            max_records = int(
                _flags.flag("FLAGS_flightrec_records", 512) or 512)
        self.directory = directory
        self._records = collections.deque(maxlen=max(1, int(max_records)))
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._t0_wall = time.time()
        self.dumped_reason = None      # set by the first successful dump
        self.exit_latch = 0            # int mailbox a signal handler MAY
        #                                assign (never read from one)

    # -- recording (any thread; pure-python, lock + deque append) ----------
    def record(self, kind: str, **fields):
        rec = {"ts": round(time.time(), 3), "kind": kind}
        rec.update(fields)
        with self._lock:
            self._records.append(rec)

    def on_span(self, span: dict):
        """Tracer listener: mirror every finished span into the ring."""
        self.record("span", name=span["name"], trace_id=span["trace_id"],
                    span_id=span["span_id"], parent_id=span["parent_id"],
                    dur_ms=span["dur_ms"], attrs=span["attrs"] or {})

    def records(self, kind: str = None) -> list[dict]:
        with self._lock:
            out = list(self._records)
        if kind is not None:
            out = [r for r in out if r["kind"] == kind]
        return out

    def __len__(self):
        return len(self._records)

    # -- accounting for the goodput ledger ---------------------------------
    def accounting(self, snap: dict = None) -> dict:
        if snap is None:
            try:
                snap = default_registry().snapshot()
            except Exception:  # noqa: BLE001 - last-gasp path
                snap = {}

        def hist_s(name):
            v = snap.get(name)
            return float(v["sum"]) / 1e3 if isinstance(v, dict) else 0.0

        def gauge_s(name):
            v = snap.get(name)
            return float(v) / 1e3 if isinstance(v, (int, float)) else 0.0

        return {
            "wall_s": round(time.monotonic() - self._t0, 3),
            "train_s": round(hist_s("paddle_train_step_ms"), 3),
            "compile_s": round(gauge_s("paddle_train_first_step_ms"), 3),
            "ckpt_stall_s": round(hist_s("paddle_ckpt_step_stall_ms"), 3),
        }

    # -- the dump ----------------------------------------------------------
    def dump_path(self) -> str:
        return os.path.join(self.directory, f"flightrec-{os.getpid()}.json")

    def dump(self, reason: str, extra: dict = None) -> str:
        """Write the postmortem atomically (tmp + rename); later dumps
        overwrite earlier ones, so the terminal reason wins."""
        try:
            snap = default_registry().snapshot()
        except Exception:  # noqa: BLE001 - keep the ring even if a
            snap = {}      # computed gauge fn is broken
        doc = {
            "version": DUMP_VERSION,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "reason": reason,
            "ts": round(time.time(), 3),
            "started_at": round(self._t0_wall, 3),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "accounting": self.accounting(snap),
            "metrics": snap,
            "records": self.records(),
        }
        if extra:
            doc.update(extra)
        os.makedirs(self.directory, exist_ok=True)
        path = self.dump_path()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
            f.write("\n")
        os.replace(tmp, path)
        self.dumped_reason = reason
        return path


# -- process singleton + last-gasp hooks -----------------------------------
_recorder: FlightRecorder | None = None
_lock = threading.Lock()
_hooks_installed = False
_prev_excepthook = None
_enrichers: list = []


def add_enricher(fn):
    """Register a crash-dump enricher: ``fn(exc_type, exc)`` returning
    None (not interested) or ``{"reason": str, "extra": dict}`` merged
    into the crash dump (a device-memory census on an out-of-memory
    crash, say).  Enrichers run inside the excepthook's try, on the
    crashing thread.  Idempotent per function."""
    if fn not in _enrichers:
        _enrichers.append(fn)


def configure(directory: str = None, max_records: int = None) \
        -> FlightRecorder:
    """Create (or retarget) the process-wide recorder.  Idempotent:
    called by the fleet supervisor (serving/fleet.py) and by any entry
    point that wants a postmortem; the first caller sizes the ring."""
    global _recorder
    with _lock:
        if _recorder is None:
            _recorder = FlightRecorder(directory=directory,
                                       max_records=max_records)
        elif directory:
            _recorder.directory = directory
        return _recorder


def get_recorder() -> FlightRecorder | None:
    return _recorder


def record(kind: str, **fields):
    """Record into the process recorder; silently a no-op before
    configure() — instrumentation sites never need to guard."""
    r = _recorder
    if r is not None:
        r.record(kind, **fields)


def dump(reason: str, extra: dict = None):
    """Dump the process recorder; returns the path or None.  Never
    raises — this runs on the way down and must not mask the original
    failure."""
    r = _recorder
    if r is None:
        return None
    try:
        return r.dump(reason, extra=extra)
    except Exception:  # noqa: BLE001 - last-gasp path
        return None


def latch_exit(code: int):
    """Async-signal-safe: a single int assignment a signal handler may
    perform so the atexit fallback can name the reason.  Everything
    else (locks, IO, json) happens OUTSIDE handlers."""
    r = _recorder
    if r is not None:
        r.exit_latch = code


def _excepthook(exc_type, exc, tb):
    r = _recorder
    if r is not None and not issubclass(exc_type, SystemExit):
        try:
            frames = traceback.format_exception(exc_type, exc, tb)
            r.record("exception", type=exc_type.__name__,
                     msg=str(exc)[:500])
            reason, extra = "crash", {"exception": {
                "type": exc_type.__name__,
                "msg": str(exc)[:500],
                "traceback": frames[-30:]}}
            for fn in list(_enrichers):
                try:
                    out = fn(exc_type, exc)
                except Exception:  # noqa: BLE001 - enrichment is optional
                    continue
                if out:
                    reason = out.get("reason", reason)
                    extra.update(out.get("extra", {}))
            r.dump(reason, extra=extra)
        except Exception:  # noqa: BLE001 - never mask the real crash
            pass
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def _atexit_dump():
    r = _recorder
    if r is None or r.dumped_reason is not None:
        return
    reason = _EXIT_REASONS.get(r.exit_latch, "exit")
    if reason == "exit" and not len(r):
        return  # recorder configured but nothing ever happened
    try:
        r.dump(reason)
    except Exception:  # noqa: BLE001 - last-gasp path
        pass


def install_hooks():
    """Chain sys.excepthook (uncaught crash) and register the atexit
    fallback (normal exit + sys.exit paths, which excepthook never
    sees).  Idempotent."""
    global _hooks_installed, _prev_excepthook
    with _lock:
        if _hooks_installed:
            return
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
        atexit.register(_atexit_dump)
        _hooks_installed = True


def reset():
    """Drop the process recorder and enrichers (tests).  Installed
    hooks stay but no-op while the recorder is None."""
    global _recorder
    with _lock:
        _recorder = None
        del _enrichers[:]
