"""Metrics registry: counters, gauges, histograms, Prometheus text
exposition (the subset of paddle_tpu/utils/metrics.py that GenerationMetrics
and the durable checkpoints use), and the process-wide
:func:`default_registry` the checkpoint counters live in.

Every metric of a registry shares one RLock, so recording threads and a
scraper see a consistent snapshot without per-metric lock ordering.
"""
from __future__ import annotations

import bisect
import collections
import threading


def _fmt(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    return format(float(v), "g")


class Counter:
    """Monotonic counter, unlabeled or with one label key.  ``preset``
    pre-creates series so zero values still render; ``fixed`` renders
    exactly the preset series."""

    kind = "counter"

    def __init__(self, name, help_, lock, label=None, preset=(),
                 fixed=False):
        self.name, self.help, self._lock = name, help_, lock
        self.label, self.fixed = label, fixed
        self.values = collections.Counter({k: 0 for k in preset})
        self._order = list(preset)
        self._preset_len = len(self._order)
        self.value = 0  # unlabeled total

    def inc(self, arg=1, n: int = 1):
        """Unlabeled: ``inc()`` / ``inc(3)``.  Labeled: ``inc("reason")``
        / ``inc("reason", 3)``."""
        with self._lock:
            if self.label is None:
                self.value += int(arg)
                return
            key = str(arg)
            if key not in self.values:
                self._order.append(key)
            self.values[key] += int(n)

    def get(self, key=None) -> int:
        with self._lock:
            return self.value if key is None else self.values[key]

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        if self.label is None:
            return lines + [f"{self.name} {_fmt(self.value)}"]
        keys = self._order[:self._preset_len] if self.fixed else self._order
        return lines + [f'{self.name}{{{self.label}="{k}"}} '
                        f'{_fmt(self.values[k])}' for k in keys]


class Gauge:
    """Instantaneous value: ``set()`` explicitly, or computed at scrape
    time by ``fn`` (called under the registry lock)."""

    kind = "gauge"

    def __init__(self, name, help_, lock, fn=None):
        self.name, self.help, self._lock, self.fn = name, help_, lock, fn
        self.value = 0

    def set(self, v):
        with self._lock:
            self.value = v

    def get(self):
        with self._lock:
            return self.fn() if self.fn is not None else self.value

    def render(self) -> list[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} gauge",
                f"{self.name} {_fmt(self.get())}"]


class Histogram:
    """Cumulative-bucket histogram (Prometheus ``histogram`` type)."""

    kind = "histogram"

    def __init__(self, name, help_, buckets, lock):
        self.name, self.help, self._lock = name, help_, lock
        self.uppers = sorted(float(b) for b in buckets)
        self.counts = [0] * len(self.uppers)  # per bucket, not cumulative
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float):
        with self._lock:
            self.total += 1
            self.sum += value
            i = bisect.bisect_left(self.uppers, value)
            if i < len(self.counts):
                self.counts[i] += 1

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        cum = 0
        for upper, c in zip(self.uppers, self.counts):
            cum += c
            lines.append(f'{self.name}_bucket{{le="{upper:g}"}} {cum}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {self.total}')
        lines.append(f"{self.name}_sum {self.sum:g}")
        lines.append(f"{self.name}_count {self.total}")
        return lines


class MetricsRegistry:
    """Ordered metrics sharing one RLock, rendered as one Prometheus text
    document in registration order."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, object] = {}

    def _get_or_make(self, name, kind, make):
        """The metric registered as ``name``, made by ``make()`` the first
        time; a second registration must ask for the same kind."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = make()
            elif m.kind != kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{m.kind}, re-requested as {kind}")
            return m

    def counter(self, name, help_="", label=None, preset=(),
                fixed=False) -> Counter:
        return self._get_or_make(name, "counter", lambda: Counter(
            name, help_, self._lock, label=label, preset=preset,
            fixed=fixed))

    def gauge(self, name, help_="", fn=None) -> Gauge:
        return self._get_or_make(name, "gauge",
                                 lambda: Gauge(name, help_, self._lock, fn))

    def histogram(self, name, help_="", buckets=(1, 10, 100)) -> Histogram:
        return self._get_or_make(name, "histogram", lambda: Histogram(
            name, help_, buckets, self._lock))

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def prometheus_text(self) -> str:
        with self._lock:
            lines = []
            for m in self._metrics.values():
                lines.extend(m.render())
            return "\n".join(lines) + "\n"


_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry the checkpoint durability counters
    (distributed/checkpoint.py) record into; serving keeps a registry per
    engine."""
    return _default_registry
