"""Decode-path observability for the continuous-batching generation
engine (port of ``GenerationMetrics`` in paddle_tpu/serving/metrics.py:
tokens/s, TTFT and inter-token reservoirs, occupancy, request counters,
prefix-cache hits and misses, prefill chunks, speculative proposals and
their acceptance).

Every number here is taken on the host clock around work the engine has
already synchronised (each decode step ends in a device-to-host copy), so
it is the time a client sees, on whatever device the engine runs.
"""
from __future__ import annotations

import collections
import time

from ..utils.metrics import MetricsRegistry


class GenerationMetrics:
    """Exposes: paddle_genserve_decode_tokens_per_sec, _ttft_p50_ms /
    _p99_ms, _inter_token_p50_ms / _p99_ms, _slot_occupancy,
    _page_occupancy, _tokens_total, _requests_total{result},
    _prefix_cache_hits_total / _misses_total, _prefix_cache_hit_ratio,
    _prefill_chunks_total, _spec_accepted_total / _spec_proposed_total,
    _spec_accept_ratio."""

    WINDOW_S = 60.0
    RESERVOIR = 4096

    def __init__(self, max_slots: int = 1, num_pages: int = 1):
        self.registry = MetricsRegistry()
        self._lock = self.registry._lock
        self.started_at = time.monotonic()
        self.max_slots = max(1, int(max_slots))
        self.num_pages = max(1, int(num_pages))
        reg = self.registry
        reg.gauge("paddle_genserve_decode_tokens_per_sec",
                  "generated tokens per second over the trailing window",
                  fn=self._tps_locked)
        reg.gauge("paddle_genserve_ttft_p50_ms",
                  "time-to-first-token p50 in milliseconds",
                  fn=lambda: self._quantile_locked(self._ttft, 0.50))
        reg.gauge("paddle_genserve_ttft_p99_ms",
                  "time-to-first-token p99 in milliseconds",
                  fn=lambda: self._quantile_locked(self._ttft, 0.99))
        reg.gauge("paddle_genserve_inter_token_p50_ms",
                  "inter-token latency p50 in milliseconds",
                  fn=lambda: self._quantile_locked(self._gaps, 0.50))
        reg.gauge("paddle_genserve_inter_token_p99_ms",
                  "inter-token latency p99 in milliseconds",
                  fn=lambda: self._quantile_locked(self._gaps, 0.99))
        reg.gauge("paddle_genserve_slot_occupancy",
                  "occupied decode slots / max_slots",
                  fn=lambda: self._occupied / self.max_slots)
        reg.gauge("paddle_genserve_page_occupancy",
                  "KV cache pages in use (reserved + prefix-shared) / "
                  "num_pages",
                  fn=lambda: self._pages_in_use / self.num_pages)
        reg.gauge("paddle_genserve_prefix_cache_hit_ratio",
                  "prefix-cache hits / (hits + misses) since start",
                  fn=self._prefix_ratio_locked)
        reg.gauge("paddle_genserve_spec_accept_ratio",
                  "accepted / proposed speculative draft tokens since "
                  "start (greedy lanes only; 0 when not speculating)",
                  fn=self._spec_ratio_locked)
        self._requests = reg.counter(
            "paddle_genserve_requests_total",
            "generation request outcomes by result", label="result",
            preset=("admitted", "retired", "preempted",
                    "rejected_queue_full", "rejected_draining",
                    "rejected_pages_exhausted", "deadline_expired",
                    "cancelled", "errors"),
            fixed=True)
        self._tokens = reg.counter("paddle_genserve_tokens_total",
                                   "generated tokens streamed")
        self._prefix_hits = reg.counter(
            "paddle_genserve_prefix_cache_hits_total",
            "admissions that reused cached prefix pages")
        self._prefix_misses = reg.counter(
            "paddle_genserve_prefix_cache_misses_total",
            "admissions that found no cached prefix")
        self._chunks = reg.counter(
            "paddle_genserve_prefill_chunks_total",
            "prefill chunks streamed into slot pages")
        self._spec_accepted = reg.counter(
            "paddle_genserve_spec_accepted_total",
            "draft proposals the target verification accepted")
        self._spec_proposed = reg.counter(
            "paddle_genserve_spec_proposed_total",
            "draft proposals offered to target verification")
        self._ttft = collections.deque(maxlen=self.RESERVOIR)
        self._gaps = collections.deque(maxlen=self.RESERVOIR)
        self._token_stamps = collections.deque()   # (monotonic, count)
        self._occupied = 0
        self._pages_in_use = 0

    @property
    def counters(self):
        return self._requests.values

    # -- recording hooks (decode thread + submitting threads) --------------
    def count(self, name: str, n: int = 1):
        self._requests.inc(name, n)

    def observe_tokens(self, n: int):
        now = time.monotonic()
        self._tokens.inc(n)
        with self._lock:
            self._token_stamps.append((now, n))
            cutoff = now - self.WINDOW_S
            while self._token_stamps and self._token_stamps[0][0] < cutoff:
                self._token_stamps.popleft()

    def observe_ttft(self, seconds: float):
        with self._lock:
            self._ttft.append(seconds * 1e3)

    def observe_inter_token(self, seconds: float):
        with self._lock:
            self._gaps.append(seconds * 1e3)

    def set_occupancy(self, occupied: int):
        with self._lock:
            self._occupied = int(occupied)

    def set_page_occupancy(self, pages_in_use: int):
        with self._lock:
            self._pages_in_use = int(pages_in_use)

    def count_prefix(self, hit: bool):
        (self._prefix_hits if hit else self._prefix_misses).inc()

    def count_chunk(self, n: int = 1):
        self._chunks.inc(n)

    def observe_spec(self, accepted: int, proposed: int):
        self._spec_accepted.inc(accepted)
        self._spec_proposed.inc(proposed)

    # -- derived values ----------------------------------------------------
    def _prefix_ratio_locked(self):
        hits = self._prefix_hits.value
        total = hits + self._prefix_misses.value
        return hits / total if total else 0.0

    def _spec_ratio_locked(self):
        proposed = self._spec_proposed.value
        return self._spec_accepted.value / proposed if proposed else 0.0

    def _quantile_locked(self, deque_, q: float):
        if not deque_:
            return 0.0
        xs = sorted(deque_)
        return xs[min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))]

    def _tps_locked(self, now=None):
        now = time.monotonic() if now is None else now
        if not self._token_stamps:
            return 0.0
        span = max(1e-9, min(now - self.started_at, self.WINDOW_S))
        live = sum(n for t, n in self._token_stamps
                   if t >= now - self.WINDOW_S)
        return live / span

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "decode_tokens_per_sec": self._tps_locked(),
                "ttft_p50_ms": self._quantile_locked(self._ttft, 0.50),
                "ttft_p99_ms": self._quantile_locked(self._ttft, 0.99),
                "inter_token_p50_ms": self._quantile_locked(self._gaps, 0.50),
                "inter_token_p99_ms": self._quantile_locked(self._gaps, 0.99),
                "slot_occupancy": self._occupied / self.max_slots,
                "page_occupancy": self._pages_in_use / self.num_pages,
                "tokens": self._tokens.value,
                "prefix_cache_hits": self._prefix_hits.value,
                "prefix_cache_misses": self._prefix_misses.value,
                "prefix_cache_hit_ratio": self._prefix_ratio_locked(),
                "spec_accept_ratio": self._spec_ratio_locked(),
                "spec_proposed": self._spec_proposed.value,
                "prefill_chunks": self._chunks.value,
                **dict(sorted(self.counters.items())),
            }

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()
