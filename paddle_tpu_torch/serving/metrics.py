"""Serving observability (port of paddle_tpu/serving/metrics.py's
``ServingMetrics`` and ``GenerationMetrics``; ``RouterMetrics`` comes with
the router, ROADMAP.md A6(b)).

``ServingMetrics`` is the adaptive batcher's catalog (qps, latency
quantiles, batch sizes, queue wait, padding waste, request outcomes and
``compile_count``, which counts the predictor's bucket captures on the
card); ``GenerationMetrics`` the decode path's (tokens/s, TTFT and
inter-token reservoirs, occupancy, request counters, prefix-cache hits and
misses, prefill chunks, speculative proposals and their acceptance).  Each
engine keeps a private ``MetricsRegistry`` so several coexist in one
process.

Every number here is taken on the host clock around work the engine has
already synchronised (each batch and each decode step ends in a
device-to-host copy), so it is the time a client sees, on whatever device
the engine runs.
"""
from __future__ import annotations

import collections
import time

from ..utils.metrics import Histogram, MetricsRegistry

__all__ = ["Histogram", "ServingMetrics", "GenerationMetrics"]


class ServingMetrics:
    """All engine/server observability state, rendered as Prometheus text.

    Exposes:
      paddle_serving_qps                    completions/s over the window
      paddle_serving_p50_ms / _p99_ms       request latency order stats
      paddle_serving_batch_size             batch-size histogram
      paddle_serving_queue_latency_ms       submit→dispatch wait histogram
      paddle_serving_padding_waste_ratio    padded slots / total slots
      paddle_serving_requests_total{...}    accepted/rejected/… counters
      paddle_serving_compile_count          predictor bucket captures
    """

    QPS_WINDOW_S = 60.0
    RESERVOIR = 4096

    def __init__(self):
        self.registry = MetricsRegistry()
        # the registry's RLock is THE lock (one lock for batcher thread,
        # N HTTP handler threads, and the /metrics scraper); computed
        # gauges run under it at scrape time, hence the *_locked helpers
        self._lock = self.registry._lock
        self.started_at = time.monotonic()
        reg = self.registry
        reg.gauge("paddle_serving_qps",
                  "completed requests per second over the trailing window",
                  fn=self._qps_locked)
        reg.gauge("paddle_serving_p50_ms",
                  "request latency p50 in milliseconds",
                  fn=lambda: self._quantile_locked(0.50))
        reg.gauge("paddle_serving_p99_ms",
                  "request latency p99 in milliseconds",
                  fn=lambda: self._quantile_locked(0.99))
        reg.gauge("paddle_serving_padding_waste_ratio",
                  "padded input elements / dispatched input elements "
                  "(batch-slot AND sequence padding)",
                  fn=self._waste_locked)
        reg.gauge("paddle_serving_compile_count",
                  "predictor shape-bucket compilations since start",
                  fn=lambda: self.compile_count)
        self._requests = reg.counter(
            "paddle_serving_requests_total",
            "request outcomes by result", label="result",
            preset=("accepted", "responses", "rejected_queue_full",
                    "rejected_draining", "deadline_expired", "cancelled",
                    "errors"),
            fixed=True)
        self.batch_size_hist = reg.histogram(
            "paddle_serving_batch_size",
            "requests coalesced per dispatched batch",
            [1, 2, 4, 8, 16, 32, 64, 128])
        self.queue_latency_hist = reg.histogram(
            "paddle_serving_queue_latency_ms",
            "milliseconds a request waited in the batch queue",
            [0.5, 1, 2, 5, 10, 20, 50, 100, 250, 500, 1000, 5000])
        self.request_latency_hist = reg.histogram(
            "paddle_serving_request_latency_ms",
            "end-to-end request latency in milliseconds",
            [1, 2, 5, 10, 20, 50, 100, 250, 500, 1000, 5000])
        self._latencies = collections.deque(maxlen=self.RESERVOIR)
        self._completions = collections.deque()  # monotonic stamps
        self.batch_slots_total = 0
        self.padded_slots_total = 0
        self.compile_count = 0

    @property
    def counters(self):
        """The request-outcome counts, dict-like."""
        return self._requests.values

    # -- recording hooks (engine/server threads) ---------------------------
    def count(self, name: str, n: int = 1):
        self._requests.inc(name, n)

    def observe_batch(self, n_requests: int, bucket_batch: int,
                      real_elems: int = None, total_elems: int = None):
        """Waste is counted in input ELEMENTS when provided (covers both
        batch-slot padding and sequence padding); falls back to
        slot-level accounting otherwise."""
        if total_elems is None:
            real_elems, total_elems = n_requests, bucket_batch
        with self._lock:
            self.batch_size_hist.observe(n_requests)
            self.batch_slots_total += total_elems
            self.padded_slots_total += total_elems - real_elems

    def observe_queue_wait(self, seconds: float):
        self.queue_latency_hist.observe(seconds * 1e3)

    def observe_completion(self, latency_s: float):
        now = time.monotonic()
        with self._lock:
            self._requests.inc("responses")
            self.request_latency_hist.observe(latency_s * 1e3)
            self._latencies.append(latency_s * 1e3)
            self._completions.append(now)
            cutoff = now - self.QPS_WINDOW_S
            while self._completions and self._completions[0] < cutoff:
                self._completions.popleft()

    def set_compile_count(self, n: int):
        with self._lock:
            self.compile_count = int(n)

    # -- derived values ----------------------------------------------------
    def _quantile_locked(self, q: float):
        if not self._latencies:
            return 0.0
        xs = sorted(self._latencies)
        idx = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
        return xs[idx]

    def _qps_locked(self, now=None):
        now = time.monotonic() if now is None else now
        if not self._completions:
            return 0.0
        span = max(1e-9, min(now - self.started_at, self.QPS_WINDOW_S))
        live = sum(1 for t in self._completions
                   if t >= now - self.QPS_WINDOW_S)
        return live / span

    def _waste_locked(self):
        return (self.padded_slots_total / self.batch_slots_total
                if self.batch_slots_total else 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "qps": round(self._qps_locked(), 2),
                "p50_ms": round(self._quantile_locked(0.50), 3),
                "p99_ms": round(self._quantile_locked(0.99), 3),
                "padding_waste_ratio": round(self._waste_locked(), 4),
                "batches": self.batch_size_hist.total,
                "mean_batch_size": round(
                    self.batch_size_hist.sum / self.batch_size_hist.total, 2)
                    if self.batch_size_hist.total else 0.0,
                "compile_count": self.compile_count,
                **{k: v for k, v in sorted(self.counters.items())},
            }

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()


class GenerationMetrics:
    """Decode-path observability.  Exposes: paddle_genserve_decode_tokens_per_sec, _ttft_p50_ms /
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
