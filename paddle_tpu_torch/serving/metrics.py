"""Serving observability (port of paddle_tpu/serving/metrics.py, whole:
``ServingMetrics``, ``GenerationMetrics`` and ``RouterMetrics``).

``ServingMetrics`` is the adaptive batcher's catalog (qps, latency
quantiles, batch sizes, queue wait, padding waste, request outcomes and
``compile_count``, which counts the predictor's bucket captures on the
card); ``GenerationMetrics`` the decode path's (tokens/s, TTFT and
inter-token reservoirs, occupancy, request counters, prefix-cache hits and
misses, prefill chunks, speculative proposals and their acceptance);
``RouterMetrics`` the fleet router's (routing decisions by replica and
reason, backpressure, failovers, the retry budget, deadline rejections,
hedges, availability).  Each engine and router keeps a private
``MetricsRegistry`` so several coexist in one process.

Every number here is taken on the host clock around work the engine has
already synchronised (each batch and each decode step ends in a
device-to-host copy), so it is the time a client sees, on whatever device
the engine runs.
"""
from __future__ import annotations

import collections
import time

from ..utils.metrics import Histogram, MetricsRegistry

__all__ = ["Histogram", "ServingMetrics", "GenerationMetrics",
           "RouterMetrics"]


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
    _spec_accept_ratio, _compile_count."""

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
        # the graphs captured at start() (the reference counts the
        # executables it compiles at warmup)
        self.compile_count = 0
        reg.gauge("paddle_genserve_compile_count",
                  "decode-step graphs captured at start() (must not grow "
                  "under traffic)",
                  fn=lambda: self.compile_count)
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

    def set_compile_count(self, n: int):
        with self._lock:
            self.compile_count = int(n)

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
                "compile_count": self.compile_count,
                **dict(sorted(self.counters.items())),
            }

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()


class RouterMetrics:
    """Fleet-router observability (`serving/router.py`): per-replica
    routing decisions, backpressure, and replica health in one private
    registry, exposed first in the router's /metrics.

    Routing reasons (the `reason` label on requests_total):
      prefix_hit       affinity table says this replica owns the
                       prompt's page-aligned prefix
      least_loaded     no affinity — picked the replica with the fewest
                       inflight requests
      health_failover  affinity replica was dead/draining, rerouted

    A 429 from a replica is BACKPRESSURE, not death: it bumps
    `paddle_router_backpressure_total{replica}` and the request retries
    elsewhere, but the replica's health-probe failure count is untouched
    (a loaded replica must not flap in and out of the fleet)."""

    def __init__(self):
        self.registry = MetricsRegistry()
        self._lock = self.registry._lock
        reg = self.registry
        self._requests = reg.counter(
            "paddle_router_requests_total",
            "requests routed, by target replica and routing reason",
            label=("replica", "reason"))
        self._backpressure = reg.counter(
            "paddle_router_backpressure_total",
            "429s absorbed per replica (request retried elsewhere; "
            "not a health-probe failure)", label="replica")
        self._failovers = reg.counter(
            "paddle_router_failovers_total",
            "requests re-dispatched to a survivor, by trigger "
            "(mid_stream = SSE resumed after a replica died under the "
            "stream; dispatch = the initial proxy attempt failed; "
            "hedge = a hedged duplicate was issued)",
            label="reason",
            preset=("mid_stream", "dispatch", "hedge"), fixed=True)
        self._budget_exhausted = reg.counter(
            "paddle_router_retry_budget_exhausted_total",
            "retries suppressed because the retry budget was empty "
            "(the request failed fast with 503 instead of storming a "
            "sick fleet)")
        self._deadline_rejected = reg.counter(
            "paddle_router_deadline_rejected_total",
            "requests rejected at admission because the estimated "
            "queue wait already exceeded their deadline")
        self._hedges = reg.counter(
            "paddle_router_hedges_total",
            "hedged non-streaming dispatches by outcome (won = the "
            "hedge finished first, lost = the primary did)",
            label="outcome", preset=("won", "lost"), fixed=True)
        self._healthy = 0
        self._inflight = 0
        self._epoch = 0
        self._ok = 0
        self._failed = 0
        self._recovery_ms = 0.0
        reg.gauge("paddle_router_replicas_healthy",
                  "replicas currently passing health probes",
                  fn=lambda: self._healthy)
        reg.gauge("paddle_router_inflight",
                  "requests currently being proxied",
                  fn=lambda: self._inflight)
        reg.gauge("paddle_router_membership_epoch",
                  "last fleet-coordinator membership epoch the router "
                  "applied (0 when running from a static replica list)",
                  fn=lambda: self._epoch)
        reg.gauge("paddle_fleet_availability_ratio",
                  "requests that returned a complete answer (failovers "
                  "included) over all finished requests; 1.0 = zero "
                  "client-visible failures",
                  fn=lambda: (self._ok / (self._ok + self._failed)
                              if (self._ok + self._failed) else 1.0))
        reg.gauge("paddle_router_failover_recovery_ms",
                  "last mid-stream failover's loss-to-resumed gap: "
                  "replica death detected under the stream to the "
                  "survivor's connection accepted, milliseconds",
                  fn=lambda: self._recovery_ms)

    def count_routed(self, replica: str, reason: str):
        self._requests.inc((str(replica), str(reason)))

    def count_backpressure(self, replica: str):
        self._backpressure.inc(str(replica))

    def count_failover(self, reason: str):
        self._failovers.inc(str(reason))

    def count_budget_exhausted(self):
        self._budget_exhausted.inc()

    def count_deadline_rejected(self):
        self._deadline_rejected.inc()

    def count_hedge(self, outcome: str):
        self._hedges.inc(str(outcome))

    def count_outcome(self, ok: bool):
        """One finished client request — the availability denominator.
        A failed-over request that eventually completed counts `ok`;
        only client-visible failures (5xx, dead stream) count failed."""
        with self._lock:
            if ok:
                self._ok += 1
            else:
                self._failed += 1

    def set_healthy(self, n: int):
        with self._lock:
            self._healthy = int(n)

    def set_epoch(self, n: int):
        with self._lock:
            self._epoch = int(n)

    def set_recovery_ms(self, ms: float):
        with self._lock:
            self._recovery_ms = round(float(ms), 3)

    def add_inflight(self, delta: int):
        with self._lock:
            self._inflight += int(delta)

    def snapshot(self) -> dict:
        with self._lock:
            denom = self._ok + self._failed
            return {
                "replicas_healthy": self._healthy,
                "inflight": self._inflight,
                "membership_epoch": self._epoch,
                "availability_ratio": (self._ok / denom) if denom else 1.0,
                "requests_ok": self._ok,
                "requests_failed": self._failed,
                "routed": {"|".join(k): v
                           for k, v in sorted(self._requests.values.items())},
                "backpressure": dict(sorted(
                    self._backpressure.values.items())),
                "failovers": dict(sorted(self._failovers.values.items())),
                "retry_budget_exhausted": self._budget_exhausted.value,
                "deadline_rejected": self._deadline_rejected.value,
                "hedges": dict(sorted(self._hedges.values.items())),
                "failover_recovery_ms": self._recovery_ms,
            }

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()
