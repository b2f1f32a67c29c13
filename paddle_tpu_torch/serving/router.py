"""Prefix-cache-aware, fault-tolerant fleet router over N replicas (port of
paddle_tpu/serving/router.py, whole).

One standard-library HTTP endpoint in front of N `ServingServer` replicas,
each running its own `GenerationEngine` (own page pool, own prefix cache,
on the card its own CUDA context).  The router touches no device: it
decides where a request goes and relays bytes.  Blind round-robin would
send two requests sharing a long system prompt to different replicas, and
BOTH would pay the full prefill; this router makes the placement decision
cache-topology-aware:

  prefix_hit       the prompt's page-aligned prefix (the exact region
                   `PrefixCache` would share) hashes to an affinity entry —
                   route to the replica whose prefix cache already owns
                   those KV pages, so the replica-side lookup hits and
                   prefill skips the shared pages
  least_loaded     no affinity yet — route to the replica with the
                   fewest router-side inflight requests, then remember
                   the prefix → replica binding for the next caller
  health_failover  the affinity replica is dead (>= `dead_after`
                   consecutive /healthz probe failures) — re-route to
                   the least-loaded live replica and REBIND the prefix
                   (its pages are gone with the replica; stickiness to a
                   corpse would re-miss forever)

Fault tolerance:

  * elastic membership — given ``coord=host:port`` (the serving
    supervisor's PodCoordinator, distributed/podcoord.py), the router
    subscribes to membership epochs: a dead rank is evicted on the EPOCH
    DELTA, faster than `dead_after` failed probes, and a
    supervisor-respawned rank rejoins (fresh URL from the coordinator KV)
    without a router restart.
  * mid-stream failover — every streaming /generate is journaled
    (original payload + tokens relayed so far).  When the upstream dies
    mid-stream the request is re-admitted on a survivor with the emitted
    prefix appended to the prompt and ``resume_pos`` set, so the SSE
    stream continues at the next token: greedy output is the
    uninterrupted run's (bitwise where the replica's prefill and decode
    steps agree bitwise, as on the CPU), sampled output resumes on the
    same per-request generator chain.
  * retry budget — retries (dispatch failovers, mid-stream resumes)
    spend from a token bucket refilled by successful traffic
    (`FLAGS_router_retry_budget_ratio` per success, floor
    `FLAGS_router_retry_budget_min`); an empty budget degrades to a
    fast 503 instead of a retry storm against a sick fleet.
  * circuit breaker — `FLAGS_router_breaker_threshold` consecutive
    REQUEST failures stop dispatch to a replica before the probe loop
    catches up; after `FLAGS_router_breaker_cooldown_s` one trial
    request may re-probe it.
  * deadline-aware admission — a request whose `deadline_ms` is already
    smaller than the estimated queue wait on the chosen replica is
    rejected 504 at the router (no doomed dispatch).
  * hedged dispatch — non-streaming requests are duplicated to a second
    replica once the first has been outstanding max(observed p99,
    `FLAGS_router_hedge_floor_ms`); first answer wins.  Off by default.

Backpressure is not death: a replica answering 429 (generation queue
full) is healthy-but-loaded.  The router counts it
(`paddle_router_backpressure_total{replica}`), retries the request on
the remaining live replicas WITHOUT spending retry budget, and does not
touch the health-probe failure count — a replica must never flap out of
the fleet just for being busy (the flap would dump its whole
prefix-cache working set).  Probe flap damping works the other way too:
a replica marked dead needs `FLAGS_router_healthy_after` CONSECUTIVE
probe successes before it takes traffic again, and probe start times
are staggered across replicas so a fleet restart is not a thundering
herd of simultaneous probes.

Tracing: the incoming W3C `traceparent` (or a fresh head-sampled root)
becomes a `router.generate` child span whose context is forwarded to
the replica, so client → router → replica server.generate →
gen.prefill/gen.decode is ONE trace across the hop.

`/metrics` federation: the router serves its own `RouterMetrics`
registry followed by every live replica's scrape under a
`# replica=<name> <url>` banner — one scrape shows fleet routing counters
AND per-replica genserve gauges.

Shutdown mirrors the server's latch-drain contract: SIGTERM stops new
admissions (healthz flips to draining), inflight proxied requests
finish, then the listener closes and "router drain clean" is logged.
"""
from __future__ import annotations

import collections
import hashlib
import http.client
import json
import logging
import queue as _queue
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..distributed.resilience import PreemptionGuard
from ..framework import flags as _flags
from ..monitor import tracing as _tracing
from .metrics import RouterMetrics

logger = logging.getLogger("paddle_tpu_torch.serving.router")

__all__ = ["FleetRouter", "Replica", "RetryBudget"]


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128


class RetryBudget:
    """Token bucket capping retries at a fraction of successful traffic.

    Each successful request deposits `ratio` tokens (so a healthy fleet
    earns the right to absorb failures); each retry withdraws one whole
    token.  The bucket starts at — and is floored against growing past
    `cap` — so a cold router can still fail over, but a fleet that is
    ONLY failing drains the bucket and every further request fails fast
    with 503 instead of multiplying load: the retry-storm breaker the
    reference got from brpc's `max_retry` + backup-request budget."""

    def __init__(self, ratio: float, min_budget: float, cap: float = 100.0):
        self.ratio = float(ratio)
        self.min = float(min_budget)
        self.cap = max(float(cap), self.min)
        self.balance = self.min
        self._lock = threading.Lock()

    def deposit(self):
        with self._lock:
            self.balance = min(self.balance + self.ratio, self.cap)

    def withdraw(self) -> bool:
        """Take one retry token; False = budget exhausted, do not retry."""
        with self._lock:
            if self.balance >= 1.0:
                self.balance -= 1.0
                return True
            return False


class Replica:
    """Router-side view of one generation server: health-probe state,
    circuit-breaker state + inflight accounting.  All mutation happens
    under the router lock."""

    def __init__(self, name: str, url: str):
        self.name = name
        self.url = url.rstrip("/")
        self.inflight = 0
        self.fails = 0          # consecutive /healthz probe failures
        self.succs = 0          # consecutive probe successes while dead
        self.alive = True       # optimistic until probes say otherwise
        self.draining = False
        self.brk_fails = 0      # consecutive REQUEST failures (breaker)
        self.brk_until = 0.0    # breaker holds dispatch until this time

    def reset_fresh(self, url: str = None):
        """A brand-new process answers at this slot (supervisor respawn
        observed via the membership channel): forget the corpse's
        probe/breaker history."""
        if url is not None:
            self.url = url.rstrip("/")
        self.fails = self.succs = self.brk_fails = 0
        self.brk_until = 0.0
        self.alive = True
        self.draining = False

    def snapshot(self) -> dict:
        return {"name": self.name, "url": self.url,
                "alive": self.alive, "draining": self.draining,
                "inflight": self.inflight, "probe_fails": self.fails,
                "breaker_fails": self.brk_fails}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _send(self, code: int, body: bytes, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if code in (429, 503):
            self.send_header("Retry-After", "1")
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode())

    def do_GET(self):  # noqa: N802 - http.server API
        router = self.server.owner
        if self.path == "/healthz":
            body = {"status": "draining" if router.draining else "ok",
                    "replicas": [r.snapshot() for r in router.replicas],
                    "uptime_s": router.uptime_s}
            self._send_json(503 if router.draining else 200, body)
        elif self.path == "/metrics":
            self._send(200, router.federated_metrics().encode(),
                       ctype="text/plain; version=0.0.4")
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802 - http.server API
        router = self.server.owner
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n)
        if self.path not in ("/generate", "/predict"):
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        if router.draining:
            self._send_json(503, {"error": "router draining"})
            return
        tracer = _tracing.default_tracer()
        span = tracer.start_span("router.generate",
                                 traceparent=self.headers.get("traceparent"))
        try:
            if self.path == "/predict":
                router._route_predict(self, raw, span)
            else:
                router._route_generate(self, raw, span)
        finally:
            span.end()

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug("%s - %s", self.address_string(), fmt % args)


class FleetRouter:
    """N generation replicas behind one endpoint with prefix-affinity,
    least-loaded fallback, health/epoch failover, journaled mid-stream
    resume, retry budgets, circuit breakers and SSE pass-through."""

    def __init__(self, replica_urls, host="127.0.0.1", port=0, *,
                 page_size=None, probe_interval_s=None, dead_after=None,
                 request_timeout_s=120.0, install_signal_handlers=True,
                 drain_timeout_s=30.0, coord=None, healthy_after=None,
                 retry_budget_ratio=None, retry_budget_min=None,
                 breaker_threshold=None, breaker_cooldown_s=None,
                 hedge_floor_ms=None, replica_slots=None,
                 membership_poll_s=None):
        if not replica_urls and not coord:
            raise ValueError("FleetRouter needs at least one replica url "
                             "(or a fleet coordinator address)")
        self.replicas = [Replica(f"r{i}", u)
                         for i, u in enumerate(replica_urls or ())]
        self.page_size = int(
            page_size or _flags.flag("FLAGS_genserve_page_size", 16))
        self.probe_interval_s = float(
            probe_interval_s
            or _flags.flag("FLAGS_router_probe_interval_s", 0.5))
        self.dead_after = int(
            dead_after or _flags.flag("FLAGS_router_dead_after", 3))
        self.healthy_after = int(
            healthy_after or _flags.flag("FLAGS_router_healthy_after", 2))
        self.breaker_threshold = int(
            breaker_threshold
            or _flags.flag("FLAGS_router_breaker_threshold", 3))
        self.breaker_cooldown_s = float(
            breaker_cooldown_s
            or _flags.flag("FLAGS_router_breaker_cooldown_s", 2.0))
        self.hedge_floor_ms = float(
            hedge_floor_ms
            if hedge_floor_ms is not None
            else _flags.flag("FLAGS_router_hedge_floor_ms", 0.0))
        self.replica_slots = int(
            replica_slots or _flags.flag("FLAGS_router_replica_slots", 4))
        self.membership_poll_s = float(
            membership_poll_s
            or _flags.flag("FLAGS_fleet_membership_poll_s", 0.1))
        self.budget = RetryBudget(
            retry_budget_ratio if retry_budget_ratio is not None
            else _flags.flag("FLAGS_router_retry_budget_ratio", 0.1),
            retry_budget_min if retry_budget_min is not None
            else _flags.flag("FLAGS_router_retry_budget_min", 5.0))
        self.request_timeout_s = float(request_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._install_signals = install_signal_handlers
        self._host = host
        self._requested_port = int(port)
        self.metrics = RouterMetrics()
        self._lock = threading.RLock()
        self._affinity: dict[str, int] = {}   # prefix hash -> replica idx
        self._coord = coord
        self._pod = None
        self._member_epoch = 0
        self._coord_dead: set[int] = set()
        self._latencies = collections.deque(maxlen=256)
        self._lat_ewma_s = 0.0
        self._httpd = None
        self._guard = None
        self._threads = []
        self._done = threading.Event()
        self._stop_probe = threading.Event()
        self._drain_clean = None
        self._shutdown_once = threading.Lock()
        self._started_at = None
        self.draining = False

    # -- lifecycle ---------------------------------------------------------
    @property
    def uptime_s(self) -> float:
        return round(time.monotonic() - self._started_at, 1) \
            if self._started_at is not None else 0.0

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd \
            else self._requested_port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def start(self) -> "FleetRouter":
        if self._coord:
            from ..distributed.podcoord import PodClient

            # rank -1: the router is a membership OBSERVER, never a
            # heartbeating member — it must not count toward liveness
            self._pod = PodClient(self._coord, rank=-1)
            self._bootstrap_membership()
        self._probe_all()  # synchronous first pass: route correctly from
        self._httpd = _HTTPServer((self._host, self._requested_port),
                                  _Handler)  # request #1, not probe #2
        self._httpd.owner = self
        self._started_at = time.monotonic()
        if self._install_signals:
            self._guard = PreemptionGuard()
            self._guard.__enter__()
        t_serve = threading.Thread(target=self._httpd.serve_forever,
                                   kwargs={"poll_interval": 0.05},
                                   daemon=True, name="paddle-router-http")
        t_probe = threading.Thread(target=self._probe_loop, daemon=True,
                                   name="paddle-router-probe")
        t_watch = threading.Thread(target=self._watch, daemon=True,
                                   name="paddle-router-sigwatch")
        self._threads = [t_serve, t_probe, t_watch]
        if self._pod is not None:
            t_member = threading.Thread(target=self._membership_loop,
                                        daemon=True,
                                        name="paddle-router-membership")
            self._threads.append(t_member)
        for t in self._threads:
            t.start()
        logger.info("router on %s over %d replicas (%s)%s", self.url,
                    len(self.replicas),
                    ", ".join(r.url for r in self.replicas),
                    f" coord={self._coord}" if self._coord else "")
        return self

    def _watch(self):
        while not self._done.wait(0.05):
            if self._guard is not None and self._guard.preempted:
                logger.warning("signal %s latched — draining router",
                               self._guard.signum)
                self.shutdown()
                return

    def shutdown(self) -> bool:
        """Drain: reject new admissions, let inflight proxied requests
        finish, close the listener.  Idempotent; True = clean."""
        with self._shutdown_once:
            if self._drain_clean is not None:
                return self._drain_clean
            self.draining = True
            self._stop_probe.set()
            deadline = time.monotonic() + self.drain_timeout_s
            while time.monotonic() < deadline:
                with self._lock:
                    if all(r.inflight == 0 for r in self.replicas):
                        break
                time.sleep(0.02)
            with self._lock:
                clean = all(r.inflight == 0 for r in self.replicas)
            if self._httpd is not None:
                self._httpd.shutdown()
                self._httpd.server_close()
            if self._guard is not None:
                self._guard.__exit__(None, None, None)
                self._guard = None
            self._drain_clean = clean
            self._done.set()
            logger.info("router drain %s", "clean" if clean else "TIMED OUT")
            return clean

    def wait(self, timeout=None) -> int:
        if not self._done.wait(timeout):
            return -1
        for t in self._threads:
            t.join(5.0)
        return 0 if self._drain_clean else 1

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- elastic membership (the pod coordinator) --------------------------
    def _bootstrap_membership(self, timeout_s: float = 30.0):
        """Initial replica discovery: block until at least one live rank
        has registered its URL in the coordinator KV (replicas register
        right after their readiness line, so this bounds router start to
        fleet bring-up, not probe timeouts)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                self._membership_sync(kv_timeout_s=2.0)
            except (OSError, RuntimeError) as e:
                logger.debug("membership bootstrap retry: %s", e)
            if self.replicas:
                return
            time.sleep(0.1)
        raise TimeoutError(
            f"no replica registered with coordinator {self._coord} "
            f"within {timeout_s:g}s")

    def _membership_loop(self):
        while not self._stop_probe.wait(self.membership_poll_s):
            try:
                m = self._pod.membership()
            except (OSError, RuntimeError):
                continue  # coordinator briefly unreachable; probes rule
            if int(m["epoch"]) == self._member_epoch:
                continue
            try:
                self._membership_sync(membership=m)
            except (OSError, RuntimeError) as e:
                logger.warning("membership sync failed: %s", e)

    def _membership_sync(self, membership=None, kv_timeout_s: float = 2.0):
        """Apply one membership snapshot: evict coordinator-declared-dead
        ranks on the EPOCH DELTA (no probe-timeout wait) and (re)admit
        live ranks at their registered URL — a supervisor respawn shows
        up here as a fresh URL under the same rank."""
        m = membership if membership is not None else self._pod.membership()
        epoch = int(m["epoch"])
        live = [int(r) for r in m.get("live", ())]
        dead = {int(r): why for r, why in m.get("dead", {}).items()}
        urls = {}
        for r in live:
            raw = self._pod.kv_get(f"serving/replica/{r}/url",
                                   timeout_s=kv_timeout_s)
            if raw:
                urls[r] = raw.decode("utf-8")
        with self._lock:
            by_name = {rep.name: rep for rep in self.replicas}
            for r, why in dead.items():
                rep = by_name.get(f"r{r}")
                if rep is not None and rep.alive:
                    rep.alive = False
                    rep.fails = max(rep.fails, self.dead_after)
                    rep.succs = 0
                    logger.warning(
                        "epoch %d: replica %s evicted (%s) ahead of "
                        "probe timeout", epoch, rep.name, why)
            for r, u in urls.items():
                rep = by_name.get(f"r{r}")
                if rep is None:
                    rep = Replica(f"r{r}", u)
                    self.replicas.append(rep)
                    logger.info("epoch %d: replica %s joined at %s",
                                epoch, rep.name, u)
                elif rep.url != u.rstrip("/") or r in self._coord_dead:
                    # same rank, new process (respawn) — trust the
                    # supervisor's re-admission; probes keep watching
                    logger.info("epoch %d: replica %s respawned at %s",
                                epoch, rep.name, u)
                    rep.reset_fresh(u)
            self._coord_dead = set(dead)
            self._member_epoch = epoch
            self.metrics.set_epoch(epoch)
            self.metrics.set_healthy(
                sum(1 for rp in self.replicas if rp.alive))

    # -- health probing ----------------------------------------------------
    def _probe_one(self, rep: Replica):
        try:
            req = urllib.request.Request(rep.url + "/healthz")
            with urllib.request.urlopen(req, timeout=2.0) as resp:
                ok = resp.status == 200
                rep.draining = False
        except urllib.error.HTTPError as e:
            # 503 healthz = replica draining: stop routing to it, but it
            # is answering — not a crash
            ok = False
            rep.draining = (e.code == 503)
        except OSError:
            ok = False
            rep.draining = False
        with self._lock:
            if ok:
                rep.fails = 0
                if rep.alive:
                    rep.succs = 0
                else:
                    # flap damping: a dead replica must string together
                    # `healthy_after` consecutive probe successes before
                    # taking traffic again — one lucky probe of a sick
                    # replica must not re-admit it
                    rep.succs += 1
                    if rep.succs >= self.healthy_after:
                        rep.succs = 0
                        rep.brk_fails = 0
                        rep.brk_until = 0.0
                        rep.alive = True
                        logger.info("replica %s healthy again after %d "
                                    "consecutive probe successes",
                                    rep.name, self.healthy_after)
            else:
                rep.fails += 1
                rep.succs = 0
                if rep.fails >= self.dead_after or rep.draining:
                    rep.alive = False

    def _update_healthy(self):
        with self._lock:
            self.metrics.set_healthy(
                sum(1 for r in self.replicas if r.alive))

    def _probe_all(self):
        for rep in list(self.replicas):
            self._probe_one(rep)
        self._update_healthy()

    def _probe_loop(self):
        """Staggered probing: one replica every interval/N seconds
        instead of the whole fleet back-to-back — a restarting fleet is
        not greeted by a thundering herd of simultaneous probes."""
        while not self._stop_probe.is_set():
            reps = list(self.replicas)
            step = self.probe_interval_s / max(1, len(reps))
            for rep in reps:
                if self._stop_probe.wait(step):
                    return
                self._probe_one(rep)
                self._update_healthy()

    # -- routing policy ----------------------------------------------------
    def _prefix_key(self, prompt) -> str | None:
        """Hash of the page-aligned shareable prefix — EXACTLY the
        region the replica's PrefixCache would share
        (`shareable_pages`: the last page is never shared because the
        next generated token writes into it)."""
        n_pages = max(0, (len(prompt) - 1) // self.page_size)
        if n_pages == 0:
            return None
        head = prompt[:n_pages * self.page_size]
        return hashlib.sha1(
            b",".join(b"%d" % int(t) for t in head)).hexdigest()

    def _breaker_open(self, rep: Replica, now: float) -> bool:
        return rep.brk_fails >= self.breaker_threshold \
            and now < rep.brk_until

    def _note_request_failure(self, rep: Replica):
        with self._lock:
            rep.brk_fails += 1
            if rep.brk_fails >= self.breaker_threshold:
                rep.brk_until = time.monotonic() + self.breaker_cooldown_s

    def _note_request_success(self, rep: Replica):
        with self._lock:
            rep.brk_fails = 0
            rep.brk_until = 0.0

    def _evict(self, rep: Replica, why: str):
        """Immediate eviction on hard request-path evidence (a severed
        in-flight stream beats any probe): the replica re-earns traffic
        via `healthy_after` probe successes or a membership re-admit."""
        with self._lock:
            if rep.alive:
                rep.alive = False
                rep.fails = max(rep.fails, self.dead_after)
                rep.succs = 0
                logger.warning("replica %s evicted: %s", rep.name, why)
        self._update_healthy()

    def _pick(self, key, exclude=()):
        """(replica, reason) under the routing policy; None when no live
        replica remains.  `exclude`: replicas already tried this request
        (429 backpressure / failure retries).  Breaker-open replicas are
        skipped exactly like dead ones."""
        now = time.monotonic()
        with self._lock:
            live = [r for r in self.replicas
                    if r.alive and r.name not in exclude
                    and not self._breaker_open(r, now)]
            if not live:
                return None, None
            if key is not None:
                idx = self._affinity.get(key)
                if idx is not None and idx < len(self.replicas):
                    aff = self.replicas[idx]
                    if aff in live:
                        return aff, "prefix_hit"
                    # affinity points at a dead/busy replica: rebind
                    reason = "health_failover" if not aff.alive \
                        else "least_loaded"
                else:
                    reason = "least_loaded"
            else:
                reason = "least_loaded"
            rep = min(live, key=lambda r: (r.inflight, r.name))
            if key is not None:
                self._affinity[key] = self.replicas.index(rep)
            return rep, reason

    # -- latency model (deadline admission + hedging) ----------------------
    def _observe_latency(self, seconds: float):
        with self._lock:
            self._latencies.append(seconds)
            a = 0.1
            self._lat_ewma_s = seconds if self._lat_ewma_s == 0.0 \
                else (1 - a) * self._lat_ewma_s + a * seconds

    def _p99_s(self) -> float:
        with self._lock:
            if not self._latencies:
                return 0.0
            xs = sorted(self._latencies)
            return xs[min(len(xs) - 1, int(0.99 * len(xs)))]

    def _est_wait_ms(self, rep: Replica) -> float:
        """Estimated queue wait on `rep` before THIS request starts
        decoding: requests beyond the replica's slot count wait roughly
        one mean service time per occupied wave of slots."""
        with self._lock:
            waiting = max(0, rep.inflight + 1 - self.replica_slots)
            return (waiting * self._lat_ewma_s * 1e3
                    / max(1, self.replica_slots))

    def _hedge_delay_s(self) -> float:
        if self.hedge_floor_ms <= 0:
            return 0.0
        return max(self.hedge_floor_ms / 1e3, self._p99_s())

    def _deadline_hopeless(self, handler, rep, payload, span) -> bool:
        """Deadline-aware admission: reject NOW when the estimated queue
        wait alone already exceeds the request's deadline — a doomed
        dispatch would only add load to a replica that is behind."""
        deadline_ms = payload.get("deadline_ms")
        if deadline_ms is None:
            return False
        est = self._est_wait_ms(rep)
        if est <= float(deadline_ms):
            return False
        self.metrics.count_deadline_rejected()
        span.set_attr("status", "deadline_rejected")
        handler._send_json(
            504, {"error": "deadline unmeetable: estimated queue wait "
                           f"{est:.0f}ms exceeds deadline_ms "
                           f"{deadline_ms}"})
        return True

    # -- proxying ----------------------------------------------------------
    def _route_generate(self, handler, raw, span):
        try:
            payload = json.loads(raw or b"{}")
            prompt = payload.get("prompt") or []
            stream = bool(payload.get("stream", False))
        except ValueError:
            handler._send_json(400, {"error": "bad request: invalid JSON"})
            return
        key = self._prefix_key(prompt)
        if stream:
            self._route_stream(handler, payload, raw, span, key)
        else:
            self._route_unary(handler, payload, raw, span, "/generate", key)

    def _route_predict(self, handler, raw, span):
        try:
            payload = json.loads(raw or b"{}")
        except ValueError:
            handler._send_json(400, {"error": "bad request: invalid JSON"})
            return
        self._route_unary(handler, payload, raw, span, "/predict", None)

    def _route_unary(self, handler, payload, raw, span, path, key):
        """Non-streaming dispatch loop: backpressure retries are free,
        failure retries (transport / replica 5xx) spend retry budget,
        hedging duplicates slow dispatches when enabled."""
        tried: set[str] = set()
        saw_failure = False
        while True:
            rep, reason = self._pick(key, exclude=tried)
            if rep is None:
                if saw_failure:
                    span.set_attr("status", "no_live_replica")
                    handler._send_json(
                        503, {"error": "request failed on every live "
                                       "replica"})
                    self.metrics.count_outcome(ok=False)
                elif tried:   # every live replica answered 429
                    span.set_attr("status", "backpressure_exhausted")
                    handler._send_json(
                        429, {"error": "all replicas at capacity"})
                else:
                    span.set_attr("status", "no_live_replica")
                    handler._send_json(
                        503, {"error": "no live replica"})
                    self.metrics.count_outcome(ok=False)
                return
            if self._deadline_hopeless(handler, rep, payload, span):
                return
            tried.add(rep.name)
            kind, status, body, ctype = self._dispatch_unary(
                rep, reason, raw, span, path, tried)
            if kind == "backpressure":
                self.metrics.count_backpressure(rep.name)
                continue
            if kind == "failed":
                saw_failure = True
                if self.budget.withdraw():
                    self.metrics.count_failover("dispatch")
                    continue
                self.metrics.count_budget_exhausted()
                span.set_attr("status", "retry_budget_exhausted")
                handler._send_json(
                    503, {"error": "retry budget exhausted; last "
                                   f"upstream status {status}"})
                self.metrics.count_outcome(ok=False)
                return
            handler._send(status, body, ctype)
            if 200 <= status < 300:
                self.metrics.count_outcome(ok=True)
            elif status >= 500:
                self.metrics.count_outcome(ok=False)
            return

    def _dispatch_unary(self, rep, reason, raw, span, path, tried):
        """One (possibly hedged) upstream POST.  Returns (kind, status,
        body, ctype) with kind in ok|backpressure|failed|definitive."""
        delay = self._hedge_delay_s()
        if delay <= 0:
            return self._upstream(rep, reason, raw, span, path)
        results: _queue.Queue = _queue.Queue()

        def run(r, rsn, tag):
            results.put((tag, self._upstream(r, rsn, raw, span, path)))

        threading.Thread(target=run, args=(rep, reason, "primary"),
                         daemon=True).start()
        try:
            tag, out = results.get(timeout=delay)
        except _queue.Empty:
            hedge_rep, _ = self._pick(None, exclude=tried)
            if hedge_rep is None:
                tag, out = results.get()   # nobody to hedge to; wait
            else:
                self.metrics.count_failover("hedge")
                threading.Thread(
                    target=run, args=(hedge_rep, "hedge", "hedge"),
                    daemon=True).start()
                tag, out = results.get()   # first answer wins
                if out[0] == "failed":
                    # the first finisher failed — the race has a second
                    # runner, prefer its (possibly good) answer
                    tag, out = results.get()
                self.metrics.count_hedge(
                    "won" if tag == "hedge" else "lost")
        return out

    def _upstream(self, rep, reason, raw, span, path):
        """One upstream POST to `rep`, fully buffered (non-streaming).
        Pure: never touches the client handler, so hedge threads can
        race it safely."""
        span.set_attr("replica", rep.name)
        span.set_attr("reason", reason)
        headers = {"Content-Type": "application/json",
                   "traceparent": span.traceparent}
        req = urllib.request.Request(rep.url + path, data=raw,
                                     headers=headers, method="POST")
        with self._lock:
            rep.inflight += 1
        self.metrics.add_inflight(1)
        t0 = time.monotonic()
        try:
            try:
                resp = urllib.request.urlopen(
                    req, timeout=self.request_timeout_s)
            except urllib.error.HTTPError as e:
                body = e.read()
                ctype = e.headers.get("Content-Type", "application/json")
                if e.code == 429:
                    return "backpressure", 429, body, ctype
                if e.code >= 500:
                    self._note_request_failure(rep)
                    return "failed", e.code, body, ctype
                return "definitive", e.code, body, ctype
            except OSError as e:
                self._note_request_failure(rep)
                body = json.dumps(
                    {"error": f"replica {rep.name} unreachable: {e}"}
                ).encode()
                return "failed", 502, body, "application/json"
            with resp:
                body = resp.read()
                ctype = resp.headers.get("Content-Type",
                                         "application/json")
            self.metrics.count_routed(rep.name, reason)
            self._note_request_success(rep)
            self.budget.deposit()
            self._observe_latency(time.monotonic() - t0)
            return "definitive", resp.status, body, ctype
        finally:
            with self._lock:
                rep.inflight -= 1
            self.metrics.add_inflight(-1)

    # -- streaming with journaled mid-stream failover ----------------------
    def _route_stream(self, handler, payload, raw, span, key):
        """SSE proxy with a request journal: every relayed token is
        recorded; if the upstream dies mid-stream the request is
        re-admitted on a survivor with the emitted prefix appended to
        the prompt and the PRNG chain fast-forwarded (`resume_pos`), so
        the client stream continues at the next token with no failed
        request — greedy output bitwise the uninterrupted run."""
        prompt = list(payload.get("prompt") or [])
        max_new = int(payload.get("max_new_tokens", 32))
        base_resume = int(payload.get("resume_pos", 0))
        emitted: list[int] = []
        state = {"headers_sent": False}
        tried: set[str] = set()
        saw_failure = False
        saw_backpressure = False
        t0 = time.monotonic()
        t_loss = None

        def fail_out(msg, status=503):
            if state["headers_sent"]:
                self._write_event(handler, {
                    "done": True, "tokens": len(emitted), "error": msg})
                self._end_chunks(handler)
            else:
                handler._send_json(status, {"error": msg})
            self.metrics.count_outcome(ok=False)

        while True:
            rep, reason = self._pick(key, exclude=tried)
            if rep is None:
                if saw_backpressure and not saw_failure \
                        and not state["headers_sent"]:
                    span.set_attr("status", "backpressure_exhausted")
                    handler._send_json(
                        429, {"error": "all replicas at capacity"})
                else:
                    span.set_attr("status", "no_live_replica")
                    fail_out("no live replica")
                return
            if not emitted \
                    and self._deadline_hopeless(handler, rep, payload,
                                                span):
                return
            tried.add(rep.name)
            if emitted:
                body = json.dumps({
                    **payload,
                    "prompt": prompt + emitted,
                    "max_new_tokens": max_new - len(emitted),
                    "resume_pos": base_resume + len(emitted),
                }).encode()
            else:
                body = raw
            span.set_attr("replica", rep.name)
            span.set_attr("reason", reason)
            headers = {"Content-Type": "application/json",
                       "traceparent": span.traceparent}
            req = urllib.request.Request(rep.url + "/generate", data=body,
                                         headers=headers, method="POST")
            with self._lock:
                rep.inflight += 1
            self.metrics.add_inflight(1)
            try:
                try:
                    resp = urllib.request.urlopen(
                        req, timeout=self.request_timeout_s)
                except urllib.error.HTTPError as e:
                    err_body = e.read()
                    if e.code == 429:
                        saw_backpressure = True
                        self.metrics.count_backpressure(rep.name)
                        continue
                    if e.code < 500 and not state["headers_sent"]:
                        # the replica judged the request malformed — a
                        # definitive answer, not a fleet failure
                        handler._send(e.code, err_body,
                                      e.headers.get("Content-Type",
                                                    "application/json"))
                        return
                    saw_failure = True
                    self._note_request_failure(rep)
                    if not self.budget.withdraw():
                        self.metrics.count_budget_exhausted()
                        span.set_attr("status", "retry_budget_exhausted")
                        fail_out("retry budget exhausted")
                        return
                    self.metrics.count_failover(
                        "mid_stream" if emitted else "dispatch")
                    continue
                except OSError as e:
                    saw_failure = True
                    self._note_request_failure(rep)
                    if not self.budget.withdraw():
                        self.metrics.count_budget_exhausted()
                        span.set_attr("status", "retry_budget_exhausted")
                        fail_out(f"retry budget exhausted ({e})")
                        return
                    self.metrics.count_failover(
                        "mid_stream" if emitted else "dispatch")
                    continue
                self.metrics.count_routed(rep.name, reason)
                if t_loss is not None:
                    self.metrics.set_recovery_ms(
                        (time.monotonic() - t_loss) * 1e3)
                    t_loss = None
                with resp:
                    outcome = self._relay_journal(handler, resp, emitted,
                                                  state, t0)
            finally:
                with self._lock:
                    rep.inflight -= 1
                self.metrics.add_inflight(-1)
            if outcome == "done":
                span.set_attr("tokens", len(emitted))
                self._note_request_success(rep)
                self.budget.deposit()
                self._observe_latency(time.monotonic() - t0)
                self.metrics.count_outcome(ok=True)
                return
            if outcome == "done_error":
                # the replica reported an in-band engine error (deadline,
                # cancel) — relayed as-is; not a fleet transport failure
                span.set_attr("status", "upstream_error")
                self.metrics.count_outcome(ok=False)
                return
            if outcome == "client_gone":
                span.set_attr("status", "client_gone")
                return
            # upstream_lost: the replica died mid-stream.  Evict it NOW
            # (hard evidence beats probe cadence), then resume on a
            # survivor if the retry budget allows.
            t_loss = time.monotonic()
            saw_failure = True
            self._note_request_failure(rep)
            self._evict(rep, "connection severed mid-stream")
            if key is not None:
                with self._lock:
                    # its prefix pages died with it: drop the binding
                    if self._affinity.get(key) == \
                            self.replicas.index(rep):
                        self._affinity.pop(key, None)
            if not self.budget.withdraw():
                self.metrics.count_budget_exhausted()
                span.set_attr("status", "retry_budget_exhausted")
                fail_out("retry budget exhausted mid-stream")
                return
            self.metrics.count_failover("mid_stream")
            logger.warning("stream failover: %d tokens relayed, "
                           "re-admitting on a survivor", len(emitted))

    def _write_event(self, handler, obj) -> bool:
        """One SSE event onto the (chunked) client connection; sends the
        response headers first if this is the stream's first event.
        False = the client went away."""
        try:
            if not getattr(handler, "_sse_started", False):
                handler.send_response(200)
                handler.send_header("Content-Type", "text/event-stream")
                handler.send_header("Cache-Control", "no-cache")
                handler.send_header("Transfer-Encoding", "chunked")
                handler.send_header("Connection", "close")
                handler.end_headers()
                handler.close_connection = True
                handler._sse_started = True
            data = b"data: " + json.dumps(obj).encode() + b"\n\n"
            handler.wfile.write(b"%X\r\n" % len(data) + data + b"\r\n")
            handler.wfile.flush()
            return True
        except (BrokenPipeError, ConnectionResetError):
            return False

    def _end_chunks(self, handler):
        try:
            handler.wfile.write(b"0\r\n\r\n")
            handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _relay_journal(self, handler, resp, emitted, state, t0):
        """Parse-and-relay the upstream SSE stream.  Token events are
        journaled into `emitted` AND re-framed to the client; the final
        done event is rewritten so the client sees the TOTAL token count
        and latency across failovers.  Returns one of:
        done | done_error | upstream_lost | client_gone."""
        try:
            for line in resp:
                line = line.strip()
                if not line.startswith(b"data:"):
                    continue
                try:
                    obj = json.loads(line[5:].strip())
                except ValueError:
                    continue
                if obj.get("done"):
                    out = dict(obj)
                    out["tokens"] = len(emitted)
                    out["latency_ms"] = round(
                        (time.monotonic() - t0) * 1e3, 3)
                    if not self._write_event(handler, out):
                        return "client_gone"
                    state["headers_sent"] = True
                    self._end_chunks(handler)
                    return "done_error" if obj.get("error") else "done"
                tok = obj.get("token")
                if tok is None:
                    continue
                emitted.append(tok)
                if not self._write_event(handler, {"token": tok}):
                    return "client_gone"
                state["headers_sent"] = True
        except (OSError, http.client.HTTPException):
            return "upstream_lost"
        # EOF without a done event: the replica died between events
        return "upstream_lost"

    # -- metrics federation ------------------------------------------------
    def federated_metrics(self) -> str:
        """Router registry + every live replica's /metrics scrape, each
        replica section under a `# replica=<name> <url>` banner."""
        parts = [self.metrics.prometheus_text()]
        for rep in list(self.replicas):
            if not rep.alive:
                parts.append(f"# replica={rep.name} {rep.url} DEAD\n")
                continue
            try:
                with urllib.request.urlopen(
                        rep.url + "/metrics", timeout=2.0) as resp:
                    parts.append(f"# replica={rep.name} {rep.url}\n"
                                 + resp.read().decode())
            except OSError:
                parts.append(f"# replica={rep.name} {rep.url} SCRAPE "
                             "FAILED\n")
        return "".join(parts)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="paddle_tpu_torch generation fleet router "
                    "(prefix-affinity + least-loaded + health/epoch "
                    "failover over N "
                    "replicas, with journaled mid-stream resume)")
    parser.add_argument("--replicas", default="",
                        help="comma-separated replica base urls, e.g. "
                             "http://127.0.0.1:8870,http://127.0.0.1:8871 "
                             "(optional with --coord: replicas are "
                             "discovered from the coordinator KV)")
    parser.add_argument("--coord", default=None,
                        help="fleet coordinator host:port (the serving "
                             "supervisor's PodCoordinator); enables "
                             "epoch-delta eviction + respawn re-admission")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0,
                        help="0 picks a free port (printed on stdout)")
    parser.add_argument("--page-size", type=int, default=None,
                        help="replica KV page size (prefix hash "
                             "alignment; must match the replicas)")
    parser.add_argument("--probe-interval", type=float, default=None)
    parser.add_argument("--dead-after", type=int, default=None)
    parser.add_argument("--hedge-floor-ms", type=float, default=None,
                        help="hedge non-streaming dispatches after "
                             "max(this, observed p99) ms; unset/0 "
                             "disables")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    urls = [u.strip() for u in args.replicas.split(",") if u.strip()]
    if not urls and not args.coord:
        parser.error("need --replicas and/or --coord")
    router = FleetRouter(urls, host=args.host, port=args.port,
                         page_size=args.page_size,
                         probe_interval_s=args.probe_interval,
                         dead_after=args.dead_after,
                         coord=args.coord,
                         hedge_floor_ms=args.hedge_floor_ms).start()
    # parse-friendly readiness line
    print(f"paddle_tpu_torch.serving.router listening on {router.url}",
          flush=True)
    return router.wait()


if __name__ == "__main__":
    import sys

    sys.exit(main())
