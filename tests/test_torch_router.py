"""The port's fleet router (paddle_tpu_torch/serving/router.py) and its
``RouterMetrics`` on the CPU, beside the JAX package's.

* ``RetryBudget`` and ``RouterMetrics``: the same sequence of operations
  into both packages' objects gives the same balances, withdrawals,
  ``snapshot()`` and Prometheus text (names, labels, values).
* ``_prefix_key`` equals the reference's for every prompt length from 0 to
  3 pages + 1.
* Routing decisions: each scenario of the reference's
  tests/test_fleet_chaos.py and tests/test_spec_decode.py::TestRouter
  runs through the reference's ``FleetRouter`` and the port's over fresh
  standard-library stub replicas (healthy, 429, failing, slow, toggling
  health); the ``routed``, ``backpressure``, ``failovers``, ``hedges`` and
  breaker state, the statuses and the stubs' dispatch counts are equal.
  Membership runs each router against each package's coordinator.
* Mid-stream failover end to end: a stub replica over an engine that
  severs its SSE stream after n tokens (the reference's ``_FlakyGen``)
  and a ServingServer behind each package's router, the port's GPT
  holding the reference's weights (replica ``main()``'s widths: vocab
  211, hidden 64, 4 heads, 2 layers; prompt buckets 8 and 16): a greedy
  stream equals the uninterrupted run bitwise and the reference fleet's
  stream, also where the resumed prompt crosses into the 16 bucket; a
  sampled stream resumes on the port engine's chain; the done event
  counts both legs.
"""
import json
import re
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import podcoord as jpodcoord
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.serving import metrics as jmetrics
from paddle_tpu.serving import router as jrouter
from paddle_tpu.serving.generation import \
    GenerationEngine as JGenerationEngine
from paddle_tpu.serving.server import ServingServer as JServingServer
from paddle_tpu_torch.distributed import podcoord as ppodcoord
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, load_numpy_state
from paddle_tpu_torch.serving import metrics as pmetrics
from paddle_tpu_torch.serving import router as prouter
from paddle_tpu_torch.serving.generation import GenerationEngine
from paddle_tpu_torch.serving.server import ServingServer

ROUTERS = {"reference": jrouter, "port": prouter}
COORDS = {"reference": jpodcoord, "port": ppodcoord}
PREFIX = list(range(3, 11))          # 2 pages of 4
QUIET = dict(install_signal_handlers=False)


# ---------------------------------------------------------------------------
# RetryBudget and RouterMetrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ratio,floor,cap,ops", [
    (0.5, 2.0, 100.0, "www" + "dddd" + "www"),
    (0.1, 5.0, 100.0, "wwwwww" + "d" * 25 + "wwww"),
    (1.0, 1.0, 3.0, "d" * 10 + "wwww"),
    (0.0, 0.0, 100.0, "wdw"),
])
def test_retry_budget_equals_the_reference(ratio, floor, cap, ops):
    got = []
    for mod in (jrouter, prouter):
        b = mod.RetryBudget(ratio, floor, cap)
        trail = []
        for op in ops:
            trail.append(b.withdraw() if op == "w" else b.deposit())
            trail.append(round(b.balance, 9))
        got.append(trail)
    assert got[0] == got[1]


def test_retry_budget_math():
    b = prouter.RetryBudget(ratio=0.5, min_budget=2.0)
    assert b.withdraw() and b.withdraw()
    assert not b.withdraw(), "floor budget is 2 retries"
    for _ in range(4):
        b.deposit()
    assert b.withdraw() and b.withdraw()
    assert not b.withdraw()


EVENTS = [("count_routed", "r0", "prefix_hit"),
          ("count_routed", "r1", "least_loaded"),
          ("count_backpressure", "r1"), ("count_failover", "mid_stream"),
          ("count_outcome", True), ("set_healthy", 2),
          ("count_routed", "r0", "prefix_hit"),
          ("count_failover", "dispatch"), ("count_failover", "hedge"),
          ("count_budget_exhausted",), ("count_deadline_rejected",),
          ("count_hedge", "won"), ("count_hedge", "lost"),
          ("count_outcome", False), ("set_epoch", 3),
          ("set_recovery_ms", 12.3456789), ("add_inflight", 2),
          ("add_inflight", -1), ("count_routed", "r2", "health_failover"),
          ("count_backpressure", "r0"), ("count_hedge", "won"),
          ("count_outcome", True), ("set_healthy", 1)]


@pytest.mark.parametrize("n", [0, 1, 6, 14, len(EVENTS)])
def test_router_metrics_equal_the_reference(n):
    out = []
    for mod in (jmetrics, pmetrics):
        m = mod.RouterMetrics()
        for name, *args in EVENTS[:n]:
            getattr(m, name)(*args)
        out.append((m.snapshot(), m.prometheus_text()))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]
    assert "paddle_router_requests_total" in out[1][1]


@pytest.mark.parametrize("page_size", [4, 16])
def test_prefix_key_equals_the_reference(page_size):
    rs = np.random.RandomState(page_size)
    routers = [mod.FleetRouter(["http://127.0.0.1:1"], page_size=page_size,
                               **QUIET) for mod in (jrouter, prouter)]
    keys = set()
    for n in range(3 * page_size + 2):
        prompt = rs.randint(0, 50000, n).tolist()
        want = routers[0]._prefix_key(prompt)
        assert routers[1]._prefix_key(prompt) == want, n
        assert (want is None) == (n <= page_size)
        keys.add(want)
    assert len(keys) > 3


# ---------------------------------------------------------------------------
# stub replicas (standard library only; one fresh set per router run)
# ---------------------------------------------------------------------------
class _Stub(BaseHTTPRequestHandler):
    """``server.mode``: "ok" answers after ``server.delay_s`` (JSON, or SSE
    when the request streams), "429" backpressures, "500" fails; /healthz
    answers 200 while ``server.healthy``, else 500; /metrics a fixed
    scrape."""

    protocol_version = "HTTP/1.1"

    def _reply(self, code, body, headers=()):
        self.send_response(code)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        if self.path == "/metrics":
            self._reply(200, f"paddle_genserve_stub {{tag=\"{self.server.tag}"
                             "\"} 1\n".encode())
            return
        self._reply(200 if self.server.healthy else 500, b'{"status": "ok"}')

    def do_POST(self):  # noqa: N802
        p = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        with self.server.lock:
            self.server.posts += 1
        if self.server.mode == "429":
            self._reply(429, b'{"error": "queue full"}', [("Retry-After", "0")])
            return
        if self.server.mode == "500":
            self._reply(500, b'{"error": "internal"}')
            return
        time.sleep(self.server.delay_s)
        toks = [7, 8, 9][:int(p.get("max_new_tokens", 3))]
        if not p.get("stream"):
            self._reply(200, json.dumps({"tokens": toks,
                                         "who": self.server.tag}).encode())
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        for obj in [{"token": t} for t in toks] + [{"done": True,
                                                    "tokens": len(toks)}]:
            data = b"data: " + json.dumps(obj).encode() + b"\n\n"
            self.wfile.write(b"%X\r\n" % len(data) + data + b"\r\n")
        self.wfile.write(b"0\r\n\r\n")

    def log_message(self, *a):  # noqa: D102
        pass


class _Stubs:
    def __init__(self, *specs):
        self.servers = []
        for i, spec in enumerate(specs):
            s = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
            s.daemon_threads = True
            s.lock, s.posts, s.tag = threading.Lock(), 0, f"s{i}"
            s.mode, s.delay_s, s.healthy = "ok", 0.0, True
            for k, v in spec.items():
                setattr(s, k, v)
            threading.Thread(target=s.serve_forever, args=(0.05,),
                             daemon=True).start()
            self.servers.append(s)
        self.urls = [f"http://127.0.0.1:{s.server_address[1]}"
                     for s in self.servers]

    def __getitem__(self, i):
        return self.servers[i]

    def close(self):
        for s in self.servers:
            s.shutdown()
            s.server_close()


def _events(body):
    """The SSE events of a body; a done event's latency (a clock reading)
    is replaced by whether it was there."""
    out = [json.loads(ln[5:]) for ln in body.decode().splitlines()
           if ln.startswith("data:")]
    for e in out:
        if "latency_ms" in e:
            e["latency_ms"] = e["latency_ms"] > 0
    return out


def _post(url, obj, path="/generate"):
    req = urllib.request.Request(url + path, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            body = r.read()
            if r.headers.get("Content-Type") == "text/event-stream":
                return r.status, _events(body)
            return r.status, json.loads(body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _settle(router):
    """Wait for the router's handlers to finish: a stream's outcome and
    its budget deposit are counted just after its last byte is sent, so
    the client can read the whole stream before they land."""
    deadline = time.monotonic() + 5.0
    last = None
    while time.monotonic() < deadline:
        snap = router.metrics.snapshot()
        now = (snap["inflight"], snap["requests_ok"], snap["requests_failed"],
               router.budget.balance)
        if now == last and now[0] == 0:
            return
        last = now
        time.sleep(0.05)


def _state(router):
    _settle(router)
    snap = router.metrics.snapshot()
    return {"routed": snap["routed"], "backpressure": snap["backpressure"],
            "failovers": snap["failovers"], "hedges": snap["hedges"],
            "outcomes": (snap["requests_ok"], snap["requests_failed"]),
            "budget_exhausted": snap["retry_budget_exhausted"],
            "deadline_rejected": snap["deadline_rejected"],
            "breaker": [(r.name, r.alive, r.brk_fails, r.fails)
                        for r in router.replicas]}


def _with_router(R, stubs, **kw):
    kw = dict(dict(port=0, page_size=4, probe_interval_s=30.0), **kw)
    return R.FleetRouter(stubs.urls, **kw, **QUIET).start()


def sc_affinity(R):
    """A shared-prefix burst sticks to one replica; distinct prefixes and
    prompts too short to share spread least-loaded."""
    stubs = _Stubs({}, {})
    router = _with_router(R, stubs)
    try:
        outs = [_post(router.url, {"prompt": PREFIX + [20 + i],
                                   "max_new_tokens": 3}) for i in range(6)]
        outs += [_post(router.url, {"prompt": [40 + i] * 9,
                                    "max_new_tokens": 2}) for i in range(3)]
        outs.append(_post(router.url, {"prompt": [1, 2], "max_new_tokens": 1}))
        outs.append(_post(router.url, {"prompt": PREFIX + [99], "stream": True,
                                       "max_new_tokens": 3}))
        return {**_state(router), "outs": outs,
                "posts": [s.posts for s in stubs.servers]}
    finally:
        router.shutdown()
        stubs.close()


def sc_backpressure(R):
    """A 429 is retried on the other replica at no budget cost and leaves
    the replica's health alone; all replicas at 429 gives the client 429."""
    stubs = _Stubs({"mode": "429"}, {})
    router = _with_router(R, stubs, dead_after=2)
    try:
        outs = [_post(router.url, {"prompt": PREFIX + [50],
                                   "max_new_tokens": 3})]
        outs.append(_post(router.url, {"prompt": PREFIX + [51],
                                       "stream": True, "max_new_tokens": 3}))
        stubs[1].mode = "429"
        outs.append(_post(router.url, {"prompt": [5, 6], "max_new_tokens": 1}))
        outs.append(_post(router.url, {"prompt": [5, 6], "stream": True,
                                       "max_new_tokens": 1}))
        router._probe_all()
        return {**_state(router), "outs": outs,
                "balance": round(router.budget.balance, 9),
                "healthy": router.metrics.snapshot()["replicas_healthy"]}
    finally:
        router.shutdown()
        stubs.close()


def sc_budget_exhaustion(R):
    """A fully failing fleet: upstream dispatches are pinned at requests +
    budget, then fast 503s."""
    stubs = _Stubs({"mode": "500"}, {"mode": "500"})
    router = _with_router(R, stubs, dead_after=10, retry_budget_min=2.0,
                          retry_budget_ratio=0.0, breaker_threshold=100)
    try:
        codes = [_post(router.url, {"prompt": PREFIX, "max_new_tokens": 3})[0]
                 for _ in range(6)]
        codes.append(_post(router.url, {"prompt": PREFIX, "stream": True})[0])
        total = sum(s.posts for s in stubs.servers)
        assert 6 <= total <= 6 + 2 + 1
        return {**_state(router), "codes": codes, "total": total,
                "availability": router.metrics.snapshot()[
                    "availability_ratio"]}
    finally:
        router.shutdown()
        stubs.close()


def sc_breaker(R):
    """breaker_threshold consecutive failures stop dispatch to a replica
    until the cooldown expires."""
    stubs = _Stubs({"mode": "500"})
    router = _with_router(R, stubs, dead_after=10, retry_budget_min=100.0,
                          breaker_threshold=2, breaker_cooldown_s=60.0)
    try:
        codes = [_post(router.url, {"prompt": PREFIX, "max_new_tokens": 3})[0]
                 for _ in range(4)]
        return {**_state(router), "codes": codes, "posts": stubs[0].posts}
    finally:
        router.shutdown()
        stubs.close()


def sc_breaker_cooldown(R):
    """After the cooldown one trial request reaches the replica again, and
    a success closes the breaker."""
    stubs = _Stubs({"mode": "500"}, {})
    router = _with_router(R, stubs, dead_after=10, retry_budget_min=100.0,
                          breaker_threshold=1, breaker_cooldown_s=0.3)
    try:
        outs = [_post(router.url, {"prompt": [1, 2, 3], "max_new_tokens": 1})]
        outs.append(_post(router.url, {"prompt": [1, 2, 3],
                                       "max_new_tokens": 1}))
        stubs[0].mode = "ok"
        time.sleep(0.4)
        outs.append(_post(router.url, {"prompt": [1, 2, 3],
                                       "max_new_tokens": 1}))
        return {**_state(router), "outs": outs,
                "posts": [s.posts for s in stubs.servers]}
    finally:
        router.shutdown()
        stubs.close()


def sc_deadline(R):
    """A deadline below the estimated queue wait is rejected 504 at the
    router; without a latency estimate every deadline is admitted."""
    stubs = _Stubs({})
    router = _with_router(R, stubs, replica_slots=1)
    try:
        first = _post(router.url, {"prompt": PREFIX, "max_new_tokens": 3,
                                   "deadline_ms": 1})
        router._observe_latency(0.5)
        router.replicas[0].inflight = 4
        est = router._est_wait_ms(router.replicas[0])
        outs = [_post(router.url, {"prompt": PREFIX, "max_new_tokens": 3,
                                   "deadline_ms": 10}),
                _post(router.url, {"prompt": PREFIX, "stream": True,
                                   "deadline_ms": 10})]
        router.replicas[0].inflight = 0
        assert est > 10.0
        for _, body in outs:     # the estimate holds the first request's
            body["error"] = re.sub(r"wait \d+ms", "wait Nms", body["error"])
        return {**_state(router), "first": first, "outs": outs,
                "posts": stubs[0].posts}
    finally:
        router.replicas[0].inflight = 0
        router.shutdown()
        stubs.close()


def sc_hedge(R):
    """The slow replica's request is duplicated after the hedge delay and
    the fast replica's answer wins, exactly once."""
    stubs = _Stubs({"delay_s": 1.2, "tag": "slow"}, {"tag": "fast"})
    router = _with_router(R, stubs, hedge_floor_ms=100.0)
    try:
        t0 = time.monotonic()
        out = _post(router.url, {}, path="/predict")
        took = time.monotonic() - t0
        time.sleep(1.3)          # the abandoned primary finishes
        assert took < 1.0, took
        return {**_state(router), "out": out}
    finally:
        router.shutdown()
        stubs.close()


def sc_stream_dispatch_failover(R):
    """A stream whose first replica fails before any token is re-dispatched
    (a dispatch failover, one budget token) and completes."""
    stubs = _Stubs({"mode": "500"}, {})
    router = _with_router(R, stubs, dead_after=10)
    try:
        out = _post(router.url, {"prompt": [4, 5, 6], "stream": True,
                                 "max_new_tokens": 3})
        return {**_state(router), "out": out,
                "balance": round(router.budget.balance, 9)}
    finally:
        router.shutdown()
        stubs.close()


def sc_dead_replica(R):
    """The prefix's replica dies (probes): the next same-prefix request is
    a health_failover to the survivor and the affinity rebinds; the dead
    replica re-earns traffic after healthy_after probes and the prefix
    stays on its new replica."""
    stubs = _Stubs({}, {})
    router = _with_router(R, stubs, dead_after=2, healthy_after=2)
    try:
        outs = [_post(router.url, {"prompt": PREFIX + [60],
                                   "max_new_tokens": 2})]
        stubs[0].healthy = False
        for _ in range(2):
            router._probe_all()
        outs.append(_post(router.url, {"prompt": PREFIX + [61],
                                       "max_new_tokens": 2}))
        outs.append(_post(router.url, {"prompt": PREFIX + [62],
                                       "max_new_tokens": 2}))
        stubs[0].healthy = True
        for _ in range(2):
            router._probe_all()
        outs.append(_post(router.url, {"prompt": PREFIX + [63],
                                       "max_new_tokens": 2}))
        outs.append(_post(router.url, {"prompt": [70] * 9,
                                       "max_new_tokens": 2}))
        return {**_state(router), "outs": outs,
                "healthy": router.metrics.snapshot()["replicas_healthy"]}
    finally:
        router.shutdown()
        stubs.close()


def sc_no_live_replica(R):
    """Every replica dead: 503 for unary and stream, counted failed."""
    stubs = _Stubs({"healthy": False})
    router = _with_router(R, stubs, dead_after=1)
    try:
        outs = [_post(router.url, {"prompt": PREFIX}),
                _post(router.url, {"prompt": PREFIX, "stream": True}),
                _post(router.url, {}, path="/predict")]
        return {**_state(router), "outs": outs}
    finally:
        router.shutdown()
        stubs.close()


def sc_flap_damping(R):
    """2 failed probes mark a replica dead; re-admission takes healthy_after
    = 3 CONSECUTIVE successes, an interleaved failure resets the count."""
    stubs = _Stubs({"healthy": False})
    router = R.FleetRouter(stubs.urls, dead_after=2, healthy_after=3,
                           **QUIET)
    rep = router.replicas[0]
    trail = []
    try:
        for healthy in (False, False, True, True, False, True, True, True,
                        True, False, True):
            stubs[0].healthy = healthy
            router._probe_one(rep)
            trail.append((rep.alive, rep.succs, rep.fails))
        return {"trail": trail}
    finally:
        stubs.close()


def sc_staggered_probes(R):
    """The probe loop spaces per-replica probes at interval / N."""
    router = R.FleetRouter(["http://127.0.0.1:1", "http://127.0.0.1:2"],
                           probe_interval_s=0.2, **QUIET)
    times = []
    router._probe_one = lambda rep: times.append((time.monotonic(), rep.name))
    t = threading.Thread(target=router._probe_loop, daemon=True)
    t.start()
    time.sleep(0.75)
    router._stop_probe.set()
    t.join(2.0)
    gaps = [b[0] - a[0] for a, b in zip(times, times[1:])]
    assert all(g >= 0.05 for g in gaps), gaps
    return {"order": [n for _, n in times[:4]]}


def sc_federation(R):
    """/metrics: the router's registry, then every replica's scrape under
    its banner (a dead one marked DEAD)."""
    stubs = _Stubs({}, {})
    router = _with_router(R, stubs, dead_after=1)
    try:
        _post(router.url, {"prompt": PREFIX + [1], "max_new_tokens": 3})
        live = router.federated_metrics()
        stubs[1].healthy = False
        router._probe_all()
        with urllib.request.urlopen(router.url + "/metrics", timeout=10) as r:
            dead = r.read().decode()
        with urllib.request.urlopen(router.url + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        health.pop("uptime_s")
        return {"live": live, "dead": dead, "health": health}
    finally:
        router.shutdown()
        stubs.close()


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_affinity, sc_backpressure, sc_budget_exhaustion, sc_breaker,
    sc_breaker_cooldown, sc_deadline, sc_hedge, sc_stream_dispatch_failover,
    sc_dead_replica, sc_no_live_replica, sc_flap_damping,
    sc_staggered_probes, sc_federation)}


def _check(name, got):
    """The reference tests' assertions, on the port's result."""
    if name == "affinity":
        hits = {k: v for k, v in got["routed"].items()
                if k.endswith("|prefix_hit")}
        assert sum(hits.values()) >= 5 and len(hits) == 1, got["routed"]
    elif name == "backpressure":
        assert got["backpressure"]["r0"] >= 1 and got["healthy"] == 2
        assert got["outs"][2][0] == 429
    elif name == "budget_exhaustion":
        assert got["budget_exhausted"] >= 1 and got["availability"] == 0.0
        assert all(c in (502, 503) for c in got["codes"]), got["codes"]
    elif name == "breaker":
        assert got["posts"] == 2
    elif name == "deadline":
        assert got["outs"][0][0] == got["outs"][1][0] == 504
        assert got["deadline_rejected"] == 2 and got["first"][0] == 200
    elif name == "hedge":
        assert got["out"][1]["who"] == "fast"
        assert got["hedges"] == {"won": 1, "lost": 0}
        assert got["failovers"]["hedge"] == 1
    elif name == "stream_dispatch_failover":
        assert got["failovers"]["dispatch"] == 1
    elif name == "dead_replica":
        assert "r1|health_failover" in got["routed"], got["routed"]
    elif name == "flap_damping":
        alive = [a for a, _, _ in got["trail"]]
        assert alive == [True] + [False] * 6 + [True] * 4, got["trail"]
    elif name == "staggered_probes":
        assert got["order"] == ["r0", "r1", "r0", "r1"]
    elif name == "federation":
        text = got["live"]
        assert "paddle_router_requests_total" in text
        assert "# replica=r0" in text and "# replica=r1" in text
        assert "paddle_genserve_stub" in text and " DEAD" in got["dead"]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_routing_decisions_equal_the_reference(name):
    want = SCENARIOS[name](jrouter)
    got = SCENARIOS[name](prouter)
    if name == "federation":        # the stubs' ports differ between runs
        for d in (want, got):
            d["live"] = d["live"].replace(
                d["health"]["replicas"][0]["url"], "R0").replace(
                d["health"]["replicas"][1]["url"], "R1")
            d["dead"] = d["dead"].replace(
                d["health"]["replicas"][0]["url"], "R0").replace(
                d["health"]["replicas"][1]["url"], "R1")
            for r in d["health"]["replicas"]:
                r.pop("url")
    assert got == want
    _check(name, got)


@pytest.mark.parametrize("router_pkg", ["reference", "port"])
@pytest.mark.parametrize("coord_pkg", ["reference", "port"])
def test_epoch_eviction_and_readmission(router_pkg, coord_pkg):
    """Coordinator-declared death evicts on the epoch delta (probes still
    see the replica healthy); mark_live re-admits without a router restart,
    and a respawned rank rejoins at its fresh URL; each router against each
    package's coordinator."""
    R, C = ROUTERS[router_pkg], COORDS[coord_pkg]
    stubs = _Stubs({}, {}, {})
    coord = C.PodCoordinator(2, heartbeat_timeout_s=60.0).start()
    router = None
    trail = []

    def wait_for(cond):
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not cond():
            time.sleep(0.02)
        trail.append([(r.name, r.url == u, r.alive) for r, u in
                      zip(router.replicas, [stubs.urls[0], stubs.urls[1]])])
        return cond()

    try:
        kv = C.PodClient(coord.address, rank=-1)
        kv.kv_set("serving/replica/0/url", stubs.urls[0].encode())
        kv.kv_set("serving/replica/1/url", stubs.urls[1].encode())
        router = R.FleetRouter([], coord=coord.address, port=0, page_size=4,
                               probe_interval_s=30.0, dead_after=2,
                               membership_poll_s=0.05, **QUIET).start()
        assert sorted(r.name for r in router.replicas) == ["r0", "r1"]
        coord.mark_dead(0, "exit")
        assert wait_for(lambda: not router.replicas[0].alive)
        out = _post(router.url, {"prompt": PREFIX, "max_new_tokens": 3})
        assert out[0] == 200 and out[1]["who"] == "s1"
        coord.mark_live(0)
        assert wait_for(lambda: router.replicas[0].alive)
        # a respawn: rank 1 dies, comes back at another URL
        coord.mark_dead(1, "exit")
        assert wait_for(lambda: not router.replicas[1].alive)
        kv.kv_set("serving/replica/1/url", stubs.urls[2].encode())
        coord.mark_live(1)
        assert wait_for(lambda: router.replicas[1].alive
                        and router.replicas[1].url == stubs.urls[2])
        snap = router.metrics.snapshot()
        assert snap["membership_epoch"] == 4
        assert snap["replicas_healthy"] == 2
    finally:
        if router is not None:
            router.shutdown()
        coord.close()
        stubs.close()
    assert trail == [[("r0", True, False), ("r1", True, True)],
                     [("r0", True, True), ("r1", True, True)],
                     [("r0", True, True), ("r1", True, False)],
                     [("r0", True, True), ("r1", False, True)]]


# ---------------------------------------------------------------------------
# mid-stream failover end to end, against the reference fleet
# ---------------------------------------------------------------------------
GPT = dict(vocab_size=211, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0, attn_dropout=0.0)
GEN = dict(max_slots=2, max_seq_len=64, prompt_buckets="8,16", page_size=4)
PROMPT = [5, 17, 3, 9, 44, 120]      # 6 tokens: the 8 bucket
MAX_NEW = 12
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=5, seed=7)


class _FlakyGen(BaseHTTPRequestHandler):
    """A replica that computes the true stream through ``server.eng``
    (honouring resume_pos) but severs the connection after
    ``server.cut_after`` token events of its first request: the
    in-process stand-in for a SIGKILL mid-stream."""

    protocol_version = "HTTP/1.1"

    def do_GET(self):  # noqa: N802
        body = b'{"status": "ok"}'
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _chunk(self, obj):
        data = b"data: " + json.dumps(obj).encode() + b"\n\n"
        self.wfile.write(b"%X\r\n" % len(data) + data + b"\r\n")
        self.wfile.flush()

    def do_POST(self):  # noqa: N802
        p = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        tokens = self.server.eng.submit(
            p["prompt"], p.get("max_new_tokens", 32),
            do_sample=p.get("do_sample", False),
            temperature=p.get("temperature", 1.0), top_k=p.get("top_k", 0),
            seed=p.get("seed", 0),
            resume_pos=p.get("resume_pos", 0)).result(60)
        cut = None
        if not self.server.cut_done:
            self.server.cut_done = True
            cut = self.server.cut_after
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        for i, t in enumerate(tokens):
            if cut is not None and i >= cut:
                return  # no done event, no terminal chunk: severed
            self._chunk({"token": int(t)})
        self._chunk({"done": True, "tokens": len(tokens)})
        self.wfile.write(b"0\r\n\r\n")

    def log_message(self, *a):  # noqa: D102
        pass


@pytest.fixture(scope="module")
def fleets():
    """Per package: (oracle engine, survivor server, router module)."""
    paddle.seed(0)
    jm = JGPTForCausalLM(JGPTConfig(**GPT))
    jm.eval()
    pm = GPTForCausalLM(GPTConfig(**GPT), device="cpu")
    load_numpy_state(pm, {k: np.asarray(v.numpy())
                          for k, v in jm.state_dict().items()})
    pm.eval()
    jeng = JGenerationEngine(jm, **GEN).start()
    peng = GenerationEngine(pm, device="cpu", **GEN).start()
    jsrv = JServingServer(None, gen_engine=JGenerationEngine(jm, **GEN),
                          port=0, **QUIET).start()
    psrv = ServingServer(None, gen_engine=GenerationEngine(
        pm, device="cpu", **GEN), port=0, **QUIET).start()
    yield {"reference": (jeng, jsrv, jrouter), "port": (peng, psrv, prouter)}
    psrv.shutdown()
    jsrv.shutdown()
    peng.stop()
    jeng.stop()


def _cut_stream(fleet, kw, cut):
    """One SSE stream through a router over [a replica that dies after
    ``cut`` tokens, the survivor]: (tokens, done event, snapshot)."""
    eng, srv, R = fleet
    stub = ThreadingHTTPServer(("127.0.0.1", 0), _FlakyGen)
    stub.daemon_threads = True
    stub.eng, stub.cut_after, stub.cut_done = eng, cut, False
    threading.Thread(target=stub.serve_forever, args=(0.05,),
                     daemon=True).start()
    router = R.FleetRouter([f"http://127.0.0.1:{stub.server_address[1]}",
                            srv.url], port=0, page_size=4,
                           probe_interval_s=0.2, dead_after=2,
                           **QUIET).start()
    try:
        status, events = _post(router.url, {"prompt": PROMPT, "stream": True,
                                            "max_new_tokens": MAX_NEW, **kw})
        assert status == 200
        _settle(router)
        toks = [e["token"] for e in events if "token" in e]
        done = [e for e in events if e.get("done")]
        return toks, done, router.metrics.snapshot()
    finally:
        router.shutdown()
        stub.shutdown()
        stub.server_close()


@pytest.mark.parametrize("cut", [1, 5, 10],
                         ids=["cut1", "cut5-crosses-bucket", "cut10"])
def test_greedy_stream_resumes_bitwise(fleets, cut):
    """r0 dies after ``cut`` relayed tokens (6 + 5 = 11: the resumed prompt
    leaves the 8 bucket for 16): the client's stream is the uninterrupted
    greedy run bitwise, zero failed requests, and the same stream as the
    reference fleet's."""
    oracle = fleets["port"][0].submit(PROMPT, MAX_NEW).result(60)
    toks, done, snap = _cut_stream(fleets["port"], {}, cut)
    assert toks == oracle
    assert done[0]["tokens"] == MAX_NEW and "error" not in done[0]
    assert snap["failovers"]["mid_stream"] == 1
    assert snap["requests_failed"] == 0 and snap["availability_ratio"] == 1.0
    jtoks, jdone, jsnap = _cut_stream(fleets["reference"], {}, cut)
    assert toks == jtoks
    keys = ("routed", "failovers", "requests_ok", "requests_failed",
            "retry_budget_exhausted")
    assert {k: snap[k] for k in keys} == {k: jsnap[k] for k in keys}


def test_sampled_stream_resumes_on_the_same_chain(fleets):
    """Seeded sampling: the survivor continues the request's generator
    chain (the port engine's; the reference's threefry chain is another)."""
    eng = fleets["port"][0]
    kw = dict(SAMPLE)
    oracle = eng.submit(PROMPT, MAX_NEW, **kw).result(60)
    toks, done, snap = _cut_stream(fleets["port"], kw, 5)
    assert toks == oracle
    assert snap["failovers"]["mid_stream"] == 1


def test_done_event_carries_the_total_count(fleets):
    toks, done, _ = _cut_stream(fleets["port"], {}, 4)
    assert len(done) == 1 and done[0]["tokens"] == len(toks) == MAX_NEW
    assert done[0]["latency_ms"] is True
