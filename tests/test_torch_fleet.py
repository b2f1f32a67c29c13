"""The port's serving fleet on the CPU: the pod coordinator
(paddle_tpu_torch/distributed/podcoord.py), the flight recorder
(monitor/flightrec.py), the replica dials of utils/chaos.py and the
engine's chaos seam, the replica process (``python -m
paddle_tpu_torch.serving.generation``) and the supervisor
(serving/fleet.py), beside the JAX package's where both exist.

* ``podcoord``: a client of either package against a coordinator of
  either package (four pairs) gives the same answers on the same script
  (KV set/get/delete and timeout, heartbeats, membership epochs,
  ``mark_dead``/``mark_live``, barrier, gather, report, the heartbeat
  timeout's death); ``FailureDetector`` on a fake clock gives the
  reference's answers step for step.
* ``chaos``: the replica dials parse from the same environment into the
  reference's tuples; the partition hook fires once; ``replica_slow``
  persists; the engine's seam SIGKILLs a replica process at its decode
  iteration (and not a replica of another rank).
* ``flightrec``: a dump (``drain``, and the excepthook's ``crash`` in a
  subprocess) has the reference's keys; ``ServingServer.shutdown()``
  records and dumps ``drain``.
* The replica: two processes from one ``--seed`` hold the same weights
  (digests); without ``--device cpu`` it raises where there is no CUDA.
* The supervisor: the drill (2 replica processes, the router on the
  coordinator, a SIGKILL mid-stream: the stream bitwise the undisturbed
  run, 0 failed requests, the victim respawned and re-admitted at its new
  URL, a ``replica_lost`` dump with ``down_s > 0``); a partitioned replica
  fenced and respawned; ``python -m paddle_tpu_torch.serving.fleet`` and
  ``python -m paddle_tpu_torch.serving.router`` with their parse lines
  and drains.

Every replica runs on the CPU with one thread (``OMP_NUM_THREADS=1``),
on port 0, and dies with the process that started it (``PR_SET_PDEATHSIG``
in the test's launcher); every wait has a deadline.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from conftest import cpu_subprocess_env
from paddle_tpu.distributed import podcoord as jpodcoord
from paddle_tpu.monitor import flightrec as jflightrec
from paddle_tpu.utils import chaos as jchaos
from paddle_tpu_torch.distributed import podcoord as ppodcoord
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.monitor import flightrec as pflightrec
from paddle_tpu_torch.serving.client import ServingClient
from paddle_tpu_torch.serving.fleet import ReplicaSupervisor
from paddle_tpu_torch.serving.generation import GenerationEngine
from paddle_tpu_torch.serving.router import FleetRouter
from paddle_tpu_torch.serving.server import ServingServer
from paddle_tpu_torch.utils import chaos as pchaos
from paddle_tpu_torch.utils.metrics import MetricsRegistry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COORDS = {"reference": jpodcoord, "port": ppodcoord}
PROMPT = list(range(3, 11))          # 8 tokens
MAX_NEW = 12
REPLICA = ["--port", "0", "--slots", "2", "--page-size", "4",
           "--prompt-buckets", "8,16,32", "--max-seq-len", "64",
           "--seed", "0", "--device", "cpu"]
# a replica process that dies with its parent, then runs the module as
# `python -m paddle_tpu_torch.serving.generation ARGV` would
LAUNCH = ("import ctypes, runpy, signal, sys; "
          "ctypes.CDLL(None).prctl(1, signal.SIGKILL); "
          "sys.argv = ['generation'] + sys.argv[1:]; "
          "runpy.run_module('paddle_tpu_torch.serving.generation', "
          "run_name='__main__', alter_sys=True)")


def _env(**extra):
    env = cpu_subprocess_env()
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _replica_cmd(*argv):
    return [sys.executable, "-c", LAUNCH, *REPLICA, *argv]


def _die_with_parent():
    import ctypes

    ctypes.CDLL(None).prctl(1, signal.SIGKILL)


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# podcoord: wire parity both ways, FailureDetector
# ---------------------------------------------------------------------------
def _coord_script(C, K):
    """The same operations from clients of package K against a coordinator
    of package C; returns every answer."""
    coord = C.PodCoordinator(2, heartbeat_timeout_s=0.3,
                             bringup_timeout_s=0.3).start()
    out = []
    try:
        kv = K.PodClient(coord.address, rank=-1)
        r0, r1 = K.PodClient(coord.address, 0), K.PodClient(coord.address, 1)
        kv.kv_set("a/b", b"\x00\x01bytes")
        out.append(kv.kv_get("a/b"))
        out.append(kv.kv_get("missing", timeout_s=0.1))
        kv.kv_delete("a/b")
        out.append(kv.kv_get("a/b", timeout_s=0.1))
        out.append(r0.heartbeat(step=3))
        out.append(r1.heartbeat())
        out.append(coord.last_step(0))

        def both(fn):
            res = [None, None]
            ts = [threading.Thread(target=lambda i=i, c=c: res.__setitem__(
                i, fn(c))) for i, c in enumerate((r0, r1))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(10)
            return res

        out.append(both(lambda c: c.barrier("start", timeout_s=5.0)))
        got = both(lambda c: c.gather("g", 0, b"part%d" % c.rank,
                                      meta={"r": c.rank}, timeout_s=5.0))
        out.append([list(g) for g in got])
        r1.report("resume", {"step": 7})
        out.append([(e["rank"], e["kind"], e["data"])
                    for e in coord.events()])
        out.append(kv.membership())
        coord.mark_dead(1, "exit")
        out.append(kv.membership())
        out.append(r0.heartbeat())
        coord.mark_live(1)
        out.append(kv.membership())
        with pytest.raises(K.PodPeerLost):
            coord.mark_dead(1, "partition")
            r1.barrier("after", timeout_s=1.0)
        coord.mark_live(1)
        r0.heartbeat()
        r1.heartbeat()
        time.sleep(0.45)             # both silent past the timeout
        out.append(coord.check_heartbeats())
        out.append(kv.membership())
        out.append(r0.epoch_seen)
    finally:
        coord.close()
    return out


def test_podcoord_speaks_the_references_wire_both_ways():
    runs = {(c, k): _coord_script(COORDS[c], COORDS[k])
            for c in COORDS for k in COORDS}
    want = runs[("reference", "reference")]
    for pair, got in runs.items():
        assert got == want, pair
    assert want[0] == b"\x00\x01bytes" and want[1] is None and want[2] is None
    assert want[-3] == {0: "heartbeat_timeout", 1: "heartbeat_timeout"}


FD_SCRIPTS = {
    "beats_and_timeout": [("t", 0.0), ("beat", 0, 1), ("beat", 1, -1),
                          ("t", 0.9), ("check",), ("beat", 0, 2), ("t", 1.5),
                          ("check",), ("t", 2.0), ("check",), ("beat", 1, 5),
                          ("check",)],
    "bringup_budget": [("t", 0.0), ("t", 5.0), ("check",), ("beat", 0, 0),
                       ("t", 9.0), ("check",), ("t", 12.5), ("check",)],
    "declare_and_revive": [("beat", 0, 4), ("declare", 1, "exit"),
                           ("declare", 1, "partition"), ("check",),
                           ("revive", 1), ("t", 3.0), ("check",),
                           ("t", 20.0), ("check",), ("revive", 0),
                           ("beat", 0, 9), ("check",)],
}


@pytest.mark.parametrize("script", sorted(FD_SCRIPTS))
def test_failure_detector_equals_the_reference(script):
    runs = []
    for C in (jpodcoord, ppodcoord):
        now = [0.0]
        fd = C.FailureDetector(3, timeout_s=1.0, clock=lambda: now[0],
                               bringup_timeout_s=10.0)
        trail = []
        for op, *a in FD_SCRIPTS[script]:
            if op == "t":
                now[0] = a[0]
            elif op == "beat":
                fd.beat(*a)
            elif op == "declare":
                fd.declare_dead(*a)
            elif op == "revive":
                fd.revive(*a)
            else:
                trail.append(fd.check())
            trail.append((fd.live(), fd.dead(),
                          [fd.last_step(r) for r in range(3)]))
        runs.append(trail)
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# chaos: the replica dials and the engine's seam
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kill,slow,part", [
    ("1@3", "0@2:0.5", "2@4"), ("0@0", "3@7", ""), ("", "", "5@11")])
def test_replica_dials_parse_as_the_reference(monkeypatch, kill, slow, part):
    monkeypatch.setenv("PADDLE_CHAOS_REPLICA_KILL", kill)
    monkeypatch.setenv("PADDLE_CHAOS_REPLICA_SLOW", slow)
    monkeypatch.setenv("PADDLE_CHAOS_REPLICA_PARTITION", part)
    want = jchaos.ChaosConfig.from_env()
    got = pchaos.ChaosConfig.from_env()
    for k in ("replica_kill", "replica_slow", "replica_partition"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.is_noop() == want.is_noop() == (not (kill or slow or part))


@pytest.mark.parametrize("rank,fires", [("0", True), ("1", False)])
def test_partition_dial_fires_its_hook_once(monkeypatch, rank, fires):
    monkeypatch.setenv("PADDLE_POD_RANK", rank)
    pchaos.reset()
    fired = []
    pchaos.register_partition_hook(lambda: fired.append(1))
    try:
        with pchaos.inject(replica_partition=(0, 2)) as cfg:
            for step in range(5):
                pchaos.on_step(step)
                assert fired == ([1] if fires and step >= 2 else [])
        assert cfg.fired == (["replica_partition@2"] if fires else [])
    finally:
        pchaos.reset()


def test_replica_slow_is_persistent(monkeypatch):
    monkeypatch.setenv("PADDLE_POD_RANK", "0")
    with pchaos.inject(replica_slow=(0, 1, 0.02)):
        t0 = time.monotonic()
        pchaos.on_step(0)
        fast = time.monotonic() - t0
        t0 = time.monotonic()
        for step in (1, 2, 3):
            pchaos.on_step(step)
        slow = time.monotonic() - t0
        assert pchaos.active_config().replica_slow == (0, 1, 0.02)
        assert pchaos.active_config().fired == ["replica_slow@1"]
    assert slow >= 0.06 > fast


def _start_replica(env, *argv):
    proc = subprocess.Popen(_replica_cmd(*argv), env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, preexec_fn=_die_with_parent)
    line = proc.stdout.readline().strip()
    assert line.startswith("paddle_tpu_torch.serving listening on "), \
        proc.stderr.read() if proc.poll() is not None else line
    return proc, line.rsplit(" ", 1)[1]


@pytest.mark.parametrize("rank,dies", [("0", True), ("1", False)])
def test_engine_seam_kills_the_replica_at_its_iteration(rank, dies):
    """PADDLE_CHAOS_REPLICA_KILL=0@3: replica rank 0 SIGKILLs itself at its
    engine's third decode iteration, mid-stream; rank 1 serves on."""
    proc, url = _start_replica(_env(PADDLE_CHAOS_REPLICA_KILL="0@3",
                                    PADDLE_POD_RANK=rank))
    try:
        toks, done = [], []
        try:
            for evt in ServingClient(url, timeout=60).generate_stream(
                    PROMPT, MAX_NEW):
                toks += [evt["token"]] if "token" in evt else []
                done += [evt] if evt.get("done") else []
        except OSError:
            pass                 # the connection died with the replica
        if dies:
            assert proc.wait(30) == -signal.SIGKILL
            # the first token comes from the prefill, then one a step: the
            # third iteration dies before its token (a token already made
            # may die unsent with the process)
            assert len(toks) <= 3 and not done
        else:
            assert len(toks) == MAX_NEW and done[0]["tokens"] == MAX_NEW
            assert proc.poll() is None
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(30) == 0


# ---------------------------------------------------------------------------
# flightrec
# ---------------------------------------------------------------------------
def _dump(mod, directory):
    rec = mod.FlightRecorder(directory=str(directory), max_records=4)
    for i in range(6):
        rec.record("span", name=f"s{i}", dur_ms=1.5)
    rec.record("drain", clean=True)
    path = rec.dump("drain", extra={"accounting": {"down_s": 1.25},
                                    "fleet": {"respawns": 1}})
    with open(path) as f:
        return os.path.basename(path), json.load(f)


def test_flightrec_dump_has_the_references_keys(tmp_path):
    jname, want = _dump(jflightrec, tmp_path / "ref")
    pname, got = _dump(pflightrec, tmp_path / "port")
    assert pname == jname == f"flightrec-{os.getpid()}.json"
    assert sorted(got) == sorted(want)
    assert got["version"] == want["version"] == 1
    assert got["reason"] == "drain" and got["accounting"] == {"down_s": 1.25}
    strip = [{k: v for k, v in r.items() if k != "ts"}
             for r in want["records"]]
    assert [{k: v for k, v in r.items() if k != "ts"}
            for r in got["records"]] == strip
    assert len(strip) == 4 and strip[-1] == {"kind": "drain", "clean": True}


_CRASH = """
import sys
from {pkg}.monitor import flightrec
flightrec.configure(sys.argv[1])
flightrec.install_hooks()
flightrec.record("step", n=1)
raise ValueError("boom")
"""


def test_flightrec_crash_dump_equals_the_references(tmp_path):
    docs = []
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", _CRASH.format(pkg=pkg), str(tmp_path / pkg)],
        env=_env(), cwd=ROOT, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, preexec_fn=_die_with_parent)
        for pkg in ("paddle_tpu", "paddle_tpu_torch")}
    for pkg, p in procs.items():
        _, stderr = p.communicate(timeout=120)
        assert p.returncode == 1 and "boom" in stderr
        (name,) = os.listdir(tmp_path / pkg)
        docs.append(json.loads((tmp_path / pkg / name).read_text()))
    want, got = docs
    assert got["reason"] == want["reason"] == "crash"
    assert sorted(got) == sorted(want)
    assert sorted(got["accounting"]) == sorted(want["accounting"])
    assert got["exception"]["type"] == want["exception"]["type"]
    assert [r["kind"] for r in got["records"]] \
        == [r["kind"] for r in want["records"]]


def test_server_drain_records_and_dumps(tmp_path):
    cfg = GPTConfig(vocab_size=211, hidden_size=32, num_layers=1,
                    num_heads=2, max_position_embeddings=32, dropout=0.0,
                    attn_dropout=0.0)
    eng = GenerationEngine(GPTForCausalLM(cfg, device="cpu"), device="cpu",
                           max_slots=2, max_seq_len=32, prompt_buckets="8")
    pflightrec.reset()
    pflightrec.configure(directory=str(tmp_path))
    try:
        srv = ServingServer(None, gen_engine=eng, port=0,
                            install_signal_handlers=False).start()
        assert len(ServingClient(srv.url).generate([3, 4], 3)["tokens"]) == 3
        assert srv.shutdown()
        doc = json.loads((tmp_path / f"flightrec-{os.getpid()}.json")
                         .read_text())
    finally:
        pflightrec.reset()
    assert doc["reason"] == "drain"
    assert {"kind": "drain", "clean": True} in [
        {k: v for k, v in r.items() if k != "ts"} for r in doc["records"]]


# ---------------------------------------------------------------------------
# the replica process
# ---------------------------------------------------------------------------
_DIGEST = """
import hashlib, sys
from paddle_tpu_torch.serving.generation import build_replica, replica_parser
eng = build_replica(replica_parser().parse_args(sys.argv[1:]))
h = hashlib.sha256()
for net in (eng.model, eng.draft_model):
    for k, v in sorted(net.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
print(h.hexdigest())
"""


def _digests(*seeds):
    """One subprocess a seed, all at once: each prints the digest of its
    replica's weights (the target's and the draft's)."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIGEST, "--device", "cpu", "--draft-layers",
         "1", "--seed", str(sd)], env=_env(), cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        preexec_fn=_die_with_parent) for sd in seeds]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stderr
        out.append(stdout.strip())
    return out


def test_two_replicas_of_one_seed_hold_the_same_weights():
    a, b, c = _digests(0, 0, 1)
    assert len(a) == 64 and a == b
    assert c != a


def test_replica_without_a_device_raises_where_there_is_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    r = subprocess.run([sys.executable, "-m",
                        "paddle_tpu_torch.serving.generation", "--port", "0"],
                       env=_env(), cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "RuntimeError" in r.stderr and "CUDA" in r.stderr
    assert "listening" not in r.stdout


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------
def test_sigkill_drill_resumes_respawns_and_readmits(tmp_path):
    """2 replica processes under ReplicaSupervisor, the router on its
    coordinator; SIGKILL the replica holding a stream after its 3rd token:
    the stream is the undisturbed run bitwise with 0 failed requests, the
    victim is respawned and re-admitted at its new URL through the epoch,
    and the replica_lost dump carries down_s > 0."""
    sup = ReplicaSupervisor(
        _replica_cmd(), 2, env=_env(), heartbeat_timeout_s=5.0,
        respawn_backoff_s=0.2, telemetry_dir=str(tmp_path / "telemetry"),
        log_dir=str(tmp_path / "logs"), registry=MetricsRegistry()).start()
    router = None
    try:
        assert sup.wait_ready(60), "fleet bring-up timed out"
        router = FleetRouter([], coord=sup.coord.address, port=0,
                             page_size=4, probe_interval_s=0.3, dead_after=3,
                             membership_poll_s=0.05,
                             install_signal_handlers=False).start()
        c = ServingClient(router.url, timeout=60.0)
        oracle = c.generate(PROMPT, MAX_NEW)["tokens"]
        assert len(oracle) == MAX_NEW
        toks, err, victim = [], None, None
        for evt in c.generate_stream(PROMPT, MAX_NEW):
            if "token" in evt:
                toks.append(evt["token"])
                if len(toks) == 3:
                    victim = max(router.replicas, key=lambda r: r.inflight)
                    old_url = victim.url
                    os.kill(sup.procs[int(victim.name[1:])].pid,
                            signal.SIGKILL)
            if evt.get("done"):
                err = evt.get("error")
        assert err is None, f"stream failed: {err}"
        assert toks == oracle, "resumed stream is not bitwise equal"
        snap = router.metrics.snapshot()
        assert snap["failovers"]["mid_stream"] >= 1
        assert snap["requests_failed"] == 0
        _wait(lambda: sup.respawn_count >= 1 and sup.wait_ready(0.1), 60,
              "the respawn")
        _wait(lambda: victim.alive and victim.url != old_url, 30,
              "the re-admission")
        assert victim.url == sup.replica_url(int(victim.name[1:]))
        assert router.metrics.snapshot()["membership_epoch"] >= 2
        assert sup.downs and sup.downs[0] > 0
        assert c.generate(PROMPT, MAX_NEW)["tokens"] == oracle
        dumps = [p for p in os.listdir(tmp_path / "telemetry")
                 if p.startswith("flightrec-")]
        assert dumps, "supervisor left no replica_lost dump"
        doc = json.loads((tmp_path / "telemetry" / dumps[0]).read_text())
        assert doc["reason"] == "replica_lost"
        assert doc["accounting"]["down_s"] > 0
        assert doc["fleet"]["respawns"] == 1
    finally:
        if router is not None:
            assert router.shutdown()
        assert sup.shutdown()
        pflightrec.reset()
    assert all(p.poll() is not None for p in sup.procs)


def test_a_partitioned_replica_is_fenced_and_respawned(tmp_path):
    """PADDLE_CHAOS_REPLICA_PARTITION=1@2: replica 1 stops heartbeating at
    its 2nd decode iteration while it goes on serving; the supervisor
    fences it (SIGKILL, reason partition) and respawns it."""
    reg = MetricsRegistry()
    sup = ReplicaSupervisor(
        _replica_cmd(), 2, env=_env(PADDLE_CHAOS_REPLICA_PARTITION="1@2"),
        heartbeat_timeout_s=2.0, respawn_backoff_s=0.1, registry=reg).start()
    try:
        assert sup.wait_ready(60)
        # replica 1 beats twice a second; until its first beat the detector
        # holds it to the bring-up budget, not the heartbeat timeout
        time.sleep(1.5)
        victim = sup.procs[1]
        out = ServingClient(sup.replica_url(1), timeout=60).generate(
            PROMPT, 4)
        assert len(out["tokens"]) == 4       # it answers while partitioned
        _wait(lambda: victim.poll() is not None, 30, "the fence")
        assert victim.returncode == -signal.SIGKILL
        _wait(lambda: sup.respawn_count >= 1 and sup.wait_ready(0.1), 60,
              "the respawn")
        lost = reg.snapshot()["paddle_fleet_replica_lost_total"]
        assert lost["partition"] == 1 and lost["exit"] == 0
        assert sup.procs[0].poll() is None
    finally:
        assert sup.shutdown()
        pflightrec.reset()


def _readline(proc, prefix, timeout=60):
    """The next stdout line of ``proc`` that starts with ``prefix``."""
    out = []
    t = threading.Thread(target=lambda: out.append(next(
        (ln for ln in proc.stdout if ln.startswith(prefix)), None)),
        daemon=True)
    t.start()
    t.join(timeout)
    assert out and out[0], f"no {prefix!r} line"
    return out[0].strip()


def test_fleet_and_router_command_lines(tmp_path):
    """`python -m paddle_tpu_torch.serving.fleet --world 1 -- <replica>`
    prints its coordinator and the replica's URL; `python -m
    paddle_tpu_torch.serving.router --coord` serves through it; SIGTERM
    drains both (exit 0, "router drain clean", "fleet drain clean")."""
    pre = dict(env=_env(), cwd=ROOT, text=True, stdout=subprocess.PIPE,
               preexec_fn=_die_with_parent)
    fleet = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.fleet", "--world",
         "1", "--telemetry-dir", str(tmp_path / "t"), "--", *_replica_cmd()],
        stderr=subprocess.DEVNULL, **pre)
    router = None
    try:
        coord = _readline(fleet, "paddle_tpu_torch.serving.fleet coord ")
        addr = coord.rsplit(" ", 1)[1]
        up = _readline(fleet, "paddle_tpu_torch.serving.fleet replica 0 up")
        _readline(fleet, "paddle_tpu_torch.serving.fleet supervising 1")
        router = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.router",
             "--coord", addr, "--page-size", "4"],
            stderr=open(tmp_path / "router.log", "w"), **pre)
        url = _readline(router, "paddle_tpu_torch.serving.router listening")
        url = url.rsplit(" ", 1)[1]
        out = ServingClient(url, timeout=60).generate(PROMPT, 5)
        assert len(out["tokens"]) == 5
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert [rep["url"] for rep in health["replicas"]] \
            == [up.rsplit(" ", 1)[1]]
        router.send_signal(signal.SIGTERM)
        assert router.wait(30) == 0
        assert "router drain clean" in (tmp_path / "router.log").read_text()
        fleet.send_signal(signal.SIGTERM)
        assert _readline(fleet, "fleet drain") == "fleet drain clean"
        assert fleet.wait(30) == 0
    finally:
        for p in (router, fleet):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
