"""Pod control plane (port of paddle_tpu/distributed/podcoord.py, whole):
a supervisor-hosted coordinator that survives rank death.

The serving fleet's supervisor (serving/fleet.py) hosts it: each replica
process registers its URL under ``serving/replica/<rank>/url`` and
heartbeats, and the fleet router subscribes to the membership epoch, so a
replica's death reaches the router as an epoch delta rather than a probe
timeout.  Its lifetime is not tied to any rank: any subset of ranks can die
and the survivors keep a working control plane.

Three roles in one TCP server (standard library only, length-prefixed JSON
header + raw payload frames, no pickling):

  * KV store + named barriers — the bootstrap/rendezvous primitives.
  * arbitrated collectives — `gather(name, seq, part)` blocks until every
    LIVE member of the current epoch has contributed, then freezes ONE
    result (the contributing parts + the epoch) that every caller of that
    (name, seq) observes, even callers that race a membership change.
    When a contributor dies mid-gather the release condition re-evaluates
    against the shrunk live set and the frozen result says `shrunk=True`.
  * heartbeat/membership failure detector — ranks beat with their step
    number; `FailureDetector` (pure logic, injectable clock, unit-testable
    with fake clocks) declares a rank dead after `timeout_s` of silence.
    The supervisor feeds process-exit events in directly (a SIGKILLed
    rank is declared dead immediately, no timeout wait) and marks
    heartbeat-silent-but-alive ranks as partitioned, then fences them.

Wire format (both directions), the reference's byte for byte, so a client
of either package speaks to a coordinator of the other:
    4-byte BE header length | header JSON (utf-8) | 8-byte BE payload
    length | payload bytes
"""
from __future__ import annotations

import json
import logging
import os
import socket
import socketserver
import struct
import threading
import time

logger = logging.getLogger("paddle_tpu_torch.podcoord")

__all__ = ["PodCoordinator", "PodClient", "FailureDetector", "PodPeerLost",
           "DEAD_EXIT", "DEAD_HEARTBEAT", "DEAD_PARTITION"]

# death classifications recorded in the membership table
DEAD_EXIT = "exit"                 # process observed dead (waitpid/SIGCHLD)
DEAD_HEARTBEAT = "heartbeat_timeout"   # silent past the detector timeout
DEAD_PARTITION = "partition"       # alive but unreachable -> fenced


class PodPeerLost(RuntimeError):
    """A collective/barrier could not complete because the pod shrank to
    exclude a required peer (or the coordinator itself went away)."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("pod coordinator connection closed")
        buf += chunk
    return buf


def _send_frame(sock: socket.socket, header: dict, payload: bytes = b""):
    hj = json.dumps(header).encode("utf-8")
    sock.sendall(struct.pack(">I", len(hj)) + hj +
                 struct.pack(">Q", len(payload)) + payload)


def _recv_frame(sock: socket.socket):
    hlen = struct.unpack(">I", _recv_exact(sock, 4))[0]
    header = json.loads(_recv_exact(sock, hlen).decode("utf-8"))
    plen = struct.unpack(">Q", _recv_exact(sock, 8))[0]
    payload = _recv_exact(sock, plen) if plen else b""
    return header, payload


class FailureDetector:
    """Heartbeat bookkeeping with an injectable clock.

    Pure logic — no threads, no sockets — so the unit tests drive it with
    a fake clock and assert exact declare-dead boundaries."""

    def __init__(self, world: int, timeout_s: float, clock=time.monotonic,
                 bringup_timeout_s: float = None):
        self.world = int(world)
        self.timeout_s = float(timeout_s)
        # a rank that has NEVER beaten is still importing/compiling — it
        # gets the (much longer) bring-up budget before being declared
        # dead, else a slow interpreter start reads as a death
        self.bringup_timeout_s = float(
            bringup_timeout_s if bringup_timeout_s is not None
            else max(timeout_s, 120.0))
        self._clock = clock
        now = clock()
        self._last_beat = {r: now for r in range(self.world)}
        self._last_step = {r: -1 for r in range(self.world)}
        self._beaten: set[int] = set()
        self._dead: dict[int, str] = {}

    def beat(self, rank: int, step: int = -1):
        if rank in self._dead:
            return  # a fenced/declared-dead rank cannot resurrect itself
        self._last_beat[rank] = self._clock()
        self._beaten.add(rank)
        if step >= 0:
            self._last_step[rank] = step

    def declare_dead(self, rank: int, reason: str):
        self._dead.setdefault(rank, reason)

    def check(self) -> dict[int, str]:
        """Newly-stale ranks since the last check, declared dead with
        reason DEAD_HEARTBEAT.  Returns {rank: reason} for NEW deaths."""
        now = self._clock()
        fresh = {}
        for r, t in self._last_beat.items():
            if r in self._dead:
                continue
            budget = (self.timeout_s if r in self._beaten
                      else self.bringup_timeout_s)
            if now - t > budget:
                self._dead[r] = DEAD_HEARTBEAT
                fresh[r] = DEAD_HEARTBEAT
        return fresh

    def live(self) -> list[int]:
        return [r for r in range(self.world) if r not in self._dead]

    def revive(self, rank: int):
        """Supervisor-authorized resurrection: a respawned replacement
        process re-enters the membership under the dead rank's id.  Only
        the supervisor may call this (it observed the new process start);
        a zombie's own heartbeat still cannot resurrect it — `beat`
        keeps refusing dead ranks.  The revived rank gets the bring-up
        budget again (fresh interpreter, fresh compile)."""
        self._dead.pop(rank, None)
        self._beaten.discard(rank)
        self._last_beat[rank] = self._clock()
        self._last_step[rank] = -1

    def dead(self) -> dict[int, str]:
        return dict(self._dead)

    def last_step(self, rank: int) -> int:
        return self._last_step.get(rank, -1)


class _Gather:
    """One arbitrated collective instance, keyed (name, seq)."""

    def __init__(self):
        self.parts: dict[int, tuple[dict, bytes]] = {}
        self.frozen = None  # (header, payload) once released
        self.fetched: set[int] = set()


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        coord: "PodCoordinator" = self.server.coordinator  # type: ignore
        try:
            header, payload = _recv_frame(self.request)
        except (ConnectionError, OSError):
            return
        try:
            resp, out = coord._dispatch(header, payload)
        except PodPeerLost as e:
            resp, out = {"ok": False, "error": "peer_lost",
                         "detail": str(e)}, b""
        except Exception as e:  # noqa: BLE001 - report, don't kill server
            logger.exception("pod coordinator op failed: %s", header)
            resp, out = {"ok": False, "error": type(e).__name__,
                         "detail": str(e)}, b""
        try:
            _send_frame(self.request, resp, out)
        except (ConnectionError, OSError):
            pass


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class PodCoordinator:
    """The supervisor-side server.  Thread-safe; the supervisor calls
    `mark_dead` / `check_heartbeats` directly (same process), ranks talk
    TCP via PodClient."""

    def __init__(self, world: int, heartbeat_timeout_s: float = 5.0,
                 clock=time.monotonic, host: str = "127.0.0.1",
                 port: int = 0, bringup_timeout_s: float = None):
        self.world0 = int(world)
        self._cond = threading.Condition()
        self.detector = FailureDetector(
            world, heartbeat_timeout_s, clock,
            bringup_timeout_s=bringup_timeout_s)
        self.epoch = 0
        self._kv: dict[str, bytes] = {}
        self._barriers: dict[str, set[int]] = {}
        self._gathers: dict[tuple[str, int], _Gather] = {}
        self._events: list[dict] = []  # rank reports (resume timestamps...)
        self._server = _Server((host, port), _Handler)
        self._server.coordinator = self
        self.address = "%s:%d" % self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="pod-coordinator",
            daemon=True)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._thread.start()
        return self

    def close(self):
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- membership (supervisor-facing) ------------------------------------
    def mark_dead(self, rank: int, reason: str):
        """Declare `rank` dead (process exit, fencing, ...) and bump the
        membership epoch; wakes every blocked barrier/gather so release
        conditions re-evaluate against the shrunk live set."""
        with self._cond:
            if rank in self.detector.dead():
                return
            self.detector.declare_dead(rank, reason)
            self.epoch += 1
            logger.warning("pod: rank %d declared dead (%s) -> epoch %d "
                           "live=%s", rank, reason, self.epoch, self.live())
            self._cond.notify_all()

    def mark_live(self, rank: int):
        """Supervisor-authorized re-admission of a respawned rank: the
        inverse of `mark_dead`, bumping the epoch so every membership
        subscriber (the fleet router) sees the replacement on the same
        delta channel it saw the death.  No-op if the rank is live."""
        with self._cond:
            if rank not in self.detector.dead():
                return
            self.detector.revive(rank)
            self.epoch += 1
            logger.info("pod: rank %d revived -> epoch %d live=%s",
                        rank, self.epoch, self.live())
            self._cond.notify_all()

    def check_heartbeats(self) -> dict[int, str]:
        """Run the staleness detector; any fresh deaths bump the epoch."""
        with self._cond:
            fresh = self.detector.check()
            if fresh:
                self.epoch += len(fresh)
                logger.warning("pod: heartbeat timeout for ranks %s -> "
                               "epoch %d", sorted(fresh), self.epoch)
                self._cond.notify_all()
            return fresh

    def live(self) -> list[int]:
        return self.detector.live()

    def events(self) -> list[dict]:
        with self._cond:
            return list(self._events)

    def last_step(self, rank: int) -> int:
        return self.detector.last_step(rank)

    # -- op dispatch (rank-facing, via TCP) --------------------------------
    def _dispatch(self, h: dict, payload: bytes):
        op = h.get("op")
        if op == "kv_set":
            with self._cond:
                self._kv[h["key"]] = payload
                self._cond.notify_all()
            return {"ok": True}, b""
        if op == "kv_get":
            deadline = time.monotonic() + h.get("timeout_ms", 10000) / 1e3
            with self._cond:
                while h["key"] not in self._kv:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return {"ok": True, "found": False}, b""
                    self._cond.wait(min(left, 0.2))
                return {"ok": True, "found": True}, self._kv[h["key"]]
        if op == "kv_delete":
            with self._cond:
                self._kv.pop(h["key"], None)
            return {"ok": True}, b""
        if op == "heartbeat":
            with self._cond:
                self.detector.beat(int(h["rank"]), int(h.get("step", -1)))
                return {"ok": True, "epoch": self.epoch,
                        "live": self.live()}, b""
        if op == "membership":
            with self._cond:
                return {"ok": True, "epoch": self.epoch,
                        "live": self.live(), "world0": self.world0,
                        "dead": {str(r): why for r, why in
                                 self.detector.dead().items()}}, b""
        if op == "report":
            with self._cond:
                self._events.append(
                    {"rank": int(h["rank"]), "kind": h["kind"],
                     "t": time.time(), "data": h.get("data", {})})
            return {"ok": True}, b""
        if op == "barrier":
            return self._barrier(h)
        if op == "gather":
            return self._gather(h, payload)
        return {"ok": False, "error": "unknown_op", "detail": op}, b""

    def _barrier(self, h: dict):
        name, rank = h["name"], int(h["rank"])
        deadline = time.monotonic() + h.get("timeout_ms", 30000) / 1e3
        with self._cond:
            arrived = self._barriers.setdefault(name, set())
            arrived.add(rank)
            self._cond.notify_all()
            epoch0 = self.epoch
            while True:
                live = set(self.live())
                if rank not in live:
                    raise PodPeerLost(f"barrier {name!r}: rank {rank} was "
                                      "declared dead")
                if live <= arrived:
                    # shrunk = membership changed while THIS caller
                    # waited — NOT "smaller than the original world":
                    # post-shrink steady state must read as clean
                    return {"ok": True, "epoch": self.epoch,
                            "shrunk": self.epoch != epoch0}, b""
                left = deadline - time.monotonic()
                if left <= 0:
                    raise PodPeerLost(
                        f"barrier {name!r} timed out waiting for ranks "
                        f"{sorted(live - arrived)}")
                self._cond.wait(min(left, 0.2))

    def _gather(self, h: dict, payload: bytes):
        name, seq, rank = h["name"], int(h["seq"]), int(h["rank"])
        key = (name, seq)
        deadline = time.monotonic() + h.get("timeout_ms", 30000) / 1e3
        with self._cond:
            g = self._gathers.setdefault(key, _Gather())
            if g.frozen is None:
                g.parts[rank] = (h.get("meta", {}), payload)
                self._cond.notify_all()
            epoch0 = self.epoch
            while g.frozen is None:
                live = set(self.live())
                if rank not in live:
                    raise PodPeerLost(f"gather {name}#{seq}: rank {rank} "
                                      "was declared dead")
                if live <= set(g.parts):
                    # freeze ONE result every caller observes: the live
                    # contributors' parts, in rank order
                    ranks = sorted(live & set(g.parts))
                    metas, blobs, offs = [], [], []
                    off = 0
                    for r in ranks:
                        meta, blob = g.parts[r]
                        metas.append(meta)
                        offs.append([off, len(blob)])
                        off += len(blob)
                        blobs.append(blob)
                    # shrunk = membership moved while the FREEZING caller
                    # waited (epoch delta) — post-shrink steady state
                    # must read clean, same contract as _barrier
                    g.frozen = ({"ok": True, "epoch": self.epoch,
                                 "shrunk": self.epoch != epoch0,
                                 "ranks": ranks, "metas": metas,
                                 "offsets": offs}, b"".join(blobs))
                    self._cond.notify_all()
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise PodPeerLost(
                        f"gather {name}#{seq} timed out waiting for ranks "
                        f"{sorted(live - set(g.parts))}")
                self._cond.wait(min(left, 0.2))
            header, blob = g.frozen
            g.fetched.add(rank)
            if set(self.live()) <= g.fetched:
                self._gathers.pop(key, None)  # every survivor has it
            return dict(header), blob


class PodClient:
    """Rank-side client.  One fresh localhost socket per op (no shared
    socket locking; ops are rare and local).  A background heartbeat
    thread keeps liveness flowing even during long steps — unless a chaos
    drill partitions this rank (PADDLE_CHAOS_REPLICA_PARTITION), in which
    case the thread stops beating and the supervisor fences us."""

    def __init__(self, address: str, rank: int,
                 heartbeat_interval_s: float = 0.5):
        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self.rank = int(rank)
        self._hb_interval = float(heartbeat_interval_s)
        self._hb_stop = threading.Event()
        self._hb_thread = None
        self._step = -1
        self.partitioned = False  # set by chaos; heartbeats stop
        self._epoch_seen = 0

    # -- framing -----------------------------------------------------------
    def _call(self, header: dict, payload: bytes = b"",
              timeout_s: float = 35.0):
        with socket.create_connection(self._addr, timeout=timeout_s) as s:
            s.settimeout(timeout_s)
            _send_frame(s, header, payload)
            resp, out = _recv_frame(s)
        if not resp.get("ok"):
            if resp.get("error") == "peer_lost":
                raise PodPeerLost(resp.get("detail", "pod peer lost"))
            raise RuntimeError("pod coordinator error: %s: %s" % (
                resp.get("error"), resp.get("detail")))
        return resp, out

    # -- ops ---------------------------------------------------------------
    def kv_set(self, key: str, value: bytes):
        self._call({"op": "kv_set", "key": key}, value)

    def kv_get(self, key: str, timeout_s: float = 10.0):
        resp, out = self._call(
            {"op": "kv_get", "key": key, "timeout_ms": int(timeout_s * 1e3)},
            timeout_s=timeout_s + 5)
        return out if resp.get("found") else None

    def kv_delete(self, key: str):
        self._call({"op": "kv_delete", "key": key})

    def barrier(self, name: str, timeout_s: float = 30.0):
        resp, _ = self._call(
            {"op": "barrier", "name": name, "rank": self.rank,
             "timeout_ms": int(timeout_s * 1e3)}, timeout_s=timeout_s + 5)
        return resp

    def gather(self, name: str, seq: int, part: bytes, meta: dict = None,
               timeout_s: float = 30.0):
        """Contribute `part` and block for the frozen result: (ranks,
        metas, payloads, epoch, shrunk)."""
        resp, blob = self._call(
            {"op": "gather", "name": name, "seq": seq, "rank": self.rank,
             "meta": meta or {}, "timeout_ms": int(timeout_s * 1e3)},
            part, timeout_s=timeout_s + 5)
        payloads = [blob[o:o + n] for o, n in resp["offsets"]]
        self._epoch_seen = max(self._epoch_seen, resp["epoch"])
        return resp["ranks"], resp["metas"], payloads, resp["epoch"], \
            resp["shrunk"]

    def heartbeat(self, step: int = -1):
        if self.partitioned:
            return None
        self._step = max(self._step, step)
        resp, _ = self._call({"op": "heartbeat", "rank": self.rank,
                              "step": self._step}, timeout_s=5.0)
        self._epoch_seen = max(self._epoch_seen, resp["epoch"])
        return resp

    def membership(self):
        resp, _ = self._call({"op": "membership"}, timeout_s=5.0)
        return resp

    def report(self, kind: str, data: dict = None):
        self._call({"op": "report", "rank": self.rank, "kind": kind,
                    "data": data or {}}, timeout_s=5.0)

    @property
    def epoch_seen(self) -> int:
        return self._epoch_seen

    # -- heartbeat thread --------------------------------------------------
    def start_heartbeats(self):
        if self._hb_thread is not None:
            return self

        def _loop():
            while not self._hb_stop.wait(self._hb_interval):
                try:
                    self.heartbeat()
                except (OSError, ConnectionError):
                    return  # supervisor is gone; nothing to beat at
        self._hb_thread = threading.Thread(
            target=_loop, name="pod-heartbeat", daemon=True)
        self._hb_thread.start()
        return self

    def stop_heartbeats(self):
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)
            self._hb_thread = None

    @classmethod
    def from_env(cls, environ=None) -> "PodClient | None":
        env = os.environ if environ is None else environ
        addr = env.get("PADDLE_POD_COORD")
        if not addr:
            return None
        rank = int(env.get("PADDLE_POD_RANK",
                           env.get("PADDLE_TRAINER_ID", "0")))
        return cls(addr, rank)
