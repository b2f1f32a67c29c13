"""Serving fleet supervisor (port of paddle_tpu/serving/fleet.py, whole):
spawn N generation replicas, watch them, respawn the dead, account the
downtime.

A lost replica is capacity to restore.  The supervisor

  * hosts the `PodCoordinator` (distributed/podcoord.py) — each replica
    process registers its URL under ``serving/replica/<rank>/url`` and
    heartbeats (serving/generation.py main() does both when
    PADDLE_POD_COORD is set), and the fleet router subscribes to the same
    coordinator (``--coord``) so replica death reaches the router as an
    EPOCH DELTA, not a probe timeout;
  * watches process exits (a SIGKILLed replica is declared dead the next
    poll) and heartbeats (a silent-but-serving replica — the
    PADDLE_CHAOS_REPLICA_PARTITION drill — is fenced with SIGKILL so it
    cannot keep answering requests the router thinks it lost);
  * respawns dead replicas with jittered backoff
    (`FLAGS_fleet_respawn_backoff_s`): delete the corpse's URL key,
    spawn a fresh process under the SAME rank, wait for the new
    registration, then `mark_live` — which bumps the epoch so the router
    re-admits the replacement on the same delta channel it saw the
    death;
  * accounts every death→respawned gap: a flight-recorder dump
    (monitor/flightrec.py) with reason ``replica_lost`` carrying the
    CUMULATIVE ``down_s`` (later dumps overwrite earlier ones per
    path+mtime, so the running total is what a goodput ledger must see),
    in the reference's dump format.

On the card each replica is a process with its own CUDA context; the
supervisor itself touches no device.

Parse-friendly stdout lines:

    paddle_tpu_torch.serving.fleet coord <host:port>
    paddle_tpu_torch.serving.fleet replica <rank> up at <url>
    paddle_tpu_torch.serving.fleet replica <rank> lost (<reason>)
    paddle_tpu_torch.serving.fleet replica <rank> respawned at <url> down=<s>s
    fleet drain clean
"""
from __future__ import annotations

import logging
import os
import random
import signal
import subprocess
import sys
import threading
import time

from ..distributed.podcoord import (DEAD_EXIT, DEAD_PARTITION,
                                    PodCoordinator, PodClient)
from ..distributed.resilience import PreemptionGuard
from ..framework import flags as _flags
from ..monitor import flightrec
from ..utils.metrics import default_registry

logger = logging.getLogger("paddle_tpu_torch.serving.fleet")

__all__ = ["ReplicaSupervisor", "LOST_REASONS"]

LOST_REASONS = (DEAD_EXIT, "heartbeat_timeout", DEAD_PARTITION, "drain")

# per-rank lifecycle states
_UP = "up"                  # process running, URL registered, marked live
_WAIT_URL = "waiting_url"   # process spawned, registration pending
_BACKOFF = "backoff"        # dead; respawn scheduled at respawn_at
_FAILED = "failed"          # respawn budget exhausted; stays down


class ReplicaSupervisor:
    """Own the serving fleet's lifecycle: coordinator + N replica
    processes + the respawn loop.  `cmd` is the full argv of ONE replica
    (typically ``[sys.executable, "-m",
    "paddle_tpu_torch.serving.generation", ...]``); each rank gets
    PADDLE_POD_COORD/RANK/WORLD on top of `env`."""

    def __init__(self, cmd, world, *, env=None, heartbeat_timeout_s=2.0,
                 respawn_backoff_s=None, max_respawns=None,
                 telemetry_dir=None, log_dir=None, registry=None,
                 poll_interval_s=0.05, install_signal_handlers=False):
        self.cmd = list(cmd)
        self.world = int(world)
        self.env = dict(env or {})
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.respawn_backoff_s = float(
            respawn_backoff_s if respawn_backoff_s is not None
            else _flags.flag("FLAGS_fleet_respawn_backoff_s", 0.5))
        self.max_respawns = max_respawns  # None = unlimited
        self.telemetry_dir = telemetry_dir
        self.log_dir = log_dir
        self.poll_interval_s = float(poll_interval_s)
        self._install_signals = install_signal_handlers
        reg = registry if registry is not None else default_registry()
        self._m_lost = reg.counter(
            "paddle_fleet_replica_lost_total",
            "serving replicas lost by the supervisor, by reason",
            label="reason", preset=LOST_REASONS, fixed=True)
        self._m_respawns = reg.counter(
            "paddle_fleet_replica_respawns_total",
            "serving replicas respawned by the supervisor")
        self._g_live = reg.gauge(
            "paddle_fleet_live_replicas",
            "replicas the supervisor believes up and registered")
        self.coord = None
        self._kv = None            # supervisor-side PodClient (rank -1)
        self.procs: list = [None] * self.world
        self._state = [_WAIT_URL] * self.world
        self._respawn_at = [0.0] * self.world
        self._t_dead = [None] * self.world
        self._respawns = [0] * self.world
        self.urls: list = [None] * self.world
        self.downs: list[float] = []   # every death→respawned gap, s
        self._down_total = 0.0
        self._logs = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._drain_done = threading.Event()
        self._drain_clean = True
        self._thread = None
        self._guard = None
        self.draining = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ReplicaSupervisor":
        if self.telemetry_dir:
            flightrec.configure(directory=self.telemetry_dir)
        self.coord = PodCoordinator(
            self.world,
            heartbeat_timeout_s=self.heartbeat_timeout_s).start()
        # rank -1: kv access without joining the membership
        self._kv = PodClient(self.coord.address, rank=-1)
        print(f"paddle_tpu_torch.serving.fleet coord "  # parse contract
              f"{self.coord.address}", flush=True)
        if self._install_signals:
            self._guard = PreemptionGuard()
            self._guard.__enter__()
        for r in range(self.world):
            self._spawn(r)
        self._thread = threading.Thread(target=self._watch_loop,
                                        daemon=True,
                                        name="paddle-fleet-watch")
        self._thread.start()
        return self

    def _spawn(self, r: int):
        e = dict(os.environ)
        e.update(self.env)
        e.update({"PADDLE_POD_COORD": self.coord.address,
                  "PADDLE_POD_RANK": str(r),
                  "PADDLE_POD_WORLD": str(self.world),
                  "PADDLE_TRAINER_ID": str(r)})
        if self.telemetry_dir:
            e["FLAGS_TELEMETRY_DIR"] = os.path.join(
                os.path.abspath(self.telemetry_dir), f"replica{r}")
        out = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            out = open(os.path.join(
                self.log_dir,
                f"replica{r}.{self._respawns[r]}.log"), "wb")
            self._logs.append(out)
        self.procs[r] = subprocess.Popen(
            self.cmd, env=e, stdout=out or subprocess.DEVNULL,
            stderr=subprocess.STDOUT if out else subprocess.DEVNULL)
        self._state[r] = _WAIT_URL

    def wait_ready(self, timeout_s: float = 120.0) -> bool:
        """Block until every replica has registered (initial bring-up)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if all(s == _UP for s in self._state):
                    return True
            if self._stop.is_set():
                return False
            time.sleep(0.05)
        return False

    def replica_url(self, r: int):
        with self._lock:
            return self.urls[r]

    @property
    def respawn_count(self) -> int:
        return sum(self._respawns)

    # -- the watch loop ----------------------------------------------------
    def _watch_loop(self):
        while not self._stop.is_set():
            if self._guard is not None and self._guard.preempted:
                logger.warning("signal %s latched — draining fleet",
                               self._guard.signum)
                self.shutdown()
                return
            self._poll_once()
            time.sleep(self.poll_interval_s)

    def _poll_once(self):
        now = time.monotonic()
        # 1. process exits
        for r in range(self.world):
            if self._state[r] in (_BACKOFF, _FAILED):
                continue
            p = self.procs[r]
            if p is not None and p.poll() is not None:
                self._on_death(r, DEAD_EXIT, now)
        # 2. heartbeat silence: fence alive-but-silent replicas (the
        #    partition drill) so they cannot keep serving after eviction
        for r, why in self.coord.check_heartbeats().items():
            if self._state[r] in (_BACKOFF, _FAILED):
                continue
            p = self.procs[r]
            if p is not None and p.poll() is None:
                p.kill()
                self._on_death(r, DEAD_PARTITION, now)
            else:
                self._on_death(r, why, now)
        # 3. due respawns
        for r in range(self.world):
            if self._state[r] == _BACKOFF and now >= self._respawn_at[r]:
                self._m_respawns.inc()
                self._respawns[r] += 1
                logger.info("fleet: respawning replica %d (attempt %d)",
                            r, self._respawns[r])
                self._spawn(r)
        # 4. pending registrations
        for r in range(self.world):
            if self._state[r] != _WAIT_URL:
                continue
            try:
                raw = self._kv.kv_get(f"serving/replica/{r}/url",
                                      timeout_s=0.05)
            except (OSError, TimeoutError, RuntimeError):
                continue
            if not raw:
                continue
            url = raw.decode("utf-8")
            with self._lock:
                self.urls[r] = url
                self._state[r] = _UP
            if self._t_dead[r] is not None:
                gap = now - self._t_dead[r]
                self._t_dead[r] = None
                with self._lock:
                    self.downs.append(gap)
                    self._down_total += gap
                # re-admit on the router's epoch channel only AFTER the
                # new URL is registered — a revive before registration
                # would hand the router the corpse's stale URL
                self.coord.mark_live(r)
                flightrec.dump("replica_lost", extra={
                    "accounting": {"down_s": round(self._down_total, 3)},
                    "fleet": {"downs": [round(d, 3)
                                        for d in self.downs],
                              "respawns": self.respawn_count}})
                print(f"paddle_tpu_torch.serving.fleet replica {r} "
                      f"respawned at {url} down={gap:.3f}s",
                      flush=True)  # parse contract
            else:
                print(f"paddle_tpu_torch.serving.fleet replica {r} "
                      f"up at {url}", flush=True)  # parse contract
            self._update_live()

    def _on_death(self, r: int, reason: str, now: float):
        if self.draining:
            return
        self._m_lost.inc(reason)
        if self._t_dead[r] is None:
            self._t_dead[r] = now
        # drop the corpse's registration NOW so the eventual respawn's
        # kv_get cannot match the old URL
        try:
            self._kv.kv_delete(f"serving/replica/{r}/url")
        except (OSError, RuntimeError):
            pass
        self.coord.mark_dead(r, reason)
        # the death dump: the goodput ledger sees the outage even if the
        # supervisor dies before the respawn completes
        flightrec.dump("replica_lost", extra={
            "accounting": {"down_s": round(self._down_total, 3)},
            "fleet": {"lost_rank": r, "reason": reason}})
        print(f"paddle_tpu_torch.serving.fleet replica {r} lost "
              f"({reason})", flush=True)  # parse contract
        if self.max_respawns is not None \
                and self._respawns[r] >= self.max_respawns:
            logger.error("fleet: replica %d exhausted its %d respawns — "
                         "staying down", r, self.max_respawns)
            self._state[r] = _FAILED
            self._update_live()
            return
        backoff = self.respawn_backoff_s * (0.5 + random.random())
        self._respawn_at[r] = now + backoff
        self._state[r] = _BACKOFF
        logger.warning("fleet: replica %d lost (%s) — respawn in %.2fs",
                       r, reason, backoff)
        self._update_live()

    def _update_live(self):
        self._g_live.set(sum(1 for s in self._state if s == _UP))

    # -- shutdown ----------------------------------------------------------
    def shutdown(self, timeout_s: float = 15.0) -> bool:
        """Drain: SIGTERM every replica (they latch-drain and exit 0),
        wait, then close the coordinator.  Idempotent; True = every
        supervised replica exited cleanly."""
        with self._lock:
            if self.draining:
                # another caller owns the drain: wait for it to finish
                already = True
            else:
                self.draining = True
                already = False
        if already:
            self._drain_done.wait(timeout_s + 10.0)
            return self._drain_clean
        self._stop.set()
        if self._thread is not None \
                and threading.current_thread() is not self._thread:
            self._thread.join(5.0)
        clean = True
        for r, p in enumerate(self.procs):
            if p is None or p.poll() is not None:
                continue
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            if p is None:
                continue
            left = max(0.1, deadline - time.monotonic())
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                p.kill()
                clean = False
        if self.coord is not None:
            self.coord.close()
        for f in self._logs:
            try:
                f.close()
            except OSError:
                pass
        if self._guard is not None:
            self._guard.__exit__(None, None, None)
            self._guard = None
        print("fleet drain %s"  # parse contract
              % ("clean" if clean else "TIMED OUT"), flush=True)
        self._drain_clean = clean
        self._drain_done.set()
        return clean

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="paddle_tpu_torch serving fleet supervisor: "
                    "coordinator + N replica processes with "
                    "respawn-on-death",
        usage="python -m paddle_tpu_torch.serving.fleet --world N [opts] "
              "-- <replica argv...>")
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--heartbeat-timeout", type=float, default=2.0)
    parser.add_argument("--backoff", type=float, default=None,
                        help="respawn backoff base seconds (default: "
                             "FLAGS_fleet_respawn_backoff_s)")
    parser.add_argument("--max-respawns", type=int, default=None)
    parser.add_argument("--telemetry-dir", default=None)
    parser.add_argument("--log-dir", default=None)
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="replica argv after --")
    args = parser.parse_args(argv)
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("need a replica command after --")

    logging.basicConfig(level=logging.INFO)
    sup = ReplicaSupervisor(
        cmd, args.world, heartbeat_timeout_s=args.heartbeat_timeout,
        respawn_backoff_s=args.backoff, max_respawns=args.max_respawns,
        telemetry_dir=args.telemetry_dir, log_dir=args.log_dir,
        install_signal_handlers=True).start()
    if not sup.wait_ready():
        logger.error("fleet bring-up timed out")
        sup.shutdown()
        return 1
    print(f"paddle_tpu_torch.serving.fleet supervising {args.world} "
          "replicas", flush=True)
    # run until a latched signal drains us (the watch thread handles it)
    try:
        while not sup._stop.wait(0.2):
            pass
    except KeyboardInterrupt:
        pass
    sup.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
