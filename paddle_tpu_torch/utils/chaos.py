"""Deterministic fault injection for the fault-tolerant runtime (port of
paddle_tpu/utils/chaos.py, the part the checkpoint and ``Model.fit``
paths and the serving fleet's drills call).

The recovery paths of ``Model.fit(fault_tolerant=True, resume=...)`` and
``distributed.checkpoint`` are tested through this layer rather than
mocks: the injectors fire at exact step numbers and call counts, so a
chaos test is reproducible bit for bit.

Two drive modes, composable:

* environment variables, read when the process first asks (subprocess
  tests use these):
      PADDLE_CHAOS_CRASH_STEP=N     raise ChaosCrash at step N
      PADDLE_CHAOS_SLOW_STEP=N      stall step N
      PADDLE_CHAOS_SLOW_SECONDS=S   ... for S seconds (default 30)
      PADDLE_CHAOS_PREEMPT_STEP=N   SIGTERM ourselves at step N
      PADDLE_CHAOS_FAIL_IO=K        the next K chaos-guarded IO calls
                                    raise OSError
      PADDLE_CHAOS_CKPT_TORN=K      the next K checkpoint commits die after
                                    the generation dir is renamed into
                                    place, before its COMMIT marker
      PADDLE_CHAOS_CKPT_BITFLIP=K   flip one bit in a payload file of the
                                    next K committed generations
      PADDLE_CHAOS_CKPT_ENOSPC=K    the next K checkpoint saves raise
                                    OSError(ENOSPC)
      PADDLE_CHAOS_CKPT_SLOW_IO=S   every checkpoint IO call stalls S
                                    seconds while set
      PADDLE_CHAOS_REPLICA_KILL=k@N serving drill: replica rank k
                                    SIGKILLs itself at decode iteration N
                                    (a mid-stream death the router must
                                    fail over)
      PADDLE_CHAOS_REPLICA_SLOW=k@N[:S]  replica rank k stalls EVERY
                                    decode iteration from N onward for S
                                    seconds (default 0.25): a sick but
                                    live replica; persistent
      PADDLE_CHAOS_REPLICA_PARTITION=k@N  replica rank k stops
                                    heartbeating to the fleet coordinator
                                    at iteration N while it goes on
                                    serving
* :func:`inject`, a context manager that pushes a config for the extent
  of a ``with`` block.

Step injections are one-shot: once fired at step N they are consumed
(but ``replica_slow``: a sick replica stays sick).  The replica dials
match their rank against this process's pod rank (``PADDLE_POD_RANK``,
else ``PADDLE_TRAINER_ID``, else 0) when they fire, so one environment
can be handed to every replica of a fleet.
Hook points: ``on_step(step)`` (may raise, sleep or signal the process;
the generation engine calls it before every decode and speculative step)
and ``on_io(label, path=None)`` (may raise OSError or ChaosTorn, stall,
or corrupt a committed generation under ``path`` and return normally).
"""
from __future__ import annotations

import contextlib
import errno
import logging
import os
import signal
import threading
import time

logger = logging.getLogger("paddle_tpu_torch.chaos")

__all__ = ["ChaosCrash", "ChaosTorn", "ChaosConfig", "inject", "on_step",
           "on_io", "active_config", "reset", "register_partition_hook",
           "pod_rank"]


class ChaosCrash(RuntimeError):
    """Raised by on_step() for crash-at-step-N injection; nothing catches
    it, so it kills the trainer as any unhandled exception would."""


class ChaosTorn(RuntimeError):
    """Raised by on_io('checkpoint.commit'): the save dies after the
    generation directory landed on disk but before its COMMIT marker, the
    in-process equivalent of a SIGKILL between the rename and the marker.
    Not an OSError, so the save's transient-IO retry does not catch it and
    commit the generation cleanly after all."""


class ChaosConfig:
    """Mutable fault plan.  The ``fail_io`` and ``ckpt_*`` budgets count
    down as faults fire (but ``ckpt_slow_io``, a stall applied while
    set)."""

    def __init__(self, crash_at_step=None, slow_step=None, slow_seconds=30.0,
                 preempt_at_step=None, fail_io=0, io_error=None, ckpt_torn=0,
                 ckpt_bitflip=0, ckpt_enospc=0, ckpt_slow_io=0.0,
                 replica_kill=None, replica_slow=None,
                 replica_partition=None):
        self.crash_at_step = crash_at_step
        self.slow_step = slow_step
        self.slow_seconds = float(slow_seconds)
        self.preempt_at_step = preempt_at_step
        self.fail_io = int(fail_io)
        self.io_error = io_error or OSError(
            "chaos: injected transient IO failure")
        self.ckpt_torn = int(ckpt_torn)
        self.ckpt_bitflip = int(ckpt_bitflip)
        self.ckpt_enospc = int(ckpt_enospc)
        self.ckpt_slow_io = float(ckpt_slow_io)
        # serving-fleet drills: (rank, step[, seconds]) triggers matched
        # against the pod rank at fire time; kill and partition are
        # one-shot, replica_slow persists
        self.replica_kill = replica_kill          # (rank, step)
        self.replica_slow = replica_slow          # (rank, step, seconds)
        self.replica_partition = replica_partition  # (rank, step)
        self.fired: list[str] = []  # audit trail for tests

    def is_noop(self):
        return (self.crash_at_step is None and self.slow_step is None
                and self.preempt_at_step is None and self.fail_io <= 0
                and self.ckpt_torn <= 0 and self.ckpt_bitflip <= 0
                and self.ckpt_enospc <= 0 and self.ckpt_slow_io <= 0
                and self.replica_kill is None and self.replica_slow is None
                and self.replica_partition is None)

    @classmethod
    def from_env(cls, environ=None):
        env = os.environ if environ is None else environ

        def _int(key):
            v = env.get(key)
            return int(v) if v not in (None, "") else None

        def _rank_at(key, with_seconds=False):
            """'rank@step', with ``with_seconds`` optionally ':seconds'."""
            v = env.get(key)
            if not v:
                return None
            secs = None
            if with_seconds and ":" in v:
                v, secs = v.rsplit(":", 1)
            rank, step = v.split("@", 1)
            out = (int(rank), int(step))
            if with_seconds:
                out += (float(secs) if secs is not None else None,)
            return out

        return cls(
            crash_at_step=_int("PADDLE_CHAOS_CRASH_STEP"),
            slow_step=_int("PADDLE_CHAOS_SLOW_STEP"),
            slow_seconds=float(env.get("PADDLE_CHAOS_SLOW_SECONDS", "30")),
            preempt_at_step=_int("PADDLE_CHAOS_PREEMPT_STEP"),
            fail_io=_int("PADDLE_CHAOS_FAIL_IO") or 0,
            ckpt_torn=_int("PADDLE_CHAOS_CKPT_TORN") or 0,
            ckpt_bitflip=_int("PADDLE_CHAOS_CKPT_BITFLIP") or 0,
            ckpt_enospc=_int("PADDLE_CHAOS_CKPT_ENOSPC") or 0,
            ckpt_slow_io=float(env.get("PADDLE_CHAOS_CKPT_SLOW_IO", "0")),
            replica_kill=_rank_at("PADDLE_CHAOS_REPLICA_KILL"),
            replica_slow=_rank_at("PADDLE_CHAOS_REPLICA_SLOW",
                                  with_seconds=True),
            replica_partition=_rank_at("PADDLE_CHAOS_REPLICA_PARTITION"),
        )


# the stack of active configs; index 0 is the environment's, parsed on
# first use so tests can set os.environ before
_lock = threading.Lock()
_stack: list[ChaosConfig] = []


def _base() -> ChaosConfig:
    if not _stack:
        _stack.append(ChaosConfig.from_env())
    return _stack[0]


def active_config() -> ChaosConfig:
    """The innermost config (the environment's without an inject())."""
    with _lock:
        _base()
        return _stack[-1]


def reset():
    """Drop all state (the partition hooks too); the environment is
    parsed again on next use."""
    with _lock:
        _stack.clear()
        _partition_hooks.clear()


@contextlib.contextmanager
def inject(**kwargs):
    """Push a ChaosConfig for the dynamic extent of the block:

        with chaos.inject(preempt_at_step=3, fail_io=1):
            model.fit(...)
    """
    cfg = ChaosConfig(**kwargs)
    with _lock:
        _base()
        _stack.append(cfg)
    try:
        yield cfg
    finally:
        with _lock:
            if cfg in _stack:
                _stack.remove(cfg)


def pod_rank() -> int:
    """This process's pod rank for rank-targeted drills (the fleet's
    PADDLE_POD_RANK first, PADDLE_TRAINER_ID second, 0 alone)."""
    return int(os.environ.get("PADDLE_POD_RANK",
                              os.environ.get("PADDLE_TRAINER_ID", "0")))


# callbacks a pod runtime registers so a partition drill can silence its
# heartbeats without this module importing the pod stack
_partition_hooks: list = []


def register_partition_hook(fn):
    """Register fn() to run when a partition drill fires on this rank (a
    replica registers its heartbeat thread's stop).  Cleared by
    reset()."""
    with _lock:
        _partition_hooks.append(fn)


def _fire_partition():
    with _lock:
        hooks = list(_partition_hooks)
    for fn in hooks:
        try:
            fn()
        except Exception:  # noqa: BLE001 - a drill must not crash the rank
            logger.exception("chaos: partition hook failed")


def on_step(step: int):
    """Step-boundary hook: may raise ChaosCrash, SIGTERM or SIGKILL the
    process, silence its heartbeats, or sleep.  Every trigger is one-shot
    but ``replica_slow``."""
    cfg = active_config()
    if cfg.is_noop():
        return
    if cfg.crash_at_step is not None and step == cfg.crash_at_step:
        cfg.crash_at_step = None
        cfg.fired.append(f"crash@{step}")
        logger.warning("chaos: crashing at step %d", step)
        raise ChaosCrash(f"chaos: injected crash at step {step}")
    if cfg.preempt_at_step is not None and step == cfg.preempt_at_step:
        cfg.preempt_at_step = None
        cfg.fired.append(f"preempt@{step}")
        logger.warning("chaos: SIGTERM self at step %d", step)
        os.kill(os.getpid(), signal.SIGTERM)
    if cfg.replica_kill is not None and step >= cfg.replica_kill[1] \
            and pod_rank() == cfg.replica_kill[0]:
        cfg.replica_kill = None
        cfg.fired.append(f"replica_kill@{step}")
        logger.warning("chaos: SIGKILL self (replica rank %d) at decode "
                       "iteration %d", pod_rank(), step)
        os.kill(os.getpid(), signal.SIGKILL)
    if cfg.replica_partition is not None \
            and step >= cfg.replica_partition[1] \
            and pod_rank() == cfg.replica_partition[0]:
        cfg.replica_partition = None
        cfg.fired.append(f"replica_partition@{step}")
        logger.warning("chaos: partitioning replica rank %d from decode "
                       "iteration %d (coordinator heartbeats stop; the "
                       "replica keeps serving)", pod_rank(), step)
        _fire_partition()
    if cfg.replica_slow is not None and step >= cfg.replica_slow[1] \
            and pod_rank() == cfg.replica_slow[0]:
        _, at, secs = cfg.replica_slow
        secs = 0.25 if secs is None else secs
        if not any(f.startswith("replica_slow@") for f in cfg.fired):
            cfg.fired.append(f"replica_slow@{step}")
            logger.warning("chaos: replica rank %d slow from iteration %d "
                           "(%.2fs per decode iteration, persistent)",
                           pod_rank(), at, secs)
        time.sleep(secs)  # not consumed: a sick replica stays sick
    if cfg.slow_step is not None and step == cfg.slow_step:
        cfg.slow_step = None
        cfg.fired.append(f"slow@{step}")
        logger.warning("chaos: stalling step %d for %.1fs", step,
                       cfg.slow_seconds)
        time.sleep(cfg.slow_seconds)


def _flip_one_bit(gen_dir: str):
    """Deterministic at-rest corruption: XOR one bit in the middle of the
    first payload file (sorted order) of a committed generation."""
    leaves_dir = os.path.join(gen_dir, "leaves")
    root = leaves_dir if os.path.isdir(leaves_dir) else gen_dir
    files = sorted(
        f for f in os.listdir(root)
        if os.path.isfile(os.path.join(root, f)) and f != "COMMIT")
    if not files:
        return None
    target = os.path.join(root, files[0])
    size = os.path.getsize(target)
    if size == 0:
        return None
    offset = size // 2
    with open(target, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0x01]))
    return target


def on_io(label: str = "io", path: str = None):
    """IO-call hook.  While the fail-IO budget is positive each call
    spends one and raises OSError.  The checkpoint injectors key on the
    label the save protocol passes:

    * ``checkpoint.save`` — the ENOSPC budget raises the persistent errno
      (never retried by the save path);
    * ``checkpoint.commit`` — the torn budget raises ChaosTorn after the
      generation dir is in place, before its COMMIT marker;
    * ``checkpoint.committed`` — the bitflip budget corrupts one bit of a
      payload file under ``path`` and returns normally;
    * every ``checkpoint*`` label stalls ``ckpt_slow_io`` seconds.
    """
    cfg = active_config()
    if label.startswith("checkpoint") and cfg.ckpt_slow_io > 0:
        logger.warning("chaos: stalling IO call %r for %.2fs", label,
                       cfg.ckpt_slow_io)
        time.sleep(cfg.ckpt_slow_io)
    if label == "checkpoint.commit" and cfg.ckpt_torn > 0:
        cfg.ckpt_torn -= 1
        cfg.fired.append(f"torn@{label}")
        logger.warning("chaos: tearing checkpoint commit (%d more)",
                       cfg.ckpt_torn)
        raise ChaosTorn("chaos: injected torn write — generation left "
                        "on disk without its COMMIT marker")
    if label == "checkpoint.committed" and cfg.ckpt_bitflip > 0 and path:
        cfg.ckpt_bitflip -= 1
        flipped = _flip_one_bit(path)
        cfg.fired.append(f"bitflip@{flipped or path}")
        logger.warning("chaos: flipped one bit in %s (%d more)", flipped,
                       cfg.ckpt_bitflip)
        return
    if label == "checkpoint.save" and cfg.ckpt_enospc > 0:
        cfg.ckpt_enospc -= 1
        cfg.fired.append(f"enospc@{label}")
        logger.warning("chaos: injecting ENOSPC on %r (%d more)", label,
                       cfg.ckpt_enospc)
        raise OSError(errno.ENOSPC,
                      "chaos: injected ENOSPC (persistent IO failure)")
    if cfg.fail_io > 0:
        cfg.fail_io -= 1
        cfg.fired.append(f"io@{label}")
        logger.warning("chaos: failing IO call %r (%d more to fail)",
                       label, cfg.fail_io)
        raise type(cfg.io_error)(*cfg.io_error.args)
