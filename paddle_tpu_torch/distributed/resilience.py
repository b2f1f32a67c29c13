"""Fault-tolerant training runtime, the single-process part (port of
paddle_tpu/distributed/resilience.py).

A preemptible job's normal failure is SIGTERM with a grace period.  These
are the pieces ``Model.fit(fault_tolerant=True, resume=...)`` builds on:

* :func:`materialize` — a host copy of a tree of tensors, the snapshot a
  checkpoint writes (the training step updates the device state in
  place, so a save must copy it before the next step runs);
* :func:`is_transient_io_error`, :func:`backoff_delay` and
  :func:`retry_with_backoff` — the errno split and the one backoff
  formula of checkpoint-IO retries;
* :class:`PreemptionGuard` — latches SIGTERM/SIGINT so the loop finishes
  its step, writes an emergency checkpoint and exits with
  :data:`PREEMPTED_EXIT_CODE`;
* the distinct exit codes a launcher reads.

Every path is driven by deterministic fault injection
(``paddle_tpu_torch.utils.chaos``).
"""
from __future__ import annotations

import errno
import logging
import random
import signal
import time
from typing import Any, Callable

import torch

logger = logging.getLogger("paddle_tpu_torch.resilience")

__all__ = ["PREEMPTED_EXIT_CODE", "DURABILITY_EXIT_CODE", "backoff_delay",
           "is_transient_io_error", "materialize", "retry_with_backoff",
           "PreemptionGuard"]

# "preempted mid-training, checkpoint written, restart me" (75 =
# EX_TEMPFAIL), and a healthy run whose K consecutive checkpoint
# generations failed to persist
PREEMPTED_EXIT_CODE = 75
DURABILITY_EXIT_CODE = 91


def materialize(tree, copy: bool = True):
    """A tree (dicts, lists, tuples) of tensors with every tensor copied to
    the host, complete when the call returns, so a later in-place update
    of the source (the next step, or a replay of the captured step) cannot
    reach it.  A CUDA tensor is copied into page-locked memory (torch's
    caching host allocator, so later snapshots reuse the blocks an earlier
    one freed): every copy is issued on its device's current stream, after
    the steps issued so far, and then each such stream is synchronised
    once.  ``copy=False`` lets a CPU tensor through as it is (a view: only
    for bytes consumed before the source can change, the synchronous
    write).  Leaves that are no tensor are returned as they are."""
    streams = {}

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v) for v in node]
            return tuple(out) if isinstance(node, tuple) else out
        if not isinstance(node, torch.Tensor):
            return node
        t = node.detach()
        if t.device.type == "cpu":
            return t.clone() if copy else t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        streams.setdefault(t.device, torch.cuda.current_stream(t.device))
        return host

    out = walk(tree)
    for stream in streams.values():
        stream.synchronize()
    return out


# errnos no retrying fixes on the same path: a full, read-only or
# forbidden filesystem stays so on the backoff's timescale.  Everything
# else (EIO, network-filesystem blips, an OSError with no errno) is
# transient and worth the retry budget.
_PERSISTENT_IO_ERRNOS = frozenset(
    getattr(errno, name) for name in
    ("ENOSPC", "EDQUOT", "EROFS", "EACCES", "EPERM", "ENOTDIR", "EISDIR",
     "ENAMETOOLONG")
    if hasattr(errno, name))


def is_transient_io_error(exc) -> bool:
    """True for IO errors worth retrying (EIO, timeouts, errno-less
    OSErrors), False for persistent ones (ENOSPC, EROFS, EACCES, ...)
    that must escalate at once, and for anything that is no OSError."""
    if not isinstance(exc, OSError):
        return False
    return exc.errno not in _PERSISTENT_IO_ERRNOS


def backoff_delay(attempt: int, base_delay: float, max_delay: float = 30.0,
                  jitter: float = 0.5, rng=None) -> float:
    """Delay before retry ``attempt`` (0-based):
    ``min(max_delay, base_delay * 2**attempt) * (1 + jitter * U[0,1))``."""
    rng = rng if rng is not None else random.Random()
    delay = min(max_delay, base_delay * (2 ** attempt))
    return delay * (1.0 + jitter * rng.random())


def retry_with_backoff(fn: Callable[[], Any], retries: int = 3,
                       base_delay: float = 0.1, max_delay: float = 30.0,
                       jitter: float = 0.5, retry_on=(OSError,),
                       sleep=time.sleep, rng=None, label: str = None,
                       should_retry=None):
    """Call ``fn``; on a ``retry_on`` exception retry up to ``retries``
    more times, sleeping ``backoff_delay(i, ...)`` before retry i.
    ``should_retry(exc)`` False re-raises at once (pass
    :func:`is_transient_io_error` so ENOSPC escalates while EIO retries).
    ``sleep`` and ``rng`` are injectable for tests.  Raises the last
    exception once the retries are spent."""
    rng = rng if rng is not None else random.Random()
    name = label or getattr(fn, "__name__", "call")
    for attempt in range(retries + 1):
        try:
            return fn()
        except retry_on as e:
            if should_retry is not None and not should_retry(e):
                logger.error("%s failed (%s: %s) — not retryable, "
                             "escalating immediately", name,
                             type(e).__name__, e)
                raise
            if attempt >= retries:
                raise
            delay = backoff_delay(attempt, base_delay, max_delay, jitter,
                                  rng)
            logger.warning("%s failed (%s: %s) — retry %d/%d in %.2fs",
                           name, type(e).__name__, e, attempt + 1, retries,
                           delay)
            sleep(delay)


class PreemptionGuard:
    """Latches SIGTERM/SIGINT instead of dying mid-step.

    Inside the ``with`` block the signals set ``.preempted`` (the training
    loop finishes its step, checkpoints, then exits); the previous
    handlers come back on exit.  A second signal while one is latched goes
    to the previous handler, so a double SIGTERM still kills a stuck
    process."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._preempted = False
        self._announced = False
        self.signum = None
        self._prev = {}

    @property
    def preempted(self) -> bool:
        # the handler only latches (logging inside a signal handler can
        # deadlock on the logging module's locks); the first poll reports
        if self._preempted and not self._announced:
            self._announced = True
            logger.warning("preemption signal %s latched — will "
                           "checkpoint after the in-flight step",
                           self.signum)
        return self._preempted

    def _handler(self, signum, frame):
        if self._preempted:  # second signal: the old handler's turn
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
            else:
                raise KeyboardInterrupt
            return
        self.signum = signum
        self._preempted = True

    def __enter__(self):
        for s in self.signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:
                # off the main thread no handler can be installed; the
                # rest of the runtime still works
                logger.debug("cannot install handler for %s off the main "
                             "thread", s)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._prev.clear()
        return False
