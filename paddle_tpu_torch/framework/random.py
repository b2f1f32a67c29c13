"""Seeded RNG (port of paddle_tpu/framework/random.py).

JAX's splittable key chain becomes explicit ``torch.Generator`` objects.
Parameter initialisation draws from one CPU generator seeded by
:func:`seed`, so a model built from the same seed holds the same weights
whatever device it is moved to; attention dropout draws each call's seed
from it (:func:`dropout_seed`).  :func:`seed` also seeds torch's own
generators, which the hidden dropout (``F.dropout``) draws from, so a
training run is repeated bit for bit from the same seed.  Per-request sampling uses a generator of
its own on the engine's device (:func:`make_generator`).  The two
frameworks give different numbers from one seed; tests that compare them
carry weights over instead (models/convert.py).

The training engine's step (hapi/engine.py), captured once as a CUDA graph,
cannot take a new host seed for every attention call: it holds its
launches' parameters.  Its counterpart of the reference's per-step
``split_key`` is :class:`StepKeys`: inside a step, attention calls draw
:class:`StepSeed` values, a key fixed for the engine per call of the step
and the engine's step counter, which the kernels read from device memory
and the engine's host prologue advances once per executed step.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from .place import copy_to_device

_generator = torch.Generator(device="cpu")
_generator.manual_seed(0)
_local = threading.local()     # .keys: the StepKeys active on this thread


def seed(s: int) -> torch.Generator:
    """Reseed the initialisation generator and torch's default generators
    (every device's); returns the former."""
    torch.manual_seed(int(s))
    return _generator.manual_seed(int(s))


def default_generator() -> torch.Generator:
    """The CPU generator parameter initialisers draw from."""
    return _generator


def dropout_seed():
    """The seed of one attention call's dropout mask (the kernels
    regenerate the mask from it in the backward): inside a training
    engine's step (a :class:`StepKeys` scope on this thread) the call's
    :class:`StepSeed`, else a 64-bit int drawn from the initialisation
    generator.  Deterministic under :func:`seed`; a draw on the CPU, so it
    makes no device sync."""
    keys = getattr(_local, "keys", None)
    return _draw() if keys is None else keys.next()


def _draw() -> int:
    return int(torch.randint(0, 2 ** 63 - 1, (), dtype=torch.int64,
                             generator=_generator))


class StepSeed(NamedTuple):
    """An attention call's seed inside a training engine's step: the
    call's 64-bit Philox key and ``counter``, an int32 [1] tensor on the
    step's device whose value (as a 32-bit word) is the Philox counter's
    fourth word, read by the kernels when they run.  An int seed ``s`` is
    ``StepSeed(s, counter holding 0)``."""
    key: int
    counter: torch.Tensor


class StepKeys:
    """A training engine's dropout state, its counterpart of the
    reference's ``split_key`` for each step.  The i-th attention call of
    every step keys its mask with ``keys[i]`` (drawn from the
    initialisation generator by the first step that makes an i-th call,
    then fixed), and every call reads ``counter``, which :meth:`advance`
    sets to the next step number in the step's host prologue.  So one
    captured CUDA graph draws new masks at every replay, and no two steps
    of the engine draw one mask (their counters differ)."""

    def __init__(self, device):
        self.keys: list[int] = []
        self.step = 0
        self.counter = torch.zeros(1, dtype=torch.int32,
                                   device=torch.device(device))
        self._calls = 0

    def advance(self):
        """The host prologue's part: the next step number into the counter,
        on the current stream, without a host sync."""
        self.step += 1
        word = self.step % 2 ** 32          # the kernels read a uint32
        copy_to_device(self.counter,
                       [word - 2 ** 32 if word >= 2 ** 31 else word])

    def next(self) -> StepSeed:
        i = self._calls
        self._calls += 1
        if i == len(self.keys):
            self.keys.append(_draw())
        return StepSeed(self.keys[i], self.counter)

    @contextlib.contextmanager
    def scope(self):
        """While active (on this thread), :func:`dropout_seed` hands out
        this step's seeds, from call 0."""
        prev, _local.keys, self._calls = getattr(_local, "keys", None), \
            self, 0
        try:
            yield self
        finally:
            _local.keys = prev


def make_generator(seed_value: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed_value``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed_value))
    return g
