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
"""
from __future__ import annotations

import torch

_generator = torch.Generator(device="cpu")
_generator.manual_seed(0)


def seed(s: int) -> torch.Generator:
    """Reseed the initialisation generator and torch's default generators
    (every device's); returns the former."""
    torch.manual_seed(int(s))
    return _generator.manual_seed(int(s))


def default_generator() -> torch.Generator:
    """The CPU generator parameter initialisers draw from."""
    return _generator


def dropout_seed() -> int:
    """A 64-bit seed for one attention call's dropout mask (the kernels
    regenerate the mask from it in the backward), drawn from the
    initialisation generator: deterministic under :func:`seed`, and a draw
    on the CPU, so it makes no device sync."""
    return int(torch.randint(0, 2 ** 63 - 1, (), dtype=torch.int64,
                             generator=_generator))


def make_generator(seed_value: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed_value``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed_value))
    return g
