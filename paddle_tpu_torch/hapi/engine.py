"""The training engine behind Model.fit (port of paddle_tpu/hapi/engine.py:
``_LossRing``, ``build_pure_train_step`` and ``TrainEngine`` on one
device).

The reference snapshots the training state into one device-resident
pytree and jits a donated step over it.  Eager PyTorch already keeps the
state on the card, in the module's parameters and the optimizer's
moments, and updates it in place; so here the engine keeps what the
reference's engine is for at run time: steps are issued without a host
sync, each loss stays on the card in the ``_LossRing``, and ``drain()``
brings every pending loss back in ONE device-to-host copy.  The step math
(forward, loss, backward, update) is one function,
:func:`build_train_step`, shared by ``Model.train_batch`` and the engine,
as the reference shares ``build_pure_train_step``.  Not ported yet
(ROADMAP.md): meshes and layouts, recompute, gradient accumulation, the
pod hooks, checkpoint state and the op report.
"""
from __future__ import annotations

import torch

__all__ = ["TrainEngine", "build_train_step", "to_device"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def to_device(xs, device):
    """Tensors (or array-likes) onto ``device``, without a host sync."""
    return [torch.as_tensor(x).to(device, non_blocking=True) for x in xs]


class _LossRing:
    """Loss scalars still on the card, awaiting one batched fetch.

    ``append`` never blocks; ``drain()`` copies everything pending to the
    host at once and returns python floats in step order."""

    def __init__(self):
        self._pending = []

    def append(self, dev_scalar):
        self._pending.append(dev_scalar.detach().float().reshape(()))

    def __len__(self):
        return len(self._pending)

    def drain(self):
        if not self._pending:
            return []
        out = torch.stack(self._pending).cpu().tolist()
        self._pending = []
        return out


def build_train_step(network, loss_layer, opt):
    """THE train-step math: ``step(inputs, labels) -> (loss, outs)`` runs
    the network in train mode, the loss (its mean), the backward, the
    optimizer's update and clears the gradients.  The loss is returned on
    the device, detached."""

    def step(inputs, labels):
        if not callable(loss_layer):
            raise RuntimeError("prepare() a loss before fit()")
        network.train()
        outs = network(*inputs)
        loss = loss_layer(*(_to_list(outs) + list(labels))).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach(), outs

    return step


class TrainEngine:
    """Owns the sync-free step loop for one Model across fit() runs.

    Lifecycle: ``begin()`` → N x ``step()`` (no host sync) → ``drain()``
    at log and epoch boundaries → ``finish()`` at fit exit."""

    def __init__(self, model):
        self.model = model
        self.ring = _LossRing()
        self._step_fn = None

    def begin(self):
        m = self.model
        if m._optimizer is None or m._loss is None:
            raise RuntimeError("prepare() an optimizer and a loss before "
                               "fit()")
        self._step_fn = build_train_step(m.network, m._loss, m._optimizer)
        self.ring = _LossRing()
        return self

    def step(self, inputs, labels):
        """Issue one train step WITHOUT a host sync.  The loss lands in the
        ring; returns the (device-resident) model outputs."""
        device = self.model.device
        loss, outs = self._step_fn(to_device(inputs, device),
                                   to_device(labels, device))
        self.ring.append(loss)
        return outs

    def drain(self):
        """Batched fetch of every pending loss (the sanctioned sync)."""
        return self.ring.drain()

    def finish(self):
        self._step_fn = None
