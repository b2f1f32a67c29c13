"""Optimizers (port of paddle_tpu/optimizer/__init__.py: the ``Optimizer``
base with its eager ``step``, ``SGD``, ``Momentum``, ``Adam`` and
``AdamW``).

Each optimizer is one update rule
    _update(param, grad, slots, lr, t) -> (new_param, new_slots)
written with the reference's arithmetic in the reference's order, so the
rounding is the same: Adam-family moments are float32 whatever the
parameter's dtype, the step ``t`` enters the bias corrections as a
float32, the update is cast to the parameter's dtype before it is
subtracted, and AdamW's decoupled decay subtracts ``lr * wd * p_old``
afterwards.

The update is written IN PLACE into the module's own parameters (and the
moments are kept per parameter): PyTorch runs eagerly on the parameters
the model holds, so there is no parameter pytree to return.  The
reference's functional ``init_pytree``/``apply_pytree`` and their
donation contract (jit with ``donate_argnums`` so XLA aliases the state
buffers) have no counterpart here and are not ported.  Not ported yet
(ROADMAP.md): Adagrad, Adamax, Adadelta, RMSProp, Lamb, LarsMomentum, Ftrl,
Dpsgd, the wrappers, regularizer objects as ``weight_decay`` and AdamW's
``apply_decay_param_fun`` (both need parameter names, which torch
parameters do not carry).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import lr  # noqa: F401
from .lr import LRScheduler


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        self._learning_rate = learning_rate
        self._parameter_list = list(parameters) \
            if parameters is not None else None
        self._grad_clip = grad_clip
        self._weight_decay = float(weight_decay or 0.0)
        # per-parameter slot storage keyed by id(param)
        self._slots: dict[int, dict[str, Any]] = {}
        self._step_count = 0

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    @property
    def _lr_scheduler(self):
        return self._learning_rate \
            if isinstance(self._learning_rate, LRScheduler) else None

    # -- update rule (override) -------------------------------------------
    def _slot_names(self) -> list[str]:
        return []

    def _init_slot(self, name: str, p) -> Any:
        return torch.zeros_like(p)

    def _update(self, p, g, slots: dict, lr, t):
        """p/g tensors, slots dict of tensors, lr a float, t the step;
        returns (new_p, new_slots) without touching p."""
        raise NotImplementedError

    # -- eager path --------------------------------------------------------
    def _get_slots(self, p) -> dict:
        key = id(p)
        if key not in self._slots:
            self._slots[key] = {n: self._init_slot(n, p.detach())
                                for n in self._slot_names()}
        return self._slots[key]

    @torch.no_grad()
    def step(self):
        self._step_count += 1
        params = self._parameter_list or []
        params_grads = [(p, p.grad) for p in params
                        if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        for p, g in params_grads:
            if g is None:
                continue
            slots = self._get_slots(p)
            g = g.to(p.dtype) if g.dtype != p.dtype else g
            g = self._apply_decay(p, g)
            new_p, new_slots = self._update(p, g, slots, lr,
                                            self._step_count)
            p.copy_(new_p)
            self._slots[id(p)] = new_slots

    def _apply_decay(self, p, g):
        """Coupled decay (fluid regularizer semantics); AdamW overrides."""
        wd = self._weight_decay
        return g + wd * p if wd else g

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list or []:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    # -- checkpointing ----------------------------------------------------
    # slots are keyed by the parameter's index in the list (the reference
    # uses the parameter's name where it has one; torch parameters do not)
    def state_dict(self):
        sd = {"step_count": self._step_count}
        for i, p in enumerate(self._parameter_list or []):
            for n, v in self._slots.get(id(p), {}).items():
                sd[f"{i}__{n}"] = v
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        self._step_count = int(state_dict.get("step_count", 0))
        for i, p in enumerate(self._parameter_list or []):
            slots = {}
            for n in self._slot_names():
                key = f"{i}__{n}"
                if key in state_dict:
                    slots[n] = torch.as_tensor(state_dict[key]).to(
                        p.device).clone()
            if slots:
                self._slots[id(p)] = slots
        if "LR_Scheduler" in state_dict and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])


class SGD(Optimizer):
    def _update(self, p, g, slots, lr, t):
        return p - lr * g, slots


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _slot_names(self):
        return ["velocity"]

    def _update(self, p, g, slots, lr, t):
        v = self._momentum * slots["velocity"] + g
        if self._use_nesterov:
            new_p = p - lr * (g + self._momentum * v)
        else:
            new_p = p - lr * v
        return new_p, {"velocity": v}


def _bias_correction(beta, t):
    """1 - beta ** t in float32, the step as a float32 (the reference
    computes it on device from ``jnp.asarray(t, jnp.float32)``)."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(t))


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _slot_names(self):
        return ["moment1", "moment2"]

    def _init_slot(self, name, p):
        # float32 moments for any parameter dtype
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def _update(self, p, g, slots, lr, t):
        b1, b2 = self._beta1, self._beta2
        g32 = g.float()
        m = b1 * slots["moment1"] + (1 - b1) * g32
        v = b2 * slots["moment2"] + (1 - b2) * g32.square()
        mhat = m / _bias_correction(b1, t)
        vhat = v / _bias_correction(b2, t)
        upd = lr * mhat / (vhat.sqrt() + self._epsilon)
        return p - upd.to(p.dtype), {"moment1": m, "moment2": v}


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._wd_coeff = float(weight_decay)

    def _apply_decay(self, p, g):
        return g  # decoupled

    def _update(self, p, g, slots, lr, t):
        new_p, new_slots = super()._update(p, g, slots, lr, t)
        # decoupled decay (the adamw flag in optimizers/adam_op.cc)
        return new_p - lr * self._wd_coeff * p, new_slots
