"""Optimizers (port of paddle_tpu/optimizer/__init__.py: the ``Optimizer``
base with its eager ``step``, ``SGD``, ``Momentum``, ``Adam`` and
``AdamW``).

Each optimizer is one update rule
    _update(param, grad, slots, lr, t) -> (new_param, new_slots)
written with the reference's arithmetic in the reference's order
(``ops.kernels.optimizer.update_plain``), so the rounding is the same:
Adam-family moments are float32 whatever the parameter's dtype, the step
``t`` enters the bias corrections as a float32, the update is cast to the
parameter's dtype before it is subtracted, and AdamW's decoupled decay
subtracts ``lr * wd * p_old`` afterwards.

The update is written IN PLACE into the module's own parameters (and the
moments are kept per parameter): PyTorch runs eagerly on the parameters
the model holds, so there is no parameter pytree to return.  What the
reference's ``apply_pytree`` gives it, one update over the whole tree
inside its jitted step, is here one CUDA launch a step for each (device,
dtype) group of CUDA parameters (``ops.kernels.optimizer``, bitwise the
per-parameter loop's result), with the moments updated in place; so
``state_dict()`` hands out copies, as the reference's immutable state
arrays are.  ``step()`` is two halves: :meth:`Optimizer.begin_step`, the
host's (advance the step count, read the learning rate, write the
kernel's scalars to each CUDA device without a sync), and
:meth:`Optimizer.apply_step`, the device's (the update, reading those
scalars), which touches no host state; the training engine runs the first
once per executed step and captures the second in its CUDA graph, as the
reference's engine keeps ``lr`` and ``step`` in its donated state.  CPU parameters take that wrapper's plain version; an
optimizer whose rule has no kernel (a subclass that overrides ``_update``
or ``_apply_decay``) takes the per-parameter loop of
:meth:`Optimizer.step_plain` on any device.  The
functional ``init_pytree``/``apply_pytree`` are not ported.  Not ported
yet (ROADMAP.md): Adagrad, Adamax, Adadelta, RMSProp, Lamb, LarsMomentum,
Ftrl, Dpsgd, the wrappers, regularizer objects as ``weight_decay`` and
AdamW's ``apply_decay_param_fun`` (both need parameter names, which torch
parameters do not carry).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.kernels import optimizer as _kernel
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
        self._lr_now = None       # the lr begin_step() read for this step
        # the kernel's scalars (float32 [9]) on each CUDA device
        self._scalars: dict[torch.device, torch.Tensor] = {}

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

    def _slot_dtype(self, name: str, p):
        return p.dtype

    def _update(self, p, g, slots: dict, lr, t):
        """p/g tensors, slots dict of tensors, lr a float, t the step;
        returns (new_p, new_slots) without touching p."""
        raise NotImplementedError

    def _kernel_spec(self):
        """(rule, hyper) of the multi-tensor kernel that computes this
        optimizer's ``_update`` and ``_apply_decay``, or None: then every
        device takes the per-parameter loop."""
        return None

    def _own_rule(self) -> bool:
        """Whether the update rule and the decay are this module's own (the
        kernel computes those; a subclass that replaces either keeps the
        per-parameter loop)."""
        cls = type(self)
        return cls._update.__module__ == cls._apply_decay.__module__ \
            == __name__

    # -- eager path --------------------------------------------------------
    def _get_slots(self, p) -> dict:
        key = id(p)
        if key not in self._slots:
            self._slots[key] = {n: self._init_slot(n, p.detach())
                                for n in self._slot_names()}
        return self._slots[key]

    def _params_grads(self):
        params = self._parameter_list or []
        params_grads = [(p, p.grad) for p in params
                        if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        return [(p, g) for p, g in params_grads if g is not None]

    @torch.no_grad()
    def step(self):
        """One update of every parameter with a gradient: each (device,
        dtype) group through the multi-tensor wrapper (one launch on CUDA,
        its plain version on the CPU); an optimizer whose rule has no
        kernel takes the per-parameter loop.  :meth:`begin_step`, then
        :meth:`apply_step`."""
        self.begin_step()
        self.apply_step()

    def begin_step(self):
        """The host half of a step: advance the step count, read the
        learning rate (a scheduler's current value) and, for an optimizer
        with a kernel, write the kernel's scalars of (lr, step) to every
        CUDA device of the parameters, on the current stream and without a
        host sync.  Run once per executed step."""
        self._step_count += 1
        self._lr_now = self.get_lr()
        spec = self._kernel_spec()
        if spec is None:
            return
        rule, hyper = spec
        for dev in {p.device for p in self._parameter_list or []
                    if p.device.type == "cuda"}:
            if dev not in self._scalars:
                self._scalars[dev] = _kernel.make_scalars(dev)
            _kernel.write_scalars(self._scalars[dev], rule, self._lr_now,
                                  self._step_count, hyper)

    @torch.no_grad()
    def apply_step(self):
        """The device half: the update of every parameter with a gradient
        by the step count, lr and scalars of the last :meth:`begin_step`.
        It reads and writes no host state of the optimizer but its slots'
        first creation, so a CUDA graph can capture it (the per-parameter
        loop of an optimizer without a kernel bakes lr and the step into
        its launches, and so cannot be replayed)."""
        if self._lr_now is None:
            raise RuntimeError("apply_step() before begin_step()")
        params_grads, lr = self._params_grads(), self._lr_now
        spec = self._kernel_spec()
        if spec is None:
            self._step_plain(params_grads, lr)
            return
        groups = {}
        for p, g in params_grads:
            groups.setdefault((p.device, p.dtype), []).append((p, g))
        for group in groups.values():
            self._step_kernel(spec, group, lr)

    @torch.no_grad()
    def step_plain(self):
        """The plain version of :meth:`step`: the same update through the
        per-parameter loop on every device (what the kernel is held
        against on the card)."""
        self._step_count += 1
        self._step_plain(self._params_grads(), self.get_lr())

    plain_cuda_updates = 0   # CUDA parameters the loop updated, all optimizers

    def _step_plain(self, params_grads, lr):
        """The per-parameter loop: :meth:`step_plain`, and :meth:`step` of
        an optimizer whose rule has no kernel."""
        for p, g in params_grads:
            slots = self._get_slots(p)
            g = g.to(p.dtype) if g.dtype != p.dtype else g
            g = self._apply_decay(p, g)
            new_p, new_slots = self._update(p, g, slots, lr,
                                            self._step_count)
            p.copy_(new_p)
            self._slots[id(p)] = new_slots
            if p.device.type == "cuda":
                Optimizer.plain_cuda_updates += 1

    def _step_kernel(self, spec, params_grads, lr):
        rule, hyper = spec
        params, grads, slots = [], [], []
        for p, g in params_grads:
            g = g.to(p.dtype) if g.dtype != p.dtype else g
            params.append(p)
            grads.append(self._apply_decay(p, g))
            own = self._get_slots(p)
            slots.append([own[n] for n in self._slot_names()])
        _kernel.multi_tensor_step(rule, params, grads, slots, lr,
                                  self._step_count, hyper,
                                  self._scalars.get(params[0].device))

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
    # (copies: the kernel updates the slots in place, and a saved state
    # stays what it was, as the reference's immutable arrays do)
    def state_dict(self):
        sd = {"step_count": self._step_count}
        for i, p in enumerate(self._parameter_list or []):
            for n, v in self._slots.get(id(p), {}).items():
                sd[f"{i}__{n}"] = v.detach().clone()
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
                    slots[n] = self._slot_from(n, p, state_dict[key])
            if slots:
                self._slots[id(p)] = slots
        if "LR_Scheduler" in state_dict and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])

    def _slot_from(self, name, p, value):
        """A fresh contiguous copy of ``value`` as slot ``name`` of ``p``:
        on p's device, in the slot's own dtype (float32 moments, p's dtype
        for a velocity), as the kernel takes it."""
        return torch.as_tensor(value).to(
            device=p.device, dtype=self._slot_dtype(name, p),
            copy=True).contiguous()


class SGD(Optimizer):
    def _update(self, p, g, slots, lr, t):
        return _kernel.update_plain("sgd", p, g, [], lr, t, {})[0], slots

    def _kernel_spec(self):
        return ("sgd", {}) if self._own_rule() else None


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _slot_names(self):
        return ["velocity"]

    def _rule(self):
        return "nesterov" if self._use_nesterov else "momentum"

    def _update(self, p, g, slots, lr, t):
        new_p, (v,) = _kernel.update_plain(
            self._rule(), p, g, [slots["velocity"]], lr, t,
            {"momentum": self._momentum})
        return new_p, {"velocity": v}

    def _kernel_spec(self):
        return (self._rule(), {"momentum": self._momentum}) \
            if self._own_rule() else None


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

    def _slot_dtype(self, name, p):
        return torch.float32

    _RULE = "adam"

    def _hyper(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}

    def _update(self, p, g, slots, lr, t):
        new_p, (m, v) = _kernel.update_plain(
            self._RULE, p, g, [slots["moment1"], slots["moment2"]], lr, t,
            self._hyper())
        return new_p, {"moment1": m, "moment2": v}

    def _kernel_spec(self):
        return (self._RULE, self._hyper()) if self._own_rule() else None


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._wd_coeff = float(weight_decay)

    _RULE = "adamw"     # decoupled decay: new_p - lr * wd * p_old

    def _apply_decay(self, p, g):
        return g  # decoupled

    def _hyper(self):
        return dict(super()._hyper(), weight_decay=self._wd_coeff)
