"""Optimizers (port of paddle_tpu/optimizer/__init__.py: the ``Optimizer``
base with its eager ``step``, the twelve optimizers, their fluid aliases
and the wrappers of ``optimizer/wrappers.py``).

Each optimizer is one update rule
    _update(param, grad, slots, lr, t) -> (new_param, new_slots)
written with the reference's arithmetic in the reference's order
(``ops.kernels.optimizer.update_plain``), so the rounding is the same:
Adam-family moments are float32 whatever the parameter's dtype, every
other slot has the parameter's dtype (the reference's ``zeros_like``), the
step ``t`` enters the bias corrections as a float32, and AdamW's decoupled
decay subtracts ``lr * wd * p_old`` afterwards.  ``weight_decay`` is a
float, a regularizer (``paddle_tpu_torch.regularizer``) or a callable that
transforms the gradient (the reference's ``_parse_wd``).

The update is written IN PLACE into the module's own parameters (and the
slots are kept per parameter): PyTorch runs eagerly on the parameters
the model holds, so there is no parameter pytree to return.  What the
reference's ``apply_pytree`` gives it, one update over the whole tree
inside its jitted step, is here one CUDA launch a step for each (device,
dtype) group of CUDA parameters (two for Lamb, LarsMomentum and Dpsgd,
whose rules need per-tensor norms; ``ops.kernels.optimizer``), with the
slots updated in place; so ``state_dict()`` hands out copies, as the
reference's immutable state arrays are.  ``step()`` is two halves:
:meth:`Optimizer.begin_step`, the host's (advance the step count, read the
learning rate, write the kernel's scalars to each CUDA device without a
sync), and :meth:`Optimizer.apply_step`, the device's (the update, reading
those scalars), which touches no host state; the training engine runs the
first once per executed step and captures the second in its CUDA graph,
as the reference's engine keeps ``lr`` and ``step`` in its donated state.
CPU parameters take that wrapper's plain version; an optimizer whose rule
has no kernel (a subclass that overrides ``_update`` or ``_apply_decay``)
takes the per-parameter loop of :meth:`Optimizer.step_plain` on any
device.

Two forms, as in the reference: the eager ``step()`` honours each
parameter's ``optimize_attr["learning_rate"]`` (``ParamAttr``) and AdamW's
``apply_decay_param_fun``; ``Model.fit`` and ``train_batch`` run the
reference's ``apply_pytree`` form, which reads neither (they pass ``pytree=True``
to :meth:`Optimizer.begin_step` and :meth:`Optimizer.apply_step`;
ROADMAP.md §C).  The functional ``init_pytree`` /
``apply_pytree`` themselves are not ported.
"""
from __future__ import annotations

from typing import Any

import torch

from ..framework import random as _random
from ..ops.kernels import optimizer as _kernel
from ..regularizer import L1Decay, L2Decay
from . import lr  # noqa: F401
from .lr import LRScheduler


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kwargs):
        self._learning_rate = learning_rate
        self._parameter_list = list(parameters) \
            if parameters is not None else None
        self._grad_clip = grad_clip
        self._weight_decay = self._parse_wd(weight_decay)
        # per-parameter slot storage keyed by id(param)
        self._slots: dict[int, dict[str, Any]] = {}
        self._step_count = 0
        self._lr_now = None       # the lr begin_step() read for this step
        # the kernels' scalars (float32 [16]) on each CUDA device, one set
        # for each learning-rate ratio of the parameters
        self._scalars: dict[tuple, torch.Tensor] = {}

    @staticmethod
    def _parse_wd(weight_decay):
        """The reference's ``_parse_wd``: None -> 0.0, a number as a float,
        a callable (``L1Decay``/``L2Decay`` or a user's gradient
        transform) as it is, else the object's coefficient."""
        if weight_decay is None:
            return 0.0
        if isinstance(weight_decay, (int, float)):
            return float(weight_decay)
        if callable(weight_decay):
            return weight_decay
        return float(getattr(weight_decay, "_regularization_coeff",
                             getattr(weight_decay, "coeff", 0.0)))

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

    @staticmethod
    def _lr_ratio(p, pytree=False) -> float:
        """The parameter's learning-rate multiplier
        (``ParamAttr(learning_rate=)``), 1.0 in the ``apply_pytree`` form
        (``pytree``), which does not read it."""
        if pytree:
            return 1.0
        return float(getattr(p, "optimize_attr", {}).get(
            "learning_rate", 1.0))

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
        optimizer's ``_update``, or None: then every device takes the
        per-parameter loop."""
        return None

    def _own_rule(self) -> bool:
        """Whether the update rule and the decay are this module's own (the
        kernel computes those; a subclass that replaces either keeps the
        per-parameter loop)."""
        cls = type(self)
        return cls._update.__module__ == cls._apply_decay.__module__ \
            == __name__

    def _decay_spec(self):
        """The coupled decay as the kernel applies it, (mode, coefficient)
        with mode ``"none"``, ``"l2"`` or ``"l1"``; None for a callable
        that is no regularizer of this port, which :meth:`_apply_decay`
        applies to the gradient before the kernel."""
        wd = self._weight_decay
        if not callable(wd):
            return ("l2", wd) if wd else ("none", 0.0)
        if type(wd) in (L1Decay, L2Decay):
            return ("l1" if type(wd) is L1Decay else "l2", wd.coeff)
        return None

    def _kernel_hyper(self, hyper):
        spec = self._decay_spec()
        if spec is None or spec[0] == "none":
            return hyper
        return dict(hyper, decay=spec[0], decay_coeff=spec[1])

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
        dtype, learning-rate ratio) group through the multi-tensor wrapper
        (one launch on CUDA, two for the norm rules, its plain version on
        the CPU); an optimizer whose rule has no kernel takes the
        per-parameter loop.  :meth:`begin_step`, then
        :meth:`apply_step`."""
        self.begin_step()
        self.apply_step()

    def begin_step(self, pytree=False):
        """The host half of a step: advance the step count, read the
        learning rate (a scheduler's current value) and, for an optimizer
        with a kernel, write the kernel's scalars of (lr, step) to every
        CUDA device of the parameters, one set for each learning-rate
        ratio, on the current stream and without a host sync.  Run once
        per executed step.  ``pytree``: the reference's ``apply_pytree``
        form (``Model.fit``, ``train_batch``), which reads no per-parameter
        learning rate; :meth:`apply_step` is given the same."""
        self._step_count += 1
        self._lr_now = self.get_lr()
        spec = self._kernel_spec()
        if spec is None:
            return
        rule, hyper = spec
        hyper = self._kernel_hyper(hyper)
        for key in {(p.device, self._lr_ratio(p, pytree))
                    for p in self._parameter_list or []
                    if p.device.type == "cuda"}:
            if key not in self._scalars:
                self._scalars[key] = _kernel.make_scalars(key[0])
            _kernel.write_scalars(self._scalars[key], rule,
                                  self._lr_now * key[1], self._step_count,
                                  hyper)

    @torch.no_grad()
    def apply_step(self, pytree=False):
        """The device half: the update of every parameter with a gradient
        by the step count, lr and scalars of the last :meth:`begin_step`
        (given the same ``pytree``).
        It reads and writes no host state of the optimizer but its slots'
        first creation, so a CUDA graph can capture it (the per-parameter
        loop of an optimizer without a kernel bakes lr and the step into
        its launches, and so cannot be replayed)."""
        if self._lr_now is None:
            raise RuntimeError("apply_step() before begin_step()")
        params_grads, lr = self._params_grads(), self._lr_now
        spec = self._kernel_spec()
        if spec is None:
            self._step_plain(params_grads, lr, pytree)
            return
        base = 0        # the step's non-empty tensors in earlier groups
        for (_, _, ratio), group in self._groups(params_grads,
                                                 pytree).items():
            self._step_kernel(spec, group, lr * ratio, ratio, base)
            base += sum(p.numel() > 0 for p, _ in group)

    def _groups(self, params_grads, pytree=False):
        """{(device, dtype, learning-rate ratio): [(p, g)]} in order of
        first appearance: one multi-tensor call each."""
        groups = {}
        for p, g in params_grads:
            groups.setdefault((p.device, p.dtype, self._lr_ratio(p, pytree)),
                              []).append((p, g))
        return groups

    @torch.no_grad()
    def step_plain(self):
        """The plain version of :meth:`step`: the same update through the
        per-parameter loop on every device (what the kernel is held
        against on the card)."""
        self._step_count += 1
        self._step_plain(self._params_grads(), self.get_lr())

    plain_cuda_updates = 0   # CUDA parameters the loop updated, all optimizers

    def _step_plain(self, params_grads, lr, pytree=False):
        """The per-parameter loop: :meth:`step_plain`, and :meth:`step` of
        an optimizer whose rule has no kernel."""
        for p, g in params_grads:
            slots = self._get_slots(p)
            g = g.to(p.dtype) if g.dtype != p.dtype else g
            g = self._apply_decay(p, g)
            new_p, new_slots = self._update(p, g, slots,
                                            lr * self._lr_ratio(p, pytree),
                                            self._step_count)
            p.copy_(new_p)
            self._slots[id(p)] = new_slots
            if p.device.type == "cuda":
                Optimizer.plain_cuda_updates += 1

    def _step_kernel(self, spec, params_grads, lr, ratio=1.0, base=0):
        rule, hyper = spec
        hyper = self._kernel_hyper(hyper)
        transform = self._decay_spec() is None
        params, grads, slots = [], [], []
        for p, g in params_grads:
            g = g.to(p.dtype) if g.dtype != p.dtype else g
            params.append(p)
            grads.append(self._apply_decay(p, g) if transform else g)
            own = self._get_slots(p)
            slots.append([own[n] for n in self._slot_names()])
        scalars = self._scalars.get((params[0].device, ratio))
        if rule in _kernel.NORM_KINDS:
            _kernel.multi_tensor_norm_step(rule, params, grads, slots, lr,
                                           self._step_count, hyper, scalars,
                                           self._noise_seed(), base)
        else:
            _kernel.multi_tensor_step(rule, params, grads, slots, lr,
                                      self._step_count, hyper, scalars)

    def _noise_seed(self):
        return 0

    def _apply_decay(self, p, g):
        """Coupled decay (fluid regularizer semantics); AdamW overrides.
        A callable regularizer (L1Decay/L2Decay) transforms the grad."""
        wd = self._weight_decay
        if callable(wd):
            return wd(p, g)
        return g + wd * p if wd else g

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list or []:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    # -- checkpointing ----------------------------------------------------
    # slots are keyed f"{name}__{slot}" by the parameter's name
    # (``ParamAttr``'s, or create_parameter's param_<n>), by its index in
    # the list where it has none, as the reference keys them
    # (copies: the kernel updates the slots in place, and a saved state
    # stays what it was, as the reference's immutable arrays do)
    @staticmethod
    def _key(i, p, n):
        return f"{getattr(p, 'name', None) or i}__{n}"

    def state_dict(self):
        sd = {"step_count": self._step_count}
        for i, p in enumerate(self._parameter_list or []):
            for n, v in self._slots.get(id(p), {}).items():
                sd[self._key(i, p, n)] = v.detach().clone()
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        self._step_count = int(state_dict.get("step_count", 0))
        for i, p in enumerate(self._parameter_list or []):
            slots = {}
            for n in self._slot_names():
                key = self._key(i, p, n)
                if key in state_dict:
                    slots[n] = self._slot_from(n, p, state_dict[key])
            if slots:
                self._slots[id(p)] = slots
        if "LR_Scheduler" in state_dict and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])

    def _slot_from(self, name, p, value):
        """A fresh contiguous copy of ``value`` as slot ``name`` of ``p``:
        on p's device, in the slot's own dtype (float32 moments, p's dtype
        elsewhere), as the kernel takes it."""
        return torch.as_tensor(value).to(
            device=p.device, dtype=self._slot_dtype(name, p),
            copy=True).contiguous()


class _Rule(Optimizer):
    """An optimizer whose ``_update`` is ``update_plain`` of its rule, with
    its slots in ``_SLOTS`` order and its coefficients in ``_hyper()``."""

    _SLOTS: tuple = ()

    def _rule(self) -> str:
        return self._RULE

    def _hyper(self) -> dict:
        return {}

    def _slot_names(self):
        return list(self._SLOTS)

    def _update(self, p, g, slots, lr, t):
        new_p, new = _kernel.update_plain(
            self._rule(), p, g, [slots[n] for n in self._SLOTS], lr, t,
            self._hyper())
        return new_p, dict(zip(self._SLOTS, new))

    def _kernel_spec(self):
        return (self._rule(), self._hyper()) if self._own_rule() else None


class SGD(_Rule):
    _RULE = "sgd"


class Momentum(_Rule):
    _SLOTS = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _rule(self):
        return "nesterov" if self._use_nesterov else "momentum"

    def _hyper(self):
        return {"momentum": self._momentum}


class Adagrad(_Rule):
    _RULE, _SLOTS = "adagrad", ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_slot(self, name, p):
        return torch.full_like(p, self._init_acc)

    def _hyper(self):
        return {"epsilon": self._epsilon}


class Adam(_Rule):
    _RULE, _SLOTS = "adam", ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_slot(self, name, p):
        # float32 moments for any parameter dtype
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def _slot_dtype(self, name, p):
        return torch.float32

    def _hyper(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}


class AdamW(Adam):
    _RULE = "adamw"     # decoupled decay: new_p - lr * wd * p_old

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        if isinstance(weight_decay, L1Decay):
            raise TypeError(
                "AdamW applies DECOUPLED L2 weight decay; L1Decay has no "
                "decoupled analog here — use paddle.optimizer.Adam with "
                "weight_decay=L1Decay(...) for coupled L1")
        self._wd_coeff = float(getattr(weight_decay, "_regularization_coeff",
                                       weight_decay))
        # lr_ratio is accepted and unused, as in the reference
        self._apply_decay_param_fun = apply_decay_param_fun
        self._decay_enabled = True

    def _apply_decay(self, p, g):
        return g  # decoupled

    def _hyper(self):
        wd = self._wd_coeff if self._decay_enabled else 0.0
        return dict(super()._hyper(), weight_decay=wd)

    @torch.no_grad()
    def step(self):
        """With ``apply_decay_param_fun`` (the eager form only), the
        reference's two passes: the parameters whose name it accepts with
        the decay, then the others without it, the step counted once."""
        if self._apply_decay_param_fun is None:
            return super().step()
        all_params = self._parameter_list
        decay = [p for p in all_params
                 if self._apply_decay_param_fun(getattr(p, "name", "") or "")]
        decay_ids = {id(p) for p in decay}
        nodecay = [p for p in all_params if id(p) not in decay_ids]
        try:
            self._parameter_list = decay
            self._decay_enabled = True
            super().step()
            self._step_count -= 1  # counted once for both halves
            self._parameter_list = nodecay
            self._decay_enabled = False
            super().step()
        finally:
            self._parameter_list = all_params
            self._decay_enabled = True


class Adamax(_Rule):
    _RULE, _SLOTS = "adamax", ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _hyper(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}


class Adadelta(_Rule):
    _RULE, _SLOTS = "adadelta", ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon

    def _hyper(self):
        return {"rho": self._rho, "epsilon": self._epsilon}


class RMSProp(_Rule):
    _SLOTS = ("mean_square", "mean_grad", "momentum")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _rule(self):
        return "rmsprop_centered" if self._centered else "rmsprop"

    def _hyper(self):
        return {"rho": self._rho, "epsilon": self._epsilon,
                "momentum": self._momentum}


class Lamb(_Rule):
    _RULE, _SLOTS = "lamb", ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        # stored and never read, as in the reference (ROADMAP.md §C)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _hyper(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon, "weight_decay": self._lamb_wd}


class LarsMomentum(_Rule):
    """LARS (optimizers/lars_momentum_op.cc; fluid
    LarsMomentumOptimizer:1612)."""

    _RULE, _SLOTS = "lars", ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0, name=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon
        # stored and never read, as in the reference (ROADMAP.md §C)
        self._exclude = exclude_from_weight_decay

    def _hyper(self):
        return {"momentum": self._momentum, "lars_coeff": self._lars_coeff,
                "weight_decay": self._lars_wd, "epsilon": self._eps}


class Ftrl(_Rule):
    _RULE, _SLOTS = "ftrl", ("squared", "linear")

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _hyper(self):
        return {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power}


class Dpsgd(SGD):
    """Differentially-private SGD (optimizers/dpsgd_op.cc): each gradient
    clipped to norm ``clip`` and Gaussian noise of standard deviation
    ``sigma * clip / batch_size`` added.  The eager ``step`` draws a new
    noise seed every step from the framework generator (the reference's
    ``split_key``); the ``apply_pytree`` form draws one and keeps it, as
    the reference's jitted step holds the key it was traced with
    (ROADMAP.md §C)."""

    _RULE = "dpsgd"

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16,
                 sigma=1.0, parameters=None, **kw):
        super().__init__(learning_rate, parameters)
        self._clip, self._batch, self._sigma = clip, batch_size, sigma
        self._seed = None            # this step's noise seed
        self._pytree_seed = None     # the apply_pytree form's, kept

    def _hyper(self):
        return {"clip": self._clip, "sigma": self._sigma,
                "batch_size": self._batch}

    def begin_step(self, pytree=False):
        if pytree:
            if self._pytree_seed is None:
                self._pytree_seed = _random._draw()
            self._seed = self._pytree_seed
        else:
            self._seed = _random._draw()
        super().begin_step(pytree)

    def step_plain(self):
        self._seed = _random._draw()
        super().step_plain()

    def _step_plain(self, params_grads, lr, pytree=False):
        # the step's non-empty tensors numbered group by group, as
        # apply_step hands them to the kernel: each one's noise index
        self._index, live = {}, 0
        for group in self._groups(params_grads, pytree).values():
            for p, _ in group:
                self._index[id(p)] = live
                live += p.numel() > 0
        super()._step_plain(params_grads, lr, pytree)

    def _update(self, p, g, slots, lr, t):
        new_p, _ = _kernel.update_plain("dpsgd", p, g, [], lr, t,
                                        self._hyper(), self._noise_seed(),
                                        self._index[id(p)])
        return new_p, {}

    def _noise_seed(self):
        if self._seed is None:
            raise RuntimeError("Dpsgd: apply_step() before begin_step()")
        return self._seed


# fluid-era name aliases (fluid.optimizer.*Optimizer)
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdagradOptimizer = Adagrad
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
LambOptimizer = Lamb
LarsMomentumOptimizer = LarsMomentum
FtrlOptimizer = Ftrl
DpsgdOptimizer = Dpsgd

from .wrappers import (EMA, ExponentialMovingAverage,  # noqa: E402,F401
                       LookaheadOptimizer, ModelAverage)
