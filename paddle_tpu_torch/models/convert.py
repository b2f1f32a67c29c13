"""Weight and optimizer-state carry-over from the JAX package by
parameter name.

``load_numpy_state(model, state)`` takes what
``{k: np.asarray(v.numpy()) for k, v in jax_model.state_dict().items()}``
gives and copies it into the port's model in place.  It is strict: a
missing key, an unexpected key or a shape mismatch raises.  Values are
cast to the model's dtype and device; integers are cast explicitly (the
JAX side runs with 64-bit types enabled).

``load_numpy_optimizer_state(opt, model, state, step_count)`` takes the
JAX optimizer's state pytree (``{param name: {slot: array}}``, as
``opt.init_pytree``/``apply_pytree`` give it, converted to numpy) and
its step count, and copies them into the port optimizer's slots for the
model's parameters (making those it lacks), so training resumes where
the JAX run stopped.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.io_state import as_array
from ..nn.layer_base import set_state_dict


def load_numpy_state(model: torch.nn.Module, state: dict):
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"load_numpy_state: missing {missing}, "
                       f"unexpected {unexpected}")
    set_state_dict(model, state)
    return model


def load_numpy_optimizer_state(opt, model: torch.nn.Module, state: dict,
                               step_count: int):
    """Install ``state`` = {param name: {slot name: array}} as ``opt``'s
    slots for ``model``'s parameters of those names, and its step count.
    Strict: every trainable parameter needs an entry with exactly the
    optimizer's slot names and the parameter's shape.  Each slot becomes a
    contiguous tensor on the parameter's device in the dtype the optimizer
    keeps it in (Adam-family moments float32 for any parameter dtype), as
    the multi-tensor kernel takes it.  A slot the optimizer already holds
    is overwritten where it lies (a captured train step that updates it
    stays valid); only a missing one is made anew."""
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError(f"load_numpy_optimizer_state: missing {missing}, "
                       f"unexpected {unexpected}")
    names = sorted(opt._slot_names())
    slots = {}
    for name, p in params.items():
        entry = state[name]
        if sorted(entry) != names:
            raise KeyError(f"load_numpy_optimizer_state: {name} has slots "
                           f"{sorted(entry)}, the optimizer {names}")
        own = opt._slots.get(id(p), {})
        slots[id(p)] = {}
        for slot, value in entry.items():
            a = as_array(value)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"shape mismatch for {name}/{slot}: "
                                 f"loaded {a.shape} vs {tuple(p.shape)}")
            new = opt._slot_from(slot, p, torch.from_numpy(
                a.astype(np.float32)))
            slots[id(p)][slot] = own[slot].copy_(new) if slot in own \
                else new
    opt._slots.update(slots)
    opt._step_count = int(step_count)
    return opt
