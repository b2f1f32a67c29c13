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
its step count, and installs them as the port optimizer's slots for the
model's parameters, so training resumes where the JAX run stopped.
"""
from __future__ import annotations

import numpy as np
import torch


def load_numpy_state(model: torch.nn.Module, state: dict):
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"load_numpy_state: missing {missing}, "
                       f"unexpected {unexpected}")
    with torch.no_grad():
        for name, target in own.items():
            a = np.asarray(state[name])
            if tuple(a.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {name}: loaded {a.shape} vs "
                    f"{tuple(target.shape)}")
            # float32 for every float source (bfloat16 included), int64 for
            # integers, then the model's own dtype
            a = a.astype(np.float32 if target.is_floating_point()
                         else np.int64)
            target.copy_(torch.from_numpy(a).to(device=target.device,
                                                dtype=target.dtype))
    return model


def load_numpy_optimizer_state(opt, model: torch.nn.Module, state: dict,
                               step_count: int):
    """Install ``state`` = {param name: {slot name: array}} as ``opt``'s
    slots for ``model``'s parameters of those names, and its step count.
    Strict: every trainable parameter needs an entry with exactly the
    optimizer's slot names and the parameter's shape.  Slots keep their
    float32 precision (Adam-family moments are float32 for any parameter
    dtype) and move to the parameter's device."""
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
        slots[id(p)] = {}
        for slot, value in entry.items():
            a = np.asarray(value)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"shape mismatch for {name}/{slot}: "
                                 f"loaded {a.shape} vs {tuple(p.shape)}")
            slots[id(p)][slot] = torch.from_numpy(
                a.astype(np.float32)).to(p.device)
    opt._slots.update(slots)
    opt._step_count = int(step_count)
    return opt
