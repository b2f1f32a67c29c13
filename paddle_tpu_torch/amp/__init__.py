"""paddle.amp: automatic mixed precision (port of paddle_tpu/amp/__init__.py,
whole).

``auto_cast`` is a thread-local policy read by the matmul-class ops (the
white list: ``nn.functional.linear``, ``ops.fused.linear_bias_gelu`` and
``tensor_ops.matmul``, which cast their floating inputs to the AMP dtype
through :func:`white_cast`); everything else runs in the dtype its inputs
have, so norms, softmax and losses see float32 wherever a float32
parameter or residual meets them (type promotion decides each kernel's
form, as jnp's does in the reference).  ``decorate(level="O2")`` casts
the models' parameters to the AMP dtype (pure float16/bf16 training).

``GradScaler`` is dynamic loss scaling with the reference's rule.  Its
``unscale_`` is ONE launch of the check_finite_and_unscale kernel
(ops/kernels/amp.py) over every gradient of a (device, dtype) group, in
place, then one host read of the found-inf flag, which ``step`` needs to
decide whether to skip the update (the reference reads one flag a
parameter).  The scale stays a host float, as in the reference, and is
written to a float32 device word for the kernel before each unscale.
The functional :func:`check_finite_and_unscale` and
:func:`update_loss_scaling` are the reference's jit-safe forms, over
tensors.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..framework.dtype import convert_dtype
from ..framework.place import copy_to_device
from ..ops.kernels import amp as _kernel


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white_list = set()
        self.custom_black_list = set()


_state = _AmpState()


def amp_state():
    return _state


def amp_active() -> bool:
    return _state.enabled


def amp_dtype():
    return _state.dtype


def amp_key():
    """What of the policy changes a traced step: (enabled, dtype, level),
    or (False,) when off (the training engine keys its graphs on it)."""
    if not _state.enabled:
        return (False,)
    return (True, _state.dtype, _state.level)


def white_cast(*vals):
    """Cast float inputs of a white-list op to the amp dtype."""
    if not _state.enabled:
        return vals
    dt = _state.dtype
    return tuple(v.to(dt) if isinstance(v, torch.Tensor)
                 and v.is_floating_point() and v.dtype != dt else v
                 for v in vals)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    prev = (_state.enabled, _state.dtype, _state.level,
            _state.custom_white_list, _state.custom_black_list)
    _state.enabled = enable
    _state.dtype = convert_dtype(dtype)
    _state.level = level
    _state.custom_white_list = set(custom_white_list or [])
    _state.custom_black_list = set(custom_black_list or [])
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white_list, _state.custom_black_list) = prev


amp_guard = auto_cast  # fluid.dygraph.amp_guard alias


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' parameters to the amp dtype in place (pure
    bf16/fp16 mode, fluid cast_model_to_fp16 analog); an optimizer built
    on them keeps holding them.  ``master_weight`` and ``save_dtype`` are
    accepted and unused, as in the reference."""
    if level == "O2":
        single = not isinstance(models, (list, tuple))
        for m in ([models] if single else models):
            m.astype(dtype)
    if optimizers is None:
        return models
    return models, optimizers


amp_decorate = decorate


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # per device: (1 / scale as float32 [1], found-inf int32 [1])
        self._words: dict[torch.device, tuple] = {}

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Every gradient times 1 / scale, in place, by one kernel launch a
        (device, dtype) group, and whether any unscaled value is inf or
        NaN (one host read a device)."""
        if not self._enable:
            return
        by_device = {}
        for p in optimizer._parameter_list or []:
            if p.grad is not None:
                by_device.setdefault(p.grad.device, []).append(p.grad)
        flags = []
        for dev, group in by_device.items():
            if dev not in self._words:
                self._words[dev] = (
                    torch.empty(1, dtype=torch.float32, device=dev),
                    torch.empty(1, dtype=torch.int32, device=dev))
            inv, found = self._words[dev]
            copy_to_device(inv, [1.0 / self._scale])
            found.zero_()
            flags.append(_kernel.check_finite_and_unscale_(group, inv,
                                                           found))
        self._found_inf = any(bool(f.item()) for f in flags)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        """Dynamic loss-scale bookkeeping (update_loss_scaling_op
        semantics)."""
        if not self._dynamic:
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n,
                "decr_every_n_nan_or_inf": self._decr_every_n,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def set_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)


# -- functional loss scaling --------------------------------------------------
def check_finite_and_unscale(grads, scale):
    """The reference's amp/check_finite_and_unscale_op.cc analog: ``grads``
    (a tensor, or a list, tuple or dict of them, on one device) times
    1 / ``scale`` (a number or a scalar tensor) and whether any unscaled
    value is inf or NaN.  IN PLACE (one kernel launch a dtype group on
    the card): returns (``grads``, found_inf as a bool scalar tensor on
    their device), without a host sync."""
    leaves = list(grads.values()) if isinstance(grads, dict) else (
        list(grads) if isinstance(grads, (list, tuple)) else [grads])
    dev = leaves[0].device if leaves else torch.device("cpu")
    inv = torch.reciprocal(torch.as_tensor(scale, dtype=torch.float32)
                           .reshape(1).to(dev))
    found = torch.zeros(1, dtype=torch.int32, device=dev)
    _kernel.check_finite_and_unscale_(leaves, inv, found)
    return grads, found.reshape(()).bool()


def update_loss_scaling(scale, good_steps, bad_steps, found_inf,
                        incr_ratio=2.0, decr_ratio=0.5, incr_every_n=1000,
                        decr_every_n=2):
    """The reference's update_loss_scaling_op.cc analog over scalar
    tensors (numbers are taken as tensors): returns (new scale, good
    steps, bad steps), without a host sync."""
    scale, good_steps, bad_steps, found_inf = (
        torch.as_tensor(v) for v in (scale, good_steps, bad_steps,
                                     found_inf))
    found_inf = found_inf.bool()
    good = torch.where(found_inf, 0, good_steps + 1)
    bad = torch.where(found_inf, bad_steps + 1, 0)
    do_incr = good >= incr_every_n
    do_decr = bad >= decr_every_n
    new_scale = torch.where(
        do_incr, scale * incr_ratio,
        torch.where(do_decr, torch.clamp(scale * decr_ratio, min=1.0),
                    scale))
    good = torch.where(do_incr, 0, good)
    bad = torch.where(do_decr, 0, bad)
    return new_scale, good, bad
