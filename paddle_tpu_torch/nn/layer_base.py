"""nn.Layer on ``torch.nn.Module`` (port of paddle_tpu/nn/layer_base.py).

``state_dict`` names equal the reference's exactly: sublayers registered
with :meth:`Layer.add_sublayer` keep their given names (GPT blocks are
``h_0``, ``h_1``, ... as in paddle_tpu/models/gpt.py), which is why the
port never uses ``nn.ModuleList`` (it would rename them ``h.0``).
JAX's functional parameter swapping has no counterpart here: PyTorch runs
eagerly on the module's own parameters.  ``set_state_dict`` (aliases
``load_dict``, ``set_dict``) writes a loaded value into the tensor the
module holds, in place, so a captured CUDA graph that reads it stays
valid.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..framework.dtype import convert_dtype
from ..framework.io_state import as_array
from . import initializer as I


def set_state_dict(module: torch.nn.Module, state_dict: dict):
    """Copy ``state_dict`` (name -> numpy array or tensor) into
    ``module``'s parameters and buffers of those names, in place, with the
    reference's semantics (paddle_tpu/nn/layer_base.py ``set_state_dict``):
    a shape mismatch raises ``ValueError``, each value is cast to its
    target's dtype (through float32 from any float source, bfloat16
    included; integers through int64), names the module does not hold are
    skipped.  Returns ``(missing, unexpected)``: the module's names that
    ``state_dict`` lacks, and the names of ``state_dict`` the module
    lacks."""
    own = module.state_dict()
    unexpected = []
    with torch.no_grad():
        for name, value in state_dict.items():
            if name not in own:
                unexpected.append(name)
                continue
            target, a = own[name], as_array(value)
            if tuple(a.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {name}: loaded {a.shape} vs "
                    f"{tuple(target.shape)}")
            a = a.astype(np.float32 if target.is_floating_point()
                         else np.int64)
            target.copy_(torch.from_numpy(a).to(device=target.device,
                                                dtype=target.dtype))
    return [n for n in own if n not in state_dict], unexpected


class ParamAttr:
    """Reference parity: paddle ParamAttr (python/paddle/fluid/param_attr.py):
    :meth:`Layer.create_parameter` puts ``name``, ``learning_rate`` (as
    ``p.optimize_attr``), ``regularizer`` and ``need_clip`` on the
    parameter.  ``do_model_average`` is accepted and unused, as in the
    reference."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr) or attr is False:
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"Cannot make ParamAttr from {attr!r}")


class Parameter(torch.nn.Parameter):
    """``torch.nn.Parameter`` with the reference's parameter attributes:
    a writable ``name`` (torch's own ``Tensor.name`` cannot be set),
    ``optimize_attr``, ``regularizer`` and ``need_clip``, which
    :meth:`Layer.create_parameter` sets.  A cast (``Layer.to``, ``astype``)
    keeps the object and so its attributes; a deep copy copies them."""

    @property
    def name(self):
        return self.__dict__.get("_param_name")

    @name.setter
    def name(self, value):
        self.__dict__["_param_name"] = value

    def __repr__(self):
        return "Parameter containing:\n" + repr(self.data)

    def __deepcopy__(self, memo):
        out = super().__deepcopy__(memo)
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out


# the reference's unique-name scheme (paddle_tpu/nn/layer_base.py
# ``_unique_name``): a counter a prefix, ``param_0``, ``param_1``, ...
_name_counters: dict[str, int] = {}


def _unique_name(prefix: str) -> str:
    n = _name_counters.get(prefix, 0)
    _name_counters[prefix] = n + 1
    return f"{prefix}_{n}"


class Layer(torch.nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self._dtype = dtype

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A Parameter initialised on the CPU (see nn/initializer.py), by
        default XavierUniform for a weight and zeros for a bias, as in the
        reference; ``attr=False`` means no parameter (returns None).  The
        parameter carries the reference's attributes: ``name`` (the
        attribute's, else ``param_<n>``), ``optimize_attr``
        (``{"learning_rate": ...}``), ``regularizer`` and ``need_clip``."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer or default_initializer or \
            (I.Constant(0.0) if is_bias else I.XavierUniform())
        value = init(shape, dtype or self._dtype)
        p = Parameter(value, requires_grad=attr.trainable)
        p.name = attr.name or _unique_name("param")
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Load ``state_dict`` in place (:func:`set_state_dict`); returns
        ``(missing, unexpected)``."""
        return set_state_dict(self, state_dict)

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- dtype / device conversion -------------------------------------------
    def to(self, *args, **kwargs):
        """``torch.nn.Module.to``, with ``dtype=`` also a Paddle name
        (``"float16"``) and the reference's ``blocking=`` accepted and
        unused; a dtype also becomes every sublayer's ``_dtype``.  Each
        floating parameter and buffer is cast in place: a parameter keeps
        its object (so an optimizer built earlier still holds it)."""
        kwargs.pop("blocking", None)
        dtype = convert_dtype(kwargs.pop("dtype", None))
        if dtype is not None:
            kwargs["dtype"] = dtype
        super().to(*args, **kwargs)
        if dtype is not None:
            for layer in self.modules():
                if isinstance(layer, Layer):
                    layer._dtype = dtype
        return self

    def astype(self, dtype):
        """Cast every floating parameter and buffer to ``dtype`` (a Paddle
        name or a torch dtype) in place, and set every sublayer's
        ``_dtype`` (the reference's ``astype``)."""
        return self.to(dtype=dtype)

    def float(self):
        return self.astype("float32")

    def half(self):
        return self.astype("float16")

    def bfloat16(self):
        return self.astype("bfloat16")
