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

The reference's traversal surface holds too: ``parameters()`` and
``buffers()`` return lists, ``include_sublayers`` chooses between the
layer's own tensors and the whole tree, and ``register_buffer`` takes
``persistable``; torch's own keywords (``recurse``, ``persistent``,
``prefix``, ``keep_vars``, ``remove_duplicate``), which PyTorch's code
passes, keep working.
"""
from __future__ import annotations

import contextlib
import copy
from collections import OrderedDict

import numpy as np
import torch

from ..framework.dtype import convert_dtype, get_default_dtype
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


def _value_tensor(value, dtype=None):
    """``value`` (a tensor, numpy array or array-like) as a detached
    tensor of ``dtype``; a float64 array or a Python float takes the
    default dtype, as the reference's ``Tensor`` does."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        a = np.asarray(value)
        t = torch.from_numpy(np.array(a))
        if dtype is None and a.dtype == np.float64:
            dtype = get_default_dtype()
    dt = convert_dtype(dtype)
    return t if dt is None or t.dtype == dt else t.to(dt)


class Parameter(torch.nn.Parameter):
    """``torch.nn.Parameter`` with the reference's parameter surface
    (paddle_tpu/nn/layer_base.py ``Parameter``): the constructor
    ``Parameter(value, dtype=None, name=None, trainable=True)``,
    ``trainable`` and ``stop_gradient`` as views of ``requires_grad`` (a
    frozen parameter gets no gradient, so the optimizer and ``Model.fit``
    leave it as it is), ``set_value``, a writable ``name`` (torch's own
    ``Tensor.name`` cannot be set), and ``optimize_attr``, ``regularizer``
    and ``need_clip``, which :meth:`Layer.create_parameter` sets.  A cast
    (``Layer.to``, ``astype``) keeps the object and so its attributes; a
    deep copy copies them."""

    def __new__(cls, value=None, dtype=None, name=None, trainable=True):
        if isinstance(dtype, bool):
            # torch's own form, Parameter(data, requires_grad), which its
            # deep copy and unpickling call
            dtype, trainable = None, dtype
        data = None if value is None else _value_tensor(value, dtype)
        p = super().__new__(cls, data, requires_grad=bool(trainable))
        if name is not None:
            p.name = name
        return p

    @property
    def name(self):
        return self.__dict__.get("_param_name")

    @name.setter
    def name(self, value):
        self.__dict__["_param_name"] = value

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    @torch.no_grad()
    def set_value(self, value):
        """Write ``value`` into the parameter, cast to its dtype: in place
        where the shape is the same (a captured graph keeps reading it),
        else as new data of the value's shape."""
        v = _value_tensor(value).to(self.dtype)
        if v.shape == self.shape:
            self.copy_(v)
        else:
            self.data = v.to(self.device)

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


def _walk(module, prefix, seen):
    """(structured name, module) of ``module`` and its sublayers in the
    reference's pre-order, each module once (``seen``: ids)."""
    if id(module) in seen:
        return
    seen.add(id(module))
    yield prefix, module
    for name, sub in module._modules.items():
        if sub is not None:
            yield from _walk(sub, f"{prefix}.{name}" if prefix else name,
                             seen)


def _names_a_device(name: str) -> bool:
    try:
        torch.device(name)
    except RuntimeError:
        return False
    return True


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        """``name_scope`` names the layer for :meth:`full_name` (the
        reference's ``<scope>_<n>``, by default the class name in lower
        case); ``dtype`` (a Paddle name or a torch dtype) is the dtype
        :meth:`create_parameter` gives by default."""
        super().__init__()
        self._dtype = convert_dtype(dtype) or get_default_dtype()
        self._full_name = _unique_name(name_scope
                                       or type(self).__name__.lower())

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
        value = init(shape, convert_dtype(dtype) or self._dtype)
        p = Parameter(value, trainable=attr.trainable)
        p.name = attr.name or _unique_name("param")
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        """A buffer, in the state dict unless ``persistable`` is False
        (torch's ``persistent=`` means the same); returns ``tensor``."""
        if persistent is not None:
            persistable = persistent
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    def create_tensor(self, name=None, persistable=False, dtype=None):
        """A 0-d zero tensor of ``dtype`` (the layer's by default),
        registered as buffer ``name`` when one is given."""
        t = torch.zeros((), dtype=convert_dtype(dtype) or self._dtype)
        if name:
            self.register_buffer(name, t, persistable)
        return t

    # -- traversal ---------------------------------------------------------
    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        """(structured name, layer) of every sublayer in pre-order, each
        once (``layers_set``: ids already seen), the layer itself first
        with ``include_self``."""
        walk = _walk(self, prefix, set() if layers_set is None
                     else layers_set)
        for i, (name, layer) in enumerate(walk):
            if i or include_self:
                yield name, layer

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, *, recurse=None):
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def parameters(self, include_sublayers=True, *, recurse=None):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, *, recurse=None):
        return super().named_buffers(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *,
                   prefix=None, keep_vars=False):
        """Parameters, then persistable buffers, by structured name, the
        reference's order (torch's detached tensors, sharing storage);
        without ``include_sublayers`` the layer's own only.  ``use_hook``
        is accepted and unused, as in the reference.
        ``structured_name_prefix`` is joined to each name with a dot, as
        the reference joins it; torch's ``prefix`` is prepended as it is."""
        if prefix is None:
            prefix = structured_name_prefix + "." \
                if structured_name_prefix else ""
        if not include_sublayers:
            dest = OrderedDict() if destination is None else destination
            self._save_to_state_dict(dest, prefix, keep_vars)
            return dest
        if destination is not None:   # torch's recursion into a sublayer
            return super().state_dict(destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        sd = super().state_dict(prefix=prefix, keep_vars=keep_vars)
        params = {prefix + n for n, _ in self.named_parameters()}
        out = OrderedDict((k, v) for k, v in sd.items() if k in params)
        out.update((k, v) for k, v in sd.items() if k not in params)
        out._metadata = sd._metadata
        return out

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)`` after every forward; a result
        that is not None replaces the output.  Returns a handle whose
        ``remove()`` unregisters it."""
        return self.register_forward_hook(hook)

    def full_name(self):
        return self._full_name

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    @contextlib.contextmanager
    def no_sync(self):
        yield  # the data-parallel gradient sync's pause: nothing outside it

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
    def to(self, device=None, dtype=None, blocking=None, **kwargs):
        """The reference's ``to(device=None, dtype=None, blocking=None)``
        beside ``torch.nn.Module.to``'s forms: ``device`` a device, a
        tensor (its device and dtype, as torch's ``to(tensor)``) or a
        dtype (torch's ``to(dtype)``; a Paddle name such as ``"float32"``
        names no device, so it is taken as the dtype); ``dtype`` a torch
        dtype or a Paddle name; ``blocking`` accepted and unused, as in
        the reference; ``non_blocking=`` and ``memory_format=`` go to
        torch.  A dtype also becomes every sublayer's ``_dtype``.  Each
        floating parameter and buffer is cast in place: a parameter keeps
        its object (so an optimizer built earlier still holds it)."""
        if isinstance(device, torch.Tensor):
            device, dtype = device.device, dtype or device.dtype
        elif isinstance(device, torch.dtype) or (
                isinstance(device, str) and not _names_a_device(device)):
            device, dtype = None, dtype or device
        dtype = convert_dtype(dtype)
        super().to(device=device, dtype=dtype, **kwargs)
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
