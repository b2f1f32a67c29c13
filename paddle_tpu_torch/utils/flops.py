"""Forward floating-point operation counts (the counter behind
``paddle_tpu_torch.flops``; the reference reads XLA's compiled
``cost_analysis``).

:class:`FlopCounter` is a ``TorchDispatchMode``: it sees every ATen op a
forward issues, on any device, and counts each by XLA's ``flops``
convention (xla/service/hlo_cost_analysis.cc):

- a matrix product or a convolution: 2 x output elements x the reduced
  extent (its bias add, where it has one, 1 an output element);
- elementwise arithmetic and comparisons: 1 an output element;
- a reduction: 1 an input element (a mean also divides its outputs);
- transcendentals (exp, log, erf, tanh, rsqrt, ...), casts and data
  movement: 0.

A hand-written kernel launched through ctypes is invisible to the
dispatcher, so each fused op (ops/kernels) counts itself: its wrapper
enters :func:`fused` with the analytic count of its plain version's ops,
which suspends the counter inside it.  The count is then the same on the
CPU, where the plain version runs, as on the card, where the kernel does.
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_active: list = []        # the counters of the enclosing flops() calls


def _numel(shape) -> int:
    return math.prod(int(s) for s in shape)


def _out_numel(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel()
    if isinstance(out, (tuple, list)) and out \
            and isinstance(out[0], torch.Tensor):
        return out[0].numel()
    return 0


_ELEMENTWISE = {
    "add", "sub", "mul", "div", "neg", "abs", "rsub", "maximum", "minimum",
    "clamp", "clamp_min", "clamp_max", "where", "eq", "ne", "lt", "le",
    "gt", "ge", "reciprocal", "sign", "floor", "ceil", "round", "relu",
    "threshold", "fmod", "remainder", "logical_and", "logical_or",
    "logical_not", "bitwise_and", "bitwise_or", "masked_fill", "square",
    "hardtanh", "relu6", "lerp",
}
_TWO_A_ELEMENT = {"addcmul", "addcdiv", "leaky_relu", "elu", "silu",
                  "hardsigmoid", "hardswish"}
_REDUCTIONS = {"sum", "amax", "amin", "max", "min", "prod", "norm",
               "linalg_vector_norm", "argmax", "argmin", "any", "all",
               "cumsum"}


def _mm(args, out):
    return 2 * out.numel() * args[0].shape[-1]


def _conv(args, out):
    x, w, bias = args[0], args[1], args[2]
    transposed = bool(args[6]) if len(args) > 6 else False
    if transposed:
        n = 2 * x.numel() * w.shape[1] * _numel(w.shape[2:])
    else:
        n = 2 * out.numel() * w.shape[1] * _numel(w.shape[2:])
    return n + (out.numel() if bias is not None else 0)


def _softmax(args, out):
    # max, subtract, (exp), sum, divide: 4 an element (jax.nn.softmax and
    # log_softmax alike)
    return 4 * out.numel()


def _mean(args, out):
    return args[0].numel() + out.numel()


def _var(args, out):
    # mean (reduce + divide), subtract, square, reduce, divide
    return 3 * args[0].numel() + 2 * out.numel()


def _gelu(args, out):
    # x * (erf(x / sqrt(2)) + 1) / 2; the tanh form adds 4 more
    tanh = len(args) > 1 and args[1] == "tanh"
    return (8 if tanh else 4) * out.numel()


def _pool(args, out):
    kernel = args[1] if len(args) > 1 else ()
    return out.numel() * _numel(kernel)


def _adaptive_avg(args, out):
    return args[0].numel() + out.numel()


def _batch_norm(args, out):
    # inference form: (x - mean) * (w * rsqrt(var + eps)) + b
    x = args[0]
    c = x.shape[1] if x.dim() > 1 else x.shape[0]
    return 3 * x.numel() + 2 * c


def _layer_norm(args, out):
    x, shape = args[0], args[1]
    n = x.numel()
    return layer_norm_flops(n, n // max(_numel(shape), 1))


def layer_norm_flops(n, rows):
    """LayerNorm over ``rows`` rows, ``n`` elements in all: two means (a
    reduction and a divide each), the centring twice, the square, the
    epsilon, the scaling by rstd, the weight and the bias."""
    return 8 * n + 3 * rows


def _logsumexp(args, out):
    # max, subtract, (exp), sum an element; (log), add a row
    return 3 * args[0].numel() + out.numel()


def _pow(args, out):
    # an integer power is multiplies (XLA's integer_pow), any other a
    # transcendental
    e = args[1] if len(args) > 1 else None
    if isinstance(e, int) or (isinstance(e, float) and e.is_integer()):
        return max(abs(int(e)) - 1, 1) * out.numel()
    return 0


_RULES = {
    "mm": _mm, "addmm": lambda a, o: _mm(a[1:], o) + o.numel(),
    "bmm": _mm, "baddbmm": lambda a, o: _mm(a[1:], o) + o.numel(),
    "convolution": _conv, "_softmax": _softmax, "_log_softmax": _softmax,
    "mean": _mean, "var": _var, "var_mean": _var, "std": _var,
    "gelu": _gelu, "max_pool2d_with_indices": _pool,
    "max_pool1d_with_indices": _pool, "max_pool3d_with_indices": _pool,
    "avg_pool2d": lambda a, o: _pool(a, o) + o.numel(),
    "_adaptive_avg_pool2d": _adaptive_avg,
    "_native_batch_norm_legit_no_training": _batch_norm,
    "native_batch_norm": _batch_norm, "cudnn_batch_norm": _batch_norm,
    "miopen_batch_norm": _batch_norm, "native_layer_norm": _layer_norm,
    "logsumexp": _logsumexp, "pow": _pow,
}


class FlopCounter(TorchDispatchMode):
    """Counts the flops of every op issued while it is active (``total``);
    ops issued inside :func:`fused` are not counted, their wrapper counts
    them."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.suspended = 0

    def __enter__(self):
        _active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.suspended:
            self.total += op_flops(func, args, out)
        return out


def op_flops(func, args, out) -> int:
    """One ATen op's flops by the rules of this module."""
    name = func.overloadpacket.__name__.rstrip("_")
    rule = _RULES.get(name)
    if rule is not None:
        return int(rule(args, out[0] if isinstance(out, tuple) else out))
    if name in _ELEMENTWISE:
        return _out_numel(out)
    if name in _TWO_A_ELEMENT:
        return 2 * _out_numel(out)
    if name in _REDUCTIONS:
        return args[0].numel() if isinstance(args[0], torch.Tensor) else 0
    return 0


_NULL = contextlib.nullcontext()


class _Fused:
    __slots__ = ("counter",)

    def __init__(self, counter):
        self.counter = counter

    def __enter__(self):
        self.counter.suspended += 1

    def __exit__(self, *exc):
        self.counter.suspended -= 1


def fused(count):
    """The scope of one fused op: adds ``count()`` (the analytic flops of
    its plain version) to the active counter and suspends counting inside.
    Outside a count it is a no-op that never calls ``count``."""
    if not _active:
        return _NULL
    c = _active[-1]
    if c.suspended:
        return _NULL
    c.total += int(count())
    return _Fused(c)


def counted(count):
    """Decorator of a fused op's entry: while a count is active, each call
    adds ``count(*args, **kwargs)`` and runs inside :func:`fused`."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if not _active:
                return fn(*args, **kwargs)
            with fused(lambda: count(*args, **kwargs)):
                return fn(*args, **kwargs)
        return entry
    return wrap
