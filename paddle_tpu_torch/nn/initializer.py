"""Weight initializers (port of paddle_tpu/nn/initializer.py).  Values are
drawn in float32 on the CPU from the framework generator
(framework/random.py) and then cast, so a seed fixes the weights
independently of the device they end up on.  The draws are torch's, not
JAX's: the same seed gives other numbers than the reference, from the same
distributions (the tests hand both sides the same weights)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework import random as _random


class Initializer:
    def __call__(self, shape, dtype=torch.float32):
        return self.generate(tuple(int(s) for s in shape), dtype)

    def generate(self, shape, dtype):
        raise NotImplementedError


def _fans(shape):
    """(fan_in, fan_out) with the reference's conventions: a 2-D weight is
    [in, out] (Linear), a conv weight [out_c, in_c, *k]."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _uniform(shape, low, high):
    u = torch.rand(shape, generator=_random.default_generator(),
                   dtype=torch.float32)
    return u * (high - low) + low


def _normal(shape):
    return torch.randn(shape, generator=_random.default_generator(),
                       dtype=torch.float32)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def generate(self, shape, dtype):
        return torch.full(shape, float(self.value), dtype=dtype)


class Assign(Initializer):
    """The given array (a numpy array, list or tensor) reshaped to the
    parameter's shape."""

    def __init__(self, value):
        self.value = value

    def generate(self, shape, dtype):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().float().numpy()
        v = np.asarray(getattr(v, "numpy", lambda: v)(), dtype=np.float32)
        return torch.from_numpy(v.copy()).reshape(shape).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def generate(self, shape, dtype):
        return _uniform(shape, float(self.low), float(self.high)).to(dtype)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def generate(self, shape, dtype):
        return (_normal(shape) * self.std + self.mean).to(dtype)


class TruncatedNormal(Initializer):
    """A normal truncated to two standard deviations (the reference's
    ``jax.random.truncated_normal(key, -2, 2)``), by the inverse CDF of a
    uniform draw over [Phi(-2), Phi(2)]."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def generate(self, shape, dtype):
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        u = _uniform(shape, lo, 1.0 - lo)
        n = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-2.0, 2.0)
        return (n * self.std + self.mean).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def generate(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit).to(dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def generate(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (_normal(shape) * std).to(dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def generate(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, -limit, limit).to(dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def generate(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return (_normal(shape) * (gain / math.sqrt(fi))).to(dtype)


class Orthogonal(Initializer):
    """``gain`` times a matrix with orthonormal columns (or rows), over the
    last axis against the product of the others, as
    ``jax.nn.initializers.orthogonal``: the Q of a normal draw's QR, its
    columns' signs fixed by R's diagonal."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def generate(self, shape, dtype):
        n_cols = shape[-1]
        n_rows = int(np.prod(shape)) // n_cols
        flip = n_rows < n_cols
        a = _normal((n_cols, n_rows) if flip else (n_rows, n_cols))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if flip:
            q = q.t()
        return (self.gain * q.reshape(shape)).to(dtype)


class Dirac(Initializer):
    """A conv weight that passes channel i % in_c through to output i at
    the kernel's centre."""

    def __init__(self, groups=1):
        self.groups = groups

    def generate(self, shape, dtype):
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        for i in range(min(oc, ic * self.groups)):
            idx = tuple([i, i % ic] + [s // 2 for s in shape[2:]])
            out[idx] = 1.0
        return torch.from_numpy(out).to(dtype)


# the fluid.initializer names
ConstantInitializer = Constant
NormalInitializer = Normal
UniformInitializer = Uniform
XavierInitializer = XavierUniform
MSRAInitializer = KaimingNormal
TruncatedNormalInitializer = TruncatedNormal
