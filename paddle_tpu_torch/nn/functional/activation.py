"""Activations, ``one_hot`` and ``label_smooth`` (port of
paddle_tpu/nn/functional/__init__.py:40-200 and :240-262: the entries the
GPT and BERT paths did not need).  Elementwise jnp math in the reference,
PyTorch's ops here, each with the reference's formula and defaults
(``hardsigmoid``'s slope 0.1666667 and offset 0.5, ``softplus``'s
threshold on beta * x, ``selu``'s scale and alpha as arguments,
``maxout``'s groups split after the channel)."""
from __future__ import annotations

import torch

_F = torch.nn.functional


def relu_(x, name=None):
    return torch.relu_(x)


def relu6(x, name=None):
    return x.clamp(0.0, 6.0)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return _F.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0, name=None):
    return _F.elu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return _F.celu(x, alpha)


def silu(x, name=None):
    return _F.silu(x)


swish = silu


def mish(x, name=None):
    return _F.mish(x)


def hardswish(x, name=None):
    return x * (x + 3.0).clamp(0.0, 6.0) / 6.0


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return (x * slope + offset).clamp(0.0, 1.0)


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return x.clamp(min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    return torch.sign(x) * (x.abs() - threshold).clamp_min(0.0)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _F.softplus(x, beta, threshold)


def softsign(x, name=None):
    return _F.softsign(x)


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def log_sigmoid(x, name=None):
    return _F.logsigmoid(x)


def prelu(x, weight, data_format="NCHW", name=None):
    """max(0, x) + w * min(0, x): one weight for all, or one a channel
    (axis 1, or the last axis for a channel-last ``data_format``)."""
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format[1] == "C" else x.dim() - 1] = weight.numel()
        w = weight.reshape(shape)
    return torch.where(x > 0, x, w * x)


def glu(x, axis=-1, name=None):
    return _F.glu(x, axis)


def maxout(x, groups, axis=1, name=None):
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis] = shape[axis] // groups
    shape.insert(axis + 1, groups)
    return x.reshape(shape).amax(axis + 1)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with Gumbel noise g from torch's
    generator (not the reference's JAX key chain); ``hard`` gives the
    one-hot of the argmax with the soft sample's gradient."""
    u = torch.rand(x.shape, dtype=x.dtype, device=x.device).clamp_min(1e-20)
    y = torch.softmax((x - torch.log(-torch.log(u))) / temperature, axis)
    if hard:
        idx = y.argmax(axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


def one_hot(x, num_classes, name=None):
    """float32 one-hot over a new last axis."""
    return _F.one_hot(x.long(), num_classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


# the activations the package's ``__init__`` defines, under this module's
# path too (the reference's ``activation`` module re-exports them); read
# at access: this module is imported before the package defines them
_FROM_PACKAGE = ("relu", "gelu", "softmax", "log_softmax", "tanh")


def __getattr__(name):
    if name in _FROM_PACKAGE:
        from .. import functional
        return getattr(functional, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
