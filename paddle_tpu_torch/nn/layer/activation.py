"""Activation layers (port of paddle_tpu/nn/layer/activation.py): the
reference's ``_simple`` table, one layer a functional activation whose
positional arguments follow ``_SIGS``, and ``PReLU``."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer


def _simple(name, fn_name, **fixed):
    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        self._kwargs = {**fixed}
        for k, v in zip(_SIGS.get(fn_name, []), args):
            self._kwargs[k] = v
        for k, v in kwargs.items():
            if k != "name":
                self._kwargs[k] = v

    def forward(self, x):
        return getattr(F, fn_name)(x, **self._kwargs)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward})


_SIGS = {
    "leaky_relu": ["negative_slope"],
    "elu": ["alpha"],
    "celu": ["alpha"],
    "gelu": ["approximate"],
    "hardshrink": ["threshold"],
    "hardtanh": ["min", "max"],
    "hardsigmoid": [],
    "softplus": ["beta", "threshold"],
    "softshrink": ["threshold"],
    "thresholded_relu": ["threshold"],
    "softmax": ["axis"],
    "log_softmax": ["axis"],
    "maxout": ["groups", "axis"],
    "glu": ["axis"],
}

ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
GELU = _simple("GELU", "gelu")
Sigmoid = _simple("Sigmoid", "sigmoid")
Tanh = _simple("Tanh", "tanh")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
LeakyReLU = _simple("LeakyReLU", "leaky_relu")
ELU = _simple("ELU", "elu")
CELU = _simple("CELU", "celu")
SELU = _simple("SELU", "selu")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "swish")
Mish = _simple("Mish", "mish")
Hardswish = _simple("Hardswish", "hardswish")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Hardtanh = _simple("Hardtanh", "hardtanh")
Hardshrink = _simple("Hardshrink", "hardshrink")
Softshrink = _simple("Softshrink", "softshrink")
Softplus = _simple("Softplus", "softplus")
Softsign = _simple("Softsign", "softsign")
ThresholdedReLU = _simple("ThresholdedReLU", "thresholded_relu")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
Softmax = _simple("Softmax", "softmax")
LogSoftmax = _simple("LogSoftmax", "log_softmax")
Maxout = _simple("Maxout", "maxout")
GLU = _simple("GLU", "glu")


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)
