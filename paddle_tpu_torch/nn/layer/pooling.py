"""Pooling layers (port of paddle_tpu/nn/layer/pooling.py) over
nn/functional/pooling.py."""
from __future__ import annotations

from .. import functional as F
from ..layer_base import Layer


class _Pool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format=None, name=None, **kw):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def forward(self, x):
        kw = {"data_format": self.data_format} if self.data_format else {}
        return getattr(F, self._fn)(x, self.kernel_size, self.stride,
                                    self.padding, ceil_mode=self.ceil_mode,
                                    **kw)


class MaxPool1D(_Pool):
    _fn = "max_pool1d"


class MaxPool2D(_Pool):
    _fn = "max_pool2d"


class MaxPool3D(_Pool):
    _fn = "max_pool3d"


class _AvgPool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, divisor_override=None, data_format=None,
                 name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.exclusive = exclusive
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def forward(self, x):
        kw = {"data_format": self.data_format} if self.data_format else {}
        return getattr(F, self._fn)(x, self.kernel_size, self.stride,
                                    self.padding, exclusive=self.exclusive,
                                    ceil_mode=self.ceil_mode, **kw)


class AvgPool1D(_AvgPool):
    _fn = "avg_pool1d"


class AvgPool2D(_AvgPool):
    _fn = "avg_pool2d"


class AvgPool3D(_AvgPool):
    _fn = "avg_pool3d"


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)
