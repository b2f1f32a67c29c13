"""Normalisation layers (port of paddle_tpu/nn/layer/norm.py): LayerNorm,
BatchNorm (the fluid form, with ``act``), BatchNorm1D/2D/3D,
SyncBatchNorm, GroupNorm, InstanceNorm1D/2D/3D and LocalResponseNorm.

A batch norm layer keeps its running statistics in the buffers ``_mean``
(zeros) and ``_variance`` (ones), float32, the reference's
``state_dict`` names (there is no ``num_batches_tracked``); in training
``F.batch_norm`` moves them in place (nn/functional/norm.py), so a
captured train step updates the tensors its eager step does.
``Layer.astype`` casts them with the parameters, as the reference's
``astype`` casts floating buffers.  On one device ``SyncBatchNorm`` is
``BatchNorm``, as the reference says of its own eager form; a mesh comes
with the distributed slice.  SpectralNorm is not ported yet (ROADMAP.md
A10).
"""
from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter(self._normalized_shape, attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else \
            self.create_parameter(self._normalized_shape, attr=bias_attr,
                                  is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """The fluid ``BatchNorm(num_channels)``, with an activation ``act``
    (an nn.functional name) after it."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, use_global_stats=False,
                 **kwargs):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr,
                         "NCW" if data_format == "NCL" else data_format,
                         use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Batch statistics over the whole batch; on one device that is
    ``BatchNorm``."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Replace every batch norm sublayer of ``layer`` (the layer itself
        excepted) by a SyncBatchNorm holding copies of its parameters and
        statistics, on its device and in its dtype; returns ``layer``."""
        for parent in list(layer.modules()):
            for name, sub in list(parent._modules.items()):
                if not isinstance(sub, _BatchNormBase) \
                        or isinstance(sub, SyncBatchNorm):
                    continue
                nb = SyncBatchNorm(sub._num_features, sub._momentum,
                                   sub._epsilon,
                                   data_format=sub._data_format)
                nb.to(device=sub._mean.device, dtype=sub._mean.dtype)
                with torch.no_grad():
                    for key, value in sub.state_dict().items():
                        nb.state_dict()[key].copy_(value)
                parent._modules[name] = nb
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter([num_features], attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else \
            self.create_parameter([num_features], attr=bias_attr,
                                  is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm2D(InstanceNorm1D):
    pass


class InstanceNorm3D(InstanceNorm1D):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)
