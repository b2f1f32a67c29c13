"""Identity / Linear / Embedding / Dropout / Flatten (port of
paddle_tpu/nn/layer/common.py)."""
from __future__ import annotations

from ... import tensor_ops as T
from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Linear(Layer):
    """weight shape [in_features, out_features] (paddle convention)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None):
        super().__init__()
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))

    def forward(self, x):
        return F.embedding(x, self.weight)


class Dropout(Layer):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return T.flatten(x, self.start_axis, self.stop_axis)
