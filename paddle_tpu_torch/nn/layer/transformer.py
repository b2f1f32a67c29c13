"""Transformer encoder layers (port of paddle_tpu/nn/layer/transformer.py:
``MultiHeadAttention`` without a cache, ``TransformerEncoderLayer``,
``_clone_layer`` and ``TransformerEncoder``).

The attention core goes through ``F.scaled_dot_product_attention`` to
ops/fused.py and the flash-attention kernels, which take the
self-attention forms: causal or not, with a bool or additive mask, and
in training ``MultiHeadAttention``'s dropout on the weights inside the
kernels.  The FFN's GeLU goes through ``fused.linear_bias_gelu`` (the
bias+GeLU kernel).  Not ported yet (ROADMAP.md): the KV caches
(``Cache``, ``StaticCache``, ``gen_cache``), cross-attention with
S_q != S_k, ``TransformerDecoderLayer``, ``TransformerDecoder`` and
``Transformer``.
"""
from __future__ import annotations

from ...ops import fused
from .. import functional as F
from ..layer_base import Layer
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if self.need_weights:
            return out, None          # weights unavailable on the flash path
        return out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        # the constructor's arguments, so a stack re-instantiates each
        # layer with a fresh init (_clone_layer), as the reference does
        self._config = dict(d_model=d_model, nhead=nhead,
                            dim_feedforward=dim_feedforward, dropout=dropout,
                            activation=activation, attn_dropout=attn_dropout,
                            act_dropout=act_dropout,
                            normalize_before=normalize_before,
                            weight_attr=weight_attr, bias_attr=bias_attr)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = activation

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        if self.activation == "gelu":
            # the expansion matmul with the fused bias+GeLU kernel
            h = fused.linear_bias_gelu(src, self.linear1.weight,
                                       self.linear1.bias)
        else:
            h = getattr(F, self.activation)(self.linear1(src))
        src = self.linear2(self.dropout(h))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


def _clone_layer(layer):
    """A fresh instance from the layer's constructor arguments (a fresh
    random init, as the reference builds each layer anew)."""
    return type(layer)(**layer._config)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer if i == 0 else _clone_layer(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        return out if self.norm is None else self.norm(out)
