"""Transformer layers (port of paddle_tpu/nn/layer/transformer.py:
``MultiHeadAttention`` with its ``Cache``, ``StaticCache`` and
``gen_cache``, ``TransformerEncoderLayer``, ``_clone_layer``,
``TransformerEncoder``, ``TransformerDecoderLayer``,
``TransformerDecoder`` and ``Transformer``).

The attention core goes through ``F.scaled_dot_product_attention`` to
ops/fused.py and the flash-attention kernels, which take every form the
stack runs: self-attention (the encoder; the decoder's, under the
additive subsequent mask), cross-attention over the memory (S_q != S_k,
with the source's padding mask), and a cached decode step (S_q = 1
against the cache), causal or not, with a bool or additive mask, and in
training ``MultiHeadAttention``'s dropout on the weights inside the
kernels.  The encoder's FFN GeLU goes through ``fused.linear_bias_gelu``
(the bias+GeLU kernel); the decoder's FFN is ``getattr(F,
activation)(linear1(x))``, as the reference's is.
"""
from __future__ import annotations

import collections

import torch

from ...framework.place import resolve_device
from ...ops import fused
from .. import functional as F
from ..layer_base import Layer
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm


class MultiHeadAttention(Layer):
    """The reference's attention layer.  ``forward(query, key, value,
    attn_mask, cache)`` returns the output, or with a cache ``(out,
    cache)``: an incremental ``Cache`` comes back with this step's keys
    and values appended along S, a ``StaticCache`` (the memory's keys and
    values, projected once) as it was."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

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

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """``type=StaticCache``: the keys and values of ``key`` (and
        ``value``, else ``key``) projected once.  Without ``value``: an
        empty incremental ``Cache``, [B, 0, H, head_dim] in the
        projection weight's dtype and on its device (the reference pins
        the dtype so a bf16 model's steps are not upcast).  Else
        ``Cache(key, value)``."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(key if value is None
                                              else value))
            return self.StaticCache(k, v)
        if value is None:
            w = self.k_proj.weight
            shape = (key.shape[0], 0, self.num_heads, self.head_dim)
            return self.Cache(w.new_zeros(shape), w.new_zeros(shape))
        return self.Cache(key, value)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], 1)
                v = torch.cat([cache.v, v], 1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(None)         # weights unavailable on the flash path
        if cache is not None:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


def _config(d_model, nhead, dim_feedforward, dropout, activation,
            attn_dropout, act_dropout, normalize_before, weight_attr,
            bias_attr):
    """A layer's constructor arguments, the dropouts resolved, so a stack
    re-instantiates each layer with a fresh init (_clone_layer), as the
    reference does."""
    return dict(d_model=d_model, nhead=nhead,
                dim_feedforward=dim_feedforward, dropout=dropout,
                activation=activation,
                attn_dropout=dropout if attn_dropout is None
                else attn_dropout,
                act_dropout=dropout if act_dropout is None else act_dropout,
                normalize_before=normalize_before, weight_attr=weight_attr,
                bias_attr=bias_attr)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self._config = cfg = _config(
            d_model, nhead, dim_feedforward, dropout, activation,
            attn_dropout, act_dropout, normalize_before, weight_attr,
            bias_attr)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            cfg["attn_dropout"],
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(cfg["act_dropout"])
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
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
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


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

    def forward(self, src, src_mask=None, cache=None):
        out, new_caches = src, []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, src_mask)
            else:
                out, c = layer(out, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention (its ``tgt_mask``), cross-attention over the
    encoder's ``memory`` (its ``memory_mask``) and the FFN, post- or
    pre-LN.  With ``cache`` (``gen_cache(memory)``: the incremental
    ``Cache`` and the memory's ``StaticCache``) it returns ``(out,
    (incremental, static))``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self._config = cfg = _config(
            d_model, nhead, dim_feedforward, dropout, activation,
            attn_dropout, act_dropout, normalize_before, weight_attr,
            bias_attr)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            cfg["attn_dropout"],
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead,
                                             cfg["attn_dropout"],
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(cfg["act_dropout"])
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                              cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static = self.cross_attn(tgt, memory, memory, memory_mask,
                                          cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(
            getattr(F, self.activation)(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental, static))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer if i == 0 else _clone_layer(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out, new_caches = tgt, []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, memory, tgt_mask, memory_mask)
            else:
                out, c = layer(out, memory, tgt_mask, memory_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """Each layer's (incremental, static) caches; ``do_zip``: as two
        lists (every layer's incremental, every layer's static)."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(Layer):
    """The encoder-decoder stack; its defaults are Transformer-base
    (Vaswani et al., 2017): d_model 512, 8 heads, 6 + 6 layers, FFN 2048,
    dropout 0.1, ReLU, post-LN.  ``forward(src, tgt, src_mask, tgt_mask,
    memory_mask)`` returns the decoder's output; embeddings and the output
    projection are the caller's."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        layer_args = (d_model, nhead, dim_feedforward, dropout, activation,
                      attn_dropout, act_dropout, normalize_before,
                      weight_attr, bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*layer_args), num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*layer_args), num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """float32 [length, length]: 0 on and below the diagonal, -1e9
        above, as the reference's.  ``device`` None means the card (the
        reference takes no device; the port's entries run on the card
        unless told otherwise)."""
        return torch.full((length, length), -1e9, dtype=torch.float32,
                          device=resolve_device(device)).triu(1)
