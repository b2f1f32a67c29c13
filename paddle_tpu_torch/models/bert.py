"""BERT/ERNIE bidirectional encoder with the pretraining heads (port of
paddle_tpu/models/bert.py, whole: ``BertConfig``, ``BertEmbeddings``,
``BertModel``, ``BertForPretraining`` and ``ErnieModel``).

Built on the port's ``TransformerEncoder``: non-causal attention through
the flash-attention kernels, with the attention mask (bool, True =
attend, or additive, broadcastable to [B, H, S, S]) as the kernels' bias;
the FFN's GeLU through the bias+GeLU kernels; LayerNorm through its
kernel.  ``BertForPretraining.loss`` is the MLM + NSP objective through
the softmax cross-entropy kernels, with the MLM decoder tied to
``embeddings.word.weight`` plus ``mlm_bias``.  Parameter names equal the
reference's (``bert.encoder.layers.0.self_attn.q_proj.weight`` ...), so
weights carry over by name (models/convert.py).

The top-level models are built on the CPU from the framework generator
(framework/random.py), then moved to ``device`` (None = the CUDA card;
raises where there is none) in ``dtype``, as ``GPTForCausalLM`` is.
``dropout`` is also the attention dropout, applied inside the
flash-attention kernels in training, so ``BertConfig()`` trains at its
defaults.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import tensor_ops as T
from ..framework.place import resolve_device
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import TransformerEncoder, TransformerEncoderLayer
from ..nn.layer_base import Layer, ParamAttr
from ..ops import fused


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02


def _init(cfg):
    return ParamAttr(initializer=I.Normal(0.0, cfg.initializer_range))


class BertEmbeddings(Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word = Embedding(cfg.vocab_size, cfg.hidden_size,
                              weight_attr=_init(cfg))
        self.position = Embedding(cfg.max_position_embeddings,
                                  cfg.hidden_size, weight_attr=_init(cfg))
        self.token_type = Embedding(cfg.type_vocab_size, cfg.hidden_size,
                                    weight_attr=_init(cfg))
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_epsilon)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word(input_ids) + self.position(pos)
        if token_type_ids is None:
            # absent segment ids mean segment 0: the type-0 row is still
            # added (the reference's checkpoint-parity rule)
            x = x + self.token_type.weight[0]
        else:
            x = x + self.token_type(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertModel(Layer):
    def __init__(self, cfg: BertConfig | None = None, device=None,
                 dtype=torch.float32, **kwargs):
        device = resolve_device(device)
        super().__init__()
        self.cfg = cfg or BertConfig(**kwargs)
        cfg = self.cfg
        self.embeddings = BertEmbeddings(cfg)
        layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.dropout, activation="gelu")
        self.encoder = TransformerEncoder(layer, cfg.num_layers)
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size,
                             weight_attr=_init(cfg))
        self.to(device=device, dtype=dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        seq = self.encoder(x, src_mask=attention_mask)
        pooled = F.tanh(self.pooler(seq[:, 0]))
        return seq, pooled


class BertForPretraining(Layer):
    """MLM + NSP heads (the BERT-base pretraining objective)."""

    def __init__(self, cfg: BertConfig | None = None, device=None,
                 dtype=torch.float32, **kwargs):
        device = resolve_device(device)
        super().__init__()
        self.bert = BertModel(cfg, device="cpu", **kwargs)
        cfg = self.bert.cfg
        self.mlm_transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                    weight_attr=_init(cfg))
        self.mlm_norm = LayerNorm(cfg.hidden_size,
                                  epsilon=cfg.layer_norm_epsilon)
        self.mlm_bias = self.create_parameter([cfg.vocab_size], is_bias=True)
        self.nsp = Linear(cfg.hidden_size, 2, weight_attr=_init(cfg))
        self.to(device=device, dtype=dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        # the decoder is tied to the word embedding (BERT weight tying)
        logits = T.matmul(h, self.bert.embeddings.word.weight,
                          transpose_y=True)
        return logits + self.mlm_bias, self.nsp(pooled)

    def loss(self, input_ids, mlm_labels, nsp_labels, token_type_ids=None,
             ignore_index=-100):
        """MLM loss summed over the labelled tokens and divided by their
        count (at least 1), plus the mean NSP loss; both through the
        softmax cross-entropy kernels."""
        mlm_logits, nsp_logits = self.forward(input_ids, token_type_ids)
        mlm = fused.softmax_cross_entropy(mlm_logits, mlm_labels,
                                          ignore_index=ignore_index)
        denom = (mlm_labels != ignore_index).float().sum()
        mlm_loss = mlm.sum() / denom.clamp(min=1.0)
        nsp_loss = fused.softmax_cross_entropy(nsp_logits, nsp_labels).mean()
        return mlm_loss + nsp_loss


class ErnieModel(BertModel):
    """ERNIE 1.0/2.0 share BERT's graph with other defaults and data
    (entity masking lives in the data pipeline, not the model)."""

    def __init__(self, cfg: BertConfig | None = None, device=None,
                 dtype=torch.float32, **kwargs):
        if cfg is None:
            defaults = dict(vocab_size=18000, type_vocab_size=4)
            defaults.update(kwargs)
            cfg = BertConfig(**defaults)
        super().__init__(cfg, device=device, dtype=dtype)
