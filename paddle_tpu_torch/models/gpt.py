"""GPT decoder-only language model: the serving and training subset of
paddle_tpu/models/gpt.py.

Ported: ``GPTConfig``, ``GPTAttention.forward`` (prefill and training,
through the causal flash-attention kernels, forward and backward) and
``decode_pages`` (through the paged decode kernel), ``GPTMLP`` (bias+GeLU
kernels), ``GPTBlock``, ``GPTModel`` and ``GPTForCausalLM`` with
``forward`` (with labels: through the softmax cross-entropy kernels), the
training ``loss`` (the chunked fused LM-head cross entropy), ``_head``,
``slot_prefill`` and ``slot_decode_paged``.  Parameter names equal the
reference's (``gpt.h_0.attn.qkv.weight`` ...), so weights carry over by
name (models/convert.py).  Not ported yet (ROADMAP.md): attention dropout
in training, tensor-parallel and sequence-parallel layouts, recompute,
beam search and ``generate``.

The paged decode updates the KV pool IN PLACE: where the reference's
jitted step donates the pool and returns a functionally updated copy, the
port writes each lane's new token K/V into the pool tensor it was given
(allocated once by the engine) and returns that same tensor.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..framework.place import resolve_device
from ..nn import initializer as I
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.norm import LayerNorm
from ..nn.layer_base import Layer, ParamAttr
from ..ops import fused


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden_size: int | None = None  # default 4*hidden
    max_position_embeddings: int = 1024
    dropout: float = 0.1
    attn_dropout: float = 0.1
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True

    @property
    def ffn_size(self):
        return self.ffn_hidden_size or 4 * self.hidden_size


def _init(cfg):
    return ParamAttr(initializer=I.Normal(0.0, cfg.initializer_range))


def _scatter_token(k_pages, v_pages, k, v, rows, pos, active):
    """Write each active lane's token K/V at (rows[b, pos[b] // ps],
    pos[b] % ps) of one layer's pool plane, in place.

    The reference drops inactive lanes' writes through an out-of-bounds
    sentinel (``mode="drop"``); an out-of-bounds index on CUDA is a
    device-side fault instead, and selecting the valid lanes with a
    boolean mask would cost a host sync per layer.  So lanes that must
    not write re-target the first writing lane's slot with that lane's
    own value: duplicate indices then carry identical values and the
    scatter stays deterministic.  With no writing lane at all, every lane
    rewrites slot 0 with its current contents."""
    num_pages, ps, nh, hd = k_pages.shape
    lane = torch.arange(k.shape[0], device=k.device)
    page = rows[lane, (pos // ps).clamp(0, rows.shape[1] - 1)].long()
    ok = active & (page >= 0) & (page < num_pages)
    tgt = page.clamp(0, num_pages - 1) * ps + (pos % ps).long()
    # the first writing lane as a 1-element index tensor: indexing with
    # the 0-d argmax itself would copy it to the host (a sync per use)
    first = ok.to(torch.int32).argmax().reshape(1)
    any_ok = ok.any()
    fallback = torch.where(any_ok, tgt.index_select(0, first),
                           torch.zeros_like(tgt[:1]))
    tgt = torch.where(ok, tgt, fallback)
    for pool, new in ((k_pages, k), (v_pages, v)):
        flat = pool.view(num_pages * ps, nh, hd)
        new = new.to(pool.dtype)
        fill = torch.where(any_ok, new.index_select(0, first), flat[:1])
        flat.index_copy_(0, tgt, torch.where(ok[:, None, None], new, fill))


class GPTAttention(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.qkv = Linear(H, 3 * H, weight_attr=_init(cfg))
        self.out = Linear(H, H, weight_attr=_init(cfg))
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, return_kv=False):
        cfg = self.cfg
        B, S = x.shape[0], x.shape[1]
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        qkv = self.qkv(x).reshape(B, S, 3, nh, hd)
        # causal attention over the slices q, k, v of the fused projection
        # (the reference's scaled_dot_product_attention on them); the
        # backward kernels write one packed gradient of qkv
        ctx = fused.packed_causal_attention(
            qkv, dropout_p=cfg.attn_dropout, training=self.training)
        out = self.dropout(self.out(ctx.reshape(B, S, cfg.hidden_size)))
        if return_kv:
            # [B, S, nh, hd] each — prefill seeds the KV cache
            return out, qkv[:, :, 1], qkv[:, :, 2]
        return out

    def decode_pages(self, x, k_pages, v_pages, rows, pos, active, seq_cap):
        """Paged continuous-batching decode: one token per lane, each at
        its own position, attending over its pages of the pool.

        x: [slots, 1, H]; k_pages/v_pages: [num_pages, page_size, nh, hd]
        (this layer's pool plane, written in place); rows: [slots,
        pages_per_slot] int32 page table (-1 = unmapped); pos: [slots]
        int32 write index; active: [slots] bool; seq_cap: static
        attention extent.  Returns (out, k_pages, v_pages)."""
        cfg = self.cfg
        B = x.shape[0]
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        qkv = self.qkv(x).reshape(B, 1, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, 0, 1], qkv[:, 0, 2]
        _scatter_token(k_pages, v_pages, k, v, rows, pos, active)
        ctx = fused.paged_decode_attention(q, k_pages, v_pages, rows, pos,
                                           seq_cap)
        out = self.out(ctx.reshape(B, 1, cfg.hidden_size))
        return out, k_pages, v_pages


class GPTMLP(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        H, FF = cfg.hidden_size, cfg.ffn_size
        self.fc1 = Linear(H, FF, weight_attr=_init(cfg))
        self.fc2 = Linear(FF, H, weight_attr=_init(cfg))
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x):
        # expansion matmul with the fused bias+GeLU epilogue kernel
        h = fused.linear_bias_gelu(x, self.fc1.weight, self.fc1.bias)
        return self.dropout(self.fc2(h))


class GPTBlock(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon)
        self.attn = GPTAttention(cfg)
        self.ln_2 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon)
        self.mlp = GPTMLP(cfg)

    def forward(self, x, return_kv=False):
        if return_kv:
            a, k, v = self.attn(self.ln_1(x), return_kv=True)
            x = x + a
            x = x + self.mlp(self.ln_2(x))
            return x, k, v
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))

    def decode_pages(self, x, k_pages, v_pages, rows, pos, active, seq_cap):
        a, k_pages, v_pages = self.attn.decode_pages(
            self.ln_1(x), k_pages, v_pages, rows, pos, active, seq_cap)
        x = x + a
        x = x + self.mlp(self.ln_2(x))
        return x, k_pages, v_pages


class GPTModel(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size,
                             weight_attr=_init(cfg))
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                             weight_attr=_init(cfg))
        self.drop = Dropout(cfg.dropout)
        # registered one by one as h_0, h_1, ... (the reference's names);
        # a plain list keeps the iteration order without renaming them
        self.h = [self.add_sublayer(f"h_{i}", GPTBlock(cfg))
                  for i in range(cfg.num_layers)]
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.h:
            x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(Layer):
    """GPT with a (tied by default) LM head.  Built on the CPU from the
    framework generator (framework/random.py), then moved to ``device``
    (None = the CUDA card; raises where there is none) in ``dtype``."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=torch.float32):
        device = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        self.gpt = GPTModel(cfg)
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                                  weight_attr=_init(cfg), bias_attr=False)
        self.to(device=device, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.wte.weight.dtype

    def forward(self, input_ids, labels=None):
        """Logits [B, S, V]; with ``labels`` [B, S], also the mean
        next-token loss through the softmax cross-entropy kernels, which
        read the strided view ``logits[:, :-1]`` in place."""
        logits = self._head(self.gpt(input_ids))
        if labels is None:
            return logits
        loss = fused.softmax_cross_entropy(logits[:, :-1], labels[:, 1:])
        return logits, loss.mean()

    def loss(self, input_ids):
        """Next-token LM loss on a batch of token ids [B, S], through the
        chunked fused LM-head matmul + cross entropy
        (ops/fused.py fused_linear_cross_entropy): the float32 [B*S, V]
        logits never exist at once.  Returns the mean, a float32 scalar."""
        hidden = self.gpt(input_ids)
        if self.cfg.tie_word_embeddings:
            w = self.gpt.wte.weight.t()
        else:
            w = self.lm_head.weight
        loss = fused.fused_linear_cross_entropy(hidden[:, :-1], w,
                                                input_ids[:, 1:])
        return loss.mean()

    def _head(self, hidden):
        if self.cfg.tie_word_embeddings:
            return torch.matmul(hidden, self.gpt.wte.weight.t())
        return self.lm_head(hidden)

    def _check_eval(self):
        if self.training:
            raise RuntimeError(
                "slot_prefill/slot_decode are eval-only serving paths; "
                "call model.eval() first")

    @torch.no_grad()
    def slot_prefill(self, input_ids, length):
        """Serving prefill for ONE request: input_ids [1, Sp] right-padded
        to the prompt bucket, ``length`` the real prompt length L (an
        int).  Causal attention keeps the padded tail invisible to
        positions < L.  Returns (k [layers, Sp, nh, hd], v, logits [V] at
        position L-1)."""
        self._check_eval()
        gpt = self.gpt
        length = int(length)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = gpt.drop(gpt.wte(input_ids) + gpt.wpe(pos))
        ks, vs = [], []
        for blk in gpt.h:
            x, k, v = blk(x, return_kv=True)
            ks.append(k[0])
            vs.append(v[0])
        hidden = gpt.ln_f(x)                         # [1, Sp, H]
        logits = self._head(hidden[:, length - 1:length])
        return torch.stack(ks), torch.stack(vs), logits[0, 0]

    @torch.no_grad()
    def slot_decode_paged(self, tokens, pos, active, k_pages, v_pages, rows,
                          seq_cap):
        """One decode iteration over the paged KV cache: tokens [slots]
        int, pos [slots] int32 write positions, active [slots] bool, pools
        [layers, num_pages, page_size, nh, hd] (written in place), rows
        [slots, pages_per_slot] int32 page table, seq_cap the static
        attention extent.  Returns (logits [slots, V], k_pages,
        v_pages)."""
        self._check_eval()
        gpt = self.gpt
        pos = pos.to(torch.int32)
        rows = rows.to(torch.int32).contiguous()
        x = gpt.wte(tokens[:, None]) + gpt.wpe(pos[:, None])
        for i, blk in enumerate(gpt.h):
            x, _, _ = blk.decode_pages(x, k_pages[i], v_pages[i], rows, pos,
                                       active, seq_cap)
        logits = self._head(gpt.ln_f(x))             # [slots, 1, V]
        return logits[:, 0], k_pages, v_pages
