"""GPT decoder-only language model: the serving, training and solo
decoding subset of paddle_tpu/models/gpt.py.

Ported: ``GPTConfig``, ``GPTAttention.forward`` (prefill and training,
through the causal flash-attention kernels, forward and backward) and
``decode_pages`` (through the paged decode kernel), ``GPTMLP`` (bias+GeLU
kernels), ``GPTBlock``, ``GPTModel`` and ``GPTForCausalLM`` with
``forward`` (with labels: through the softmax cross-entropy kernels), the
training ``loss`` (the chunked fused LM-head cross entropy), ``_head``,
``slot_prefill``, ``slot_prefill_prefix`` (a prefix-cache hit or a prefill
chunk: the suffix attends over gathered prefix K/V) and
``slot_decode_paged``, ``verify_pages`` and ``slot_verify_paged`` (the
target's batched verify of speculative decode); the dense-cache decode
layers (``decode_step``, ``decode_slots``, ``GPTModel.prefill``,
``slot_decode``) and ``generate`` (greedy, temperature / top-k sampling,
beam search, ``eos_token_id``).
Parameter names equal the reference's (``gpt.h_0.attn.qkv.weight`` ...),
so weights carry over by name (models/convert.py).  In training,
``attn_dropout`` drops the attention weights inside the flash-attention
kernels and ``dropout`` the hidden states, so ``GPTConfig()`` trains at
its defaults.  Not ported yet (ROADMAP.md): tensor-parallel and
sequence-parallel layouts, recompute.

The decode paths update their caches IN PLACE: where the reference's
jitted step donates the pool (or the dense cache) and returns a
functionally updated copy, the port writes each token's K/V into the
tensor it was given (the engine's pool, a ``generate`` key's caches) and
returns that same tensor.  ``generate``'s prefill runs eagerly; its decode
step (the reference's ``lax.scan`` body) is one CUDA graph per key,
captured once and replayed for every later token (``_DecodeRun``).  Its
sampling draws Gumbel noise from a ``torch.Generator`` seeded with
``seed``: deterministic per seed, not JAX's stream.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass

import torch

from .. import tensor_ops as T
from ..framework.place import resolve_device
from ..framework.random import make_generator
from ..nn import initializer as I
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.norm import LayerNorm
from ..nn.layer_base import Layer, ParamAttr
from ..ops import fused
from ..ops.capture import capture, side_stream
from ..text import beam_search_decode, beam_search_step


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


def _dense_attention(q, k_cache, v_cache, valid):
    """A decode query's attention over a dense cache, the reference's math
    (which runs outside any ``pallas_call``, so plain ops here): scores
    times 1/sqrt(hd), positions where ``valid`` is False set to the
    dtype's finfo.min, a max-subtracted softmax, then the context.
    q [B, 1, nh, hd]; caches [B, S_max, nh, hd]; ``valid`` broadcastable
    to the scores [B, nh, 1, S_max].  Returns [B, 1, nh, hd]."""
    hd = q.shape[-1]
    scores = torch.einsum("bqnd,bsnd->bnqs", q, k_cache) \
        * (1.0 / float(hd) ** 0.5)
    scores = torch.where(valid, scores, torch.finfo(scores.dtype).min)
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("bnqs,bsnd->bqnd", probs, v_cache)


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

    def verify_pages(self, x, k_pages, v_pages, rows, positions, active,
                     seq_cap):
        """Speculative-decode verification attention: like
        :meth:`decode_pages`, but each lane carries a chunk of C candidate
        tokens at consecutive positions, so the target scores every draft
        proposal in one step.

        x: [slots, C, H]; k_pages/v_pages: [num_pages, page_size, nh, hd]
        (this layer's pool plane, written in place); rows: [slots,
        pages_per_slot] int32; positions: [slots, C] int32 absolute write
        index of each candidate (consecutive, clamped by the engine at the
        end of the lane's budget); active: [slots] bool; seq_cap: static
        attention extent.  Each candidate of an active lane writes its K/V
        at its position, in place; an inactive lane writes nothing.  A
        candidate clamped onto the position of the one before it writes
        nothing either (the reference lets either write win: it is garbage
        that no emitted query reads), so every position holds its own
        token's K/V.  Candidate i attends to the keys at positions <=
        positions[b, i]: the committed history and candidates 0..i.  The
        reference computes this with an explicit softmax over a dense
        gather of the lane's pages (no ``pallas_call``); so does the port,
        in float32 whatever the model's dtype.  Returns (out, k_pages,
        v_pages)."""
        cfg = self.cfg
        B, C = x.shape[0], x.shape[1]
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        qkv = self.qkv(x).reshape(B, C, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        first = torch.ones_like(positions[:, :1], dtype=torch.bool)
        fresh = torch.cat([first, positions[:, 1:] != positions[:, :-1]], 1)
        _scatter_token(k_pages, v_pages, k.reshape(B * C, nh, hd),
                       v.reshape(B * C, nh, hd),
                       rows.repeat_interleave(C, dim=0), positions.reshape(-1),
                       (active[:, None] & fresh).reshape(-1))
        num_pages, ps = k_pages.shape[0], k_pages.shape[1]
        gidx = rows.long().clamp(0, num_pages - 1)
        kg = k_pages[gidx].reshape(B, -1, nh, hd)[:, :seq_cap].float()
        vg = v_pages[gidx].reshape(B, -1, nh, hd)[:, :seq_cap].float()
        scores = torch.einsum("bqnd,bsnd->bnqs", q.float(), kg) \
            * (1.0 / float(hd) ** 0.5)
        valid = torch.arange(kg.shape[1], device=x.device)[None, None, :] \
            <= positions[:, :, None]
        scores = torch.where(valid[:, None], scores,
                             torch.finfo(torch.float32).min)
        probs = torch.exp(scores - scores.amax(-1, keepdim=True))
        probs = probs / probs.sum(-1, keepdim=True)
        ctx = torch.einsum("bnqs,bsnd->bqnd", probs, vg)
        out = self.out(ctx.reshape(B, C, cfg.hidden_size).to(x.dtype))
        return out, k_pages, v_pages

    def decode_step(self, x, k_cache, v_cache, pos):
        """One-token cached attention over a dense cache: x [B, 1, H];
        caches [B, S_max, nh, hd], column ``pos`` (a 0-d int32 device
        tensor, so that one captured step serves every position) written
        in place.  Returns (out, k_cache, v_cache)."""
        cfg = self.cfg
        B = x.shape[0]
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        qkv = self.qkv(x).reshape(B, 1, 3, nh, hd)
        col = pos.reshape(1).long()
        k_cache.index_copy_(1, col, qkv[:, :, 1].to(k_cache.dtype))
        v_cache.index_copy_(1, col, qkv[:, :, 2].to(v_cache.dtype))
        valid = torch.arange(k_cache.shape[1], device=x.device) <= pos
        ctx = _dense_attention(qkv[:, :, 0], k_cache, v_cache, valid)
        out = self.out(ctx.reshape(B, 1, cfg.hidden_size))
        return out, k_cache, v_cache

    def decode_slots(self, x, k_cache, v_cache, pos, active):
        """Continuous-batching decode over a dense cache: one token per
        lane, lane b at its own ``pos[b]``.  x [slots, 1, H]; caches
        [slots, S_max, nh, hd]; pos [slots] int32; active [slots] bool.
        Each active lane's K/V is written at (b, pos[b]) in place; an
        inactive lane rewrites that entry (pos clipped into the cache)
        with its own value, so its rows stay as they were and no host
        sync picks the lanes.  Per lane, the math of
        :meth:`decode_step`.  Returns (out, k_cache, v_cache)."""
        cfg = self.cfg
        B = x.shape[0]
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        qkv = self.qkv(x).reshape(B, 1, 3, nh, hd)
        lane = torch.arange(B, device=x.device)
        col = pos.long().clamp(0, k_cache.shape[1] - 1)
        keep = active[:, None, None]
        for cache, new in ((k_cache, qkv[:, 0, 1]), (v_cache, qkv[:, 0, 2])):
            cache[lane, col] = torch.where(keep, new.to(cache.dtype),
                                           cache[lane, col])
        valid = torch.arange(k_cache.shape[1], device=x.device)[None, :] \
            <= pos[:, None]
        ctx = _dense_attention(qkv[:, :, 0], k_cache, v_cache,
                               valid[:, None, None, :])
        out = self.out(ctx.reshape(B, 1, cfg.hidden_size))
        return out, k_cache, v_cache

    def prefill_prefix(self, x, prefix_k, prefix_v, prefix_len, bias=None):
        """Suffix-only prefill attending over a cached prefix: queries
        are the suffix tokens (absolute positions ``prefix_len + i``),
        keys are [prefix ++ suffix] with the prefix entries valid below
        ``prefix_len`` and the suffix causal.

        x: [1, Ss, H] suffix hidden; prefix_k/prefix_v: [C, nh, hd]
        gathered prefix K/V (entries >= prefix_len are garbage the mask
        hides); prefix_len: host int; bias: :func:`prefix_bias` of these
        shapes (made here when None; a model passes one to every layer).
        Returns (out, k_suf, v_suf), k_suf and v_suf [1, Ss, nh, hd].  The
        reference computes this with an explicit softmax (no
        ``pallas_call``); so does the port, in float32 whatever the
        model's dtype, which keeps a bf16 hit close to the flash kernel's
        float32 softmax on a miss."""
        cfg = self.cfg
        S = x.shape[1]
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        qkv = self.qkv(x).reshape(1, S, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if bias is None:
            bias = prefix_bias(S, prefix_k.shape[0], prefix_len, x.device)
        # [nh, tokens, hd] in float32
        qh = q[0].transpose(0, 1).float()
        kh = torch.cat([prefix_k.to(k.dtype), k[0]]).transpose(0, 1).float()
        vh = torch.cat([prefix_v.to(v.dtype), v[0]]).transpose(0, 1).float()
        scores = torch.baddbmm(bias, qh, kh.transpose(1, 2),
                               alpha=1.0 / float(hd) ** 0.5)
        ctx = torch.bmm(torch.softmax(scores, dim=-1), vh)   # [nh, Ss, hd]
        ctx = ctx.transpose(0, 1).reshape(1, S, cfg.hidden_size)
        out = self.dropout(self.out(ctx.to(x.dtype)))
        return out, k, v


def prefix_bias(S: int, C: int, prefix_len: int, device):
    """The additive mask of a suffix prefill, float32 [S, C + S]: 0 where
    suffix query i sees key j (a prefix key below ``prefix_len``, or a
    suffix key at or before i), -inf elsewhere.  Every row sees its own
    key, so no row is masked everywhere."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(C + S, device=device)[None, :]
    ok = (j < int(prefix_len)) | ((j >= C) & (j - C <= i))
    return torch.zeros(ok.shape, device=device).masked_fill_(
        ~ok, float("-inf"))


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

    def decode_step(self, x, k_cache, v_cache, pos):
        a, k_cache, v_cache = self.attn.decode_step(self.ln_1(x), k_cache,
                                                    v_cache, pos)
        x = x + a
        x = x + self.mlp(self.ln_2(x))
        return x, k_cache, v_cache

    def decode_slots(self, x, k_cache, v_cache, pos, active):
        a, k_cache, v_cache = self.attn.decode_slots(
            self.ln_1(x), k_cache, v_cache, pos, active)
        x = x + a
        x = x + self.mlp(self.ln_2(x))
        return x, k_cache, v_cache

    def decode_pages(self, x, k_pages, v_pages, rows, pos, active, seq_cap):
        a, k_pages, v_pages = self.attn.decode_pages(
            self.ln_1(x), k_pages, v_pages, rows, pos, active, seq_cap)
        x = x + a
        x = x + self.mlp(self.ln_2(x))
        return x, k_pages, v_pages

    def verify_pages(self, x, k_pages, v_pages, rows, positions, active,
                     seq_cap):
        a, k_pages, v_pages = self.attn.verify_pages(
            self.ln_1(x), k_pages, v_pages, rows, positions, active, seq_cap)
        x = x + a
        x = x + self.mlp(self.ln_2(x))
        return x, k_pages, v_pages

    def prefill_prefix(self, x, prefix_k, prefix_v, prefix_len, bias=None):
        a, k, v = self.attn.prefill_prefix(self.ln_1(x), prefix_k, prefix_v,
                                           prefix_len, bias)
        x = x + a
        x = x + self.mlp(self.ln_2(x))
        return x, k, v


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

    @torch.no_grad()
    def prefill(self, input_ids, cache_len):
        """Batched prompt pass seeding per-layer dense KV caches of
        length ``cache_len`` (>= prompt + new tokens).  Returns (hidden
        [B, S, H], caches: a tuple of (k, v) [B, cache_len, nh, hd], zero
        past the prompt)."""
        if self.training:
            raise RuntimeError(
                "prefill/decode_step are eval-only serving paths (the "
                "decode half applies no dropout, so a training-mode "
                "prefill would be statistically inconsistent with it); "
                "call model.eval() first")
        cfg = self.cfg
        B = input_ids.shape[0]
        shape = (B, int(cache_len), cfg.num_heads,
                 cfg.hidden_size // cfg.num_heads)
        like = self.wte.weight
        caches = tuple((like.new_empty(shape), like.new_empty(shape))
                       for _ in self.h)
        return self._prefill_into(input_ids, caches), caches

    def _prefill_into(self, input_ids, caches, beams=1):
        """:meth:`prefill`'s pass, writing the prompt's K/V into the given
        caches in place (zero past the prompt); with ``beams`` W, caches
        of B·W rows, prompt b's K/V in rows b·W .. b·W + W - 1.  Returns
        the hidden states [B, S, H]."""
        B, S = input_ids.shape
        pos = torch.arange(S, device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk, (kc, vc) in zip(self.h, caches):
            x, k, v = blk(x, return_kv=True)
            for cache, new in ((kc, k), (vc, v)):
                c = cache.view(B, beams, *cache.shape[1:])
                c[:, :, :S].copy_(new[:, None])
                c[:, :, S:].zero_()
        return self.ln_f(x)

    @torch.no_grad()
    def decode_step(self, token_ids, pos, caches):
        """One decode step: token_ids [B, 1] at absolute position ``pos``
        (a 0-d int32 tensor on the model's device); caches as
        :meth:`prefill` returns them, column ``pos`` written in place.
        Returns (hidden [B, 1, H], caches)."""
        x = self.wte(token_ids) + self.wpe(pos.reshape(1))
        for blk, (kc, vc) in zip(self.h, caches):
            x, _, _ = blk.decode_step(x, kc, vc, pos)
        return self.ln_f(x), caches

    @torch.no_grad()
    def decode_slots(self, token_ids, pos, caches, active):
        """Continuous-batching decode step over dense caches: token_ids
        [slots, 1], lane b at its own position ``pos[b]``; ``active``
        [slots] bool masks lanes that hold no request (their cache rows
        stay as they were).  Returns (hidden [slots, 1, H], caches)."""
        x = self.wte(token_ids) + self.wpe(pos.reshape(-1, 1))
        for blk, (kc, vc) in zip(self.h, caches):
            x, _, _ = blk.decode_slots(x, kc, vc, pos, active)
        return self.ln_f(x), caches


class _DecodeRun:
    """The device state of one ``generate`` key (batch, prompt length,
    new tokens, mode) and its decode step.  Every tensor the step reads or
    writes is allocated here once and only ever written in place, so on a
    CUDA device the step is captured once as a CUDA graph (after a warm-up
    step on a side stream) and replayed for every later decode step of
    every call of the key; the per-call prologue (prefill, first token)
    runs eagerly and re-initialises the state.  ``_step_eager`` issues the
    same step op by op: the CPU's step, and the graph's reference.

    State: the dense caches [R, S + new, nh, hd] a layer (R = B, or B·W
    beams); ``pos`` (0-d int32, the column the next step writes); ``tok``
    [R] int32; ``finished`` ([B] or [B, W] bool); greedy/sampling: ``out``
    [B, new] int32 tokens; beam: ``toks``/``parents`` [new, B, W] int32,
    ``lp`` [B, W, V] log-probabilities, ``scores`` [B, W] float32; sampling:
    ``noise`` [B, V] float32, the step's Gumbel rows, drawn from the call's
    generator into the buffer before each step (outside the graph).

    The run holds its model weakly: the model holds the run (in
    ``_gen_cache``), and a cycle would leave a dropped model's graphs to
    the cyclic garbage collector (ops/capture.py)."""

    def __init__(self, model, B, S, new, do_sample, temperature, top_k,
                 num_beams, eos, beam=None):
        cfg, dev = model.cfg, model.device
        self._model = weakref.ref(model)
        self.B, self.S, self.new = B, S, new
        self.W, self.eos = num_beams, eos
        # beam search (generate routes a width-1 beam to greedy)
        self.beam = num_beams > 1 if beam is None else beam
        R, V = B * num_beams, cfg.vocab_size
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        like = model.gpt.wte.weight
        self.caches = tuple(
            (like.new_zeros(R, S + new, nh, hd),
             like.new_zeros(R, S + new, nh, hd)) for _ in model.gpt.h)
        i32 = dict(dtype=torch.int32, device=dev)
        self.pos = torch.full((), S, **i32)
        self.tok = torch.zeros(R, **i32)
        if self.beam:
            self.finished = torch.zeros(B, num_beams, dtype=torch.bool,
                                        device=dev)
            self.toks = torch.zeros(new, B, num_beams, **i32)
            self.parents = torch.zeros(new, B, num_beams, **i32)
            self.lp = torch.zeros(B, num_beams, V, dtype=like.dtype,
                                  device=dev)
            self.scores = torch.zeros(B, num_beams, dtype=torch.float32,
                                      device=dev)
            self.base = torch.arange(B, device=dev)[:, None] * num_beams
            self.body = type(model)._beam_step
        else:
            self.finished = torch.zeros(B, dtype=torch.bool, device=dev)
            self.out = torch.zeros(B, new, **i32)
            self.body = type(model)._generate_step
        # sample_tokens' per-lane arguments; greedy (no noise) reads none
        self.noise = self.generator = None
        self.sample_args = (None, None, None, 1)
        if do_sample:
            self.noise = torch.zeros(B, V, dtype=torch.float32, device=dev)
            # fill kernels: a host-to-device copy would sync
            self.sample_args = (
                torch.full((B,), True, device=dev),
                torch.full((B,), float(temperature), device=dev),
                torch.full((B,), int(top_k), device=dev),
                min(int(top_k), V) if top_k > 0 else 1)
        self.graph = None
        self.params = _param_ptrs(model)
        self.capture_ms = None
        self.graph_launches: dict[str, int] = {}
        self.graph_variants: dict[str, dict] = {}
        self.replays = 0

    @property
    def model(self):
        return self._model()

    def sample(self, logits):
        """Tokens [B] int32 from logits [B, V] (serving/generation.py
        ``sample_tokens``): the argmax, or the Gumbel-max draw over the
        temperature-scaled, top-k-cut logits with ``noise``."""
        # imported here: serving.generation stays runnable with `python -m`
        # (an import at the top would load it with the package)
        from ..serving.generation import sample_tokens

        do, temp, top_k, k_max = self.sample_args
        return sample_tokens(logits, do, temp, top_k, self.noise,
                             k_max).to(torch.int32)

    def draw(self):
        """The next step's Gumbel rows into ``noise`` (sampling only), from
        the call's generator on the device: no host sync."""
        if self.noise is not None:
            tiny = torch.finfo(torch.float32).tiny
            torch.rand(self.noise.shape, generator=self.generator,
                       device=self.noise.device, out=self.noise)
            self.noise.clamp_min_(tiny).log_().neg_().log_().neg_()

    def step(self):
        """One decode step: a replay of the captured graph on the card,
        else :meth:`_step_eager`."""
        if self.graph is None:
            return self._step_eager()
        self.draw()
        self.graph.replay()
        self.replays += 1

    def _step_eager(self):
        self.draw()
        self.body(self.model, self)

    def capture(self):
        """Capture the decode step into one CUDA graph
        (ops/capture.py).  A warm-up step runs first on a side stream, so
        that the kernel libraries load, cuBLAS's workspace is allocated
        and every lazy choice is made outside the capture; it leaves
        garbage in the state, which every call's prologue re-initialises.
        A capture that fails raises."""
        model = self.model
        t0 = time.perf_counter()
        cap = capture(lambda: self.body(model, self),
                      warm_up=lambda: side_stream(
                          lambda: self.body(model, self), self.pos.device))
        self.graph_launches, self.graph_variants = cap.launches, cap.variants
        self.graph = cap.graph
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def __call__(self, ids, seed):
        """Generate for prompts ``ids`` [B, S] int32 on the model's
        device: the capture at a key's first call on the card (on the
        fresh state), the eager prologue, then ``new - 1`` decode steps.
        Returns [B, S + new] int32."""
        if self.graph is None and self.new > 1 \
                and self.pos.device.type == "cuda":
            self.capture()
        if self.noise is not None:
            self.generator = make_generator(seed, self.pos.device)
        model = self.model
        if self.beam:
            model._beam_prologue(self, ids)
        else:
            model._generate_prologue(self, ids)
        for _ in range(self.new - 1):
            self.step()
        if self.beam:
            return model._beam_result(self, ids)
        return torch.cat([ids, self.out], dim=1)


def _param_ptrs(model):
    return tuple(t.data_ptr() for t in model.parameters())


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
            return T.matmul(hidden, self.gpt.wte.weight, transpose_y=True)
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
    def slot_prefill_prefix(self, input_ids, prefix_k, prefix_v, prefix_len,
                            length):
        """Prefix-cache-hit (or prefill-chunk) prefill: run ONLY the
        prompt's suffix through the model, attending over the cached
        prefix K/V; the shared pages are never recomputed.

        input_ids [1, Ss]: the suffix tokens (absolute positions
        ``prefix_len ..``) right-padded to the suffix bucket;
        prefix_k/prefix_v [layers, C, nh, hd]: prefix K/V gathered from
        the page pool (entries >= prefix_len are garbage the mask hides);
        ``prefix_len`` the shared prefix's length and ``length`` the
        prompt's length so far, host ints.  Returns (k_suf [layers, Ss,
        nh, hd], v_suf, logits [V] at suffix index length - prefix_len -
        1).  Token- (not bitwise-) equivalent to ``slot_prefill`` of the
        whole prompt: the explicit softmax sums in another order than the
        flash kernel."""
        self._check_eval()
        gpt, cfg = self.gpt, self.cfg
        prefix_len, length = int(prefix_len), int(length)
        S = input_ids.shape[1]
        # the padded tail may run past max_position_embeddings: clip it
        # into the table (rows the causal mask and the slice never read)
        pos = (prefix_len + torch.arange(S, device=input_ids.device)).clamp(
            0, cfg.max_position_embeddings - 1)
        x = gpt.drop(gpt.wte(input_ids) + gpt.wpe(pos))
        bias = prefix_bias(S, prefix_k.shape[1], prefix_len, x.device)
        ks, vs = [], []
        for i, blk in enumerate(gpt.h):
            x, k, v = blk.prefill_prefix(x, prefix_k[i], prefix_v[i],
                                         prefix_len, bias)
            ks.append(k[0])
            vs.append(v[0])
        last = length - prefix_len - 1
        hidden = gpt.ln_f(x[:, last:last + 1])        # [1, 1, H]
        logits = self._head(hidden)
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

    @torch.no_grad()
    def slot_verify_paged(self, tokens, positions, active, k_pages, v_pages,
                          rows, seq_cap):
        """Speculative-decode verification over the paged KV cache: score a
        chunk of C candidates a lane in ONE model step.  tokens [slots, C]
        int (the committed token, then the draft's proposals), positions
        [slots, C] int32 absolute write indices (consecutive a lane),
        active [slots] bool, pools [layers, num_pages, page_size, nh, hd]
        (written in place), rows [slots, pages_per_slot] int32, seq_cap
        the static attention extent.  Returns (logits [slots, C, V],
        k_pages, v_pages): the engine compares argmax(logits[:, i]) with
        proposal i + 1 to accept or cut the run.  LayerNorm and the MLP
        run their kernels at R = slots x C rows."""
        self._check_eval()
        gpt = self.gpt
        positions = positions.to(torch.int32)
        rows = rows.to(torch.int32).contiguous()
        # clamped tail positions may sit at the extent's edge: clip into
        # the table (rows no emitted token is computed from)
        x = gpt.wte(tokens) + gpt.wpe(
            positions.clamp(0, self.cfg.max_position_embeddings - 1))
        for i, blk in enumerate(gpt.h):
            x, _, _ = blk.verify_pages(x, k_pages[i], v_pages[i], rows,
                                       positions, active, seq_cap)
        return self._head(gpt.ln_f(x)), k_pages, v_pages

    @torch.no_grad()
    def slot_decode(self, tokens, pos, active, k_cache, v_cache):
        """One decode iteration over the slot-batched dense KV cache:
        tokens [slots] int, pos [slots] int32 write positions, active
        [slots] bool, caches [layers, slots, S_max, nh, hd] (written in
        place).  Returns (logits [slots, V], k_cache, v_cache)."""
        self._check_eval()
        caches = tuple((k_cache[i], v_cache[i])
                       for i in range(self.cfg.num_layers))
        hidden, _ = self.gpt.decode_slots(tokens[:, None], pos.to(torch.int32),
                                          caches, active)
        return self._head(hidden)[:, 0], k_cache, v_cache

    # -- generate: the eager prologue and the decode step of a _DecodeRun --
    def _generate_prologue(self, run, ids):
        """Greedy / sampling: the batched prefill into the run's caches and
        the first new token from its last position's logits."""
        hidden = self.gpt._prefill_into(ids, run.caches)
        run.finished.zero_()
        run.pos.fill_(run.S)
        run.draw()
        self._generate_emit(run, self._head(hidden[:, -1:])[:, -1])

    def _generate_step(self, run):
        """One decode step (the reference's ``_generate_traced`` scan
        body): the pending token at ``pos``, then the next one."""
        hidden, _ = self.gpt.decode_step(run.tok[:, None], run.pos,
                                         run.caches)
        run.pos += 1
        self._generate_emit(run, self._head(hidden)[:, -1])

    def _generate_emit(self, run, logits):
        """Sample from logits [B, V]; a finished row emits eos; the token
        goes to column ``pos - S`` of the output."""
        nxt = torch.where(run.finished, run.eos, run.sample(logits))
        run.finished |= nxt == run.eos
        run.out.index_copy_(1, (run.pos - run.S).long().reshape(1),
                            nxt[:, None])
        run.tok.copy_(nxt)

    def _beam_prologue(self, run, ids):
        """Beam search: one prefill per prompt, its K/V repeated into the
        W beams' rows (beams diverge only after the first expansion), the
        first expansion from its last position's log-probabilities."""
        B, W = run.B, run.W
        hidden = self.gpt._prefill_into(ids, run.caches, beams=W)
        lg0 = self._head(hidden[:, -1:])[:, -1]                  # [B, V]
        run.lp.copy_(torch.log_softmax(lg0, -1)[:, None, :].expand_as(
            run.lp))
        run.scores.fill_(torch.finfo(torch.float32).min)
        run.scores[:, 0] = 0.0
        run.finished.zero_()
        run.pos.fill_(run.S)
        self._beam_select(run)

    def _beam_step(self, run):
        """One decode step of the beams (the reference's ``_beam_traced``
        scan body): the beams' pending tokens at ``pos``, then the next
        expansion."""
        hidden, _ = self.gpt.decode_step(run.tok[:, None], run.pos,
                                         run.caches)
        run.pos += 1
        lg = self._head(hidden)[:, -1]                            # [B*W, V]
        run.lp.copy_(torch.log_softmax(lg, -1).reshape(run.lp.shape))
        self._beam_select(run)

    def _beam_select(self, run):
        """Expand the W beams over the vocabulary (text.beam_search_step;
        finished beams keep their score and propose only eos), record the
        step's ids and parents at ``pos - S``, and reorder the caches and
        the finished mask along the surviving parents, in place."""
        tok, parents, scores = beam_search_step(
            run.lp, run.scores, run.W, end_token=run.eos,
            finished=run.finished)
        run.finished.copy_(run.finished.gather(1, parents)
                           | (tok == run.eos))
        run.scores.copy_(scores)
        t = (run.pos - run.S).long().reshape(1)
        run.toks.index_copy_(0, t, tok[None].to(torch.int32))
        run.parents.index_copy_(0, t, parents[None].to(torch.int32))
        sel = (run.base + parents).reshape(-1)
        for kc, vc in run.caches:
            kc.copy_(kc.index_select(0, sel))
            vc.copy_(vc.index_select(0, sel))
        run.tok.copy_(tok.reshape(-1))

    def _beam_result(self, run, ids):
        """Backtrack the surviving paths (text.beam_search_decode) and
        append each prompt's best beam: [B, S + new] int32."""
        seqs, scores = beam_search_decode(run.toks, run.parents, run.scores)
        best = scores.argmax(1)
        seq = seqs[torch.arange(run.B, device=best.device), best]
        return torch.cat([ids, seq.to(torch.int32)], dim=1)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=0, do_sample=False, seed=0, num_beams=1,
                 eos_token_id=None):
        """Autoregressive generation over a dense KV cache.

        Greedy by default; ``do_sample=True`` samples (temperature, top-k,
        Gumbel-max from a ``torch.Generator`` on the model's device seeded
        with ``seed``: deterministic per seed, not JAX's stream);
        ``num_beams > 1`` runs beam search (no length penalty; finished
        beams propose only ``eos_token_id``).  A row that emits
        ``eos_token_id`` emits only eos afterwards.  The prefill runs
        eagerly; the decode step is one CUDA graph per (batch, prompt
        length, max_new_tokens, mode) key, captured at the key's first
        call on the card, kept in ``self._gen_cache`` and replayed
        ``max_new_tokens - 1`` times a call; a later call of a key makes
        no host sync.  Returns [B, prompt_len + max_new_tokens] int32 on
        the model's device, prompt included."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if num_beams > 1 and do_sample:
            raise ValueError("beam search and sampling are exclusive "
                             "(num_beams > 1 with do_sample=True)")
        ids = torch.as_tensor(input_ids).to(device=self.device,
                                            dtype=torch.int32)
        B, S = ids.shape
        new = int(max_new_tokens)
        if S + new > self.cfg.max_position_embeddings:
            raise ValueError(
                f"prompt {S} + max_new_tokens {max_new_tokens} exceeds "
                f"max_position_embeddings "
                f"{self.cfg.max_position_embeddings}")
        was_training = self.training
        self.eval()
        try:
            eos = None if eos_token_id is None else int(eos_token_id)
            # sampling knobs only shape the step when do_sample is on
            key = (B, S, new, bool(do_sample), int(num_beams), eos,
                   (float(temperature), int(top_k)) if do_sample else None)
            cache = self.__dict__.setdefault("_gen_cache", {})
            run = cache.get(key)
            if run is None or run.params != _param_ptrs(self):
                # a new key, or parameters moved since its capture
                run = cache[key] = _DecodeRun(
                    self, B, S, new, bool(do_sample), temperature, top_k,
                    int(num_beams),
                    self.cfg.vocab_size if eos is None else eos)
            return run(ids, seed)
        finally:
            if was_training:
                self.train()
