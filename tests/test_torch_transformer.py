"""The port's encoder-decoder Transformer slice against the JAX package's,
on the CPU: the cross form (S_q != S_k) of the three flash-attention
kernels, ``MultiHeadAttention``'s caches, the encoder's cache path,
``TransformerDecoderLayer``, ``TransformerDecoder``, ``Transformer``,
greedy incremental decoding and ``Model.fit`` of a small seq2seq model.

Sizes: d_model 64, 4 heads (head dim 16), 2 + 2 layers, FFN 128, source
12 tokens, target 9, vocabulary 50, batch 3.  Inputs and weights come
from numpy seeds; weights are carried over by name (``load_numpy_state``).
The reference runs on the CPU: its attention is the Pallas kernel in
interpret mode where a test calls it directly, else its XLA composite.
Tolerances (float32 on both sides; only the order of sums differs):
- kernels and their plain versions against the Pallas kernel (out, lse,
  dq, dk, dv) and cross-attention dropout against the composite:
  atol = rtol = 1e-5;
- layers (``MultiHeadAttention``, ``TransformerDecoderLayer``, the
  encoder's cache path): output and every gradient at atol = rtol = 1e-5;
- whole stacks (``TransformerDecoder``, ``Transformer``, the seq2seq
  model, the ``Model.fit`` loss trajectory): atol = rtol = 1e-4;
- masks, greedy tokens and weights carried over: exact.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer_base import functional_call, state_pytrees
from paddle_tpu.ops import fused as jfused
from paddle_tpu.ops.pallas import flash_attention as pallas_fa
from paddle_tpu.tensor import Tensor, unwrap
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import random as port_random
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels import flash_attention as fa

KERNEL_TOL = dict(atol=1e-5, rtol=1e-5)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
D_MODEL, NHEAD, LAYERS, FFN = 64, 4, 2, 128
B, S_SRC, S_TGT, VOCAB = 3, 12, 9, 50
PAD, BOS, IGNORE = 0, 1, -100


@pytest.fixture(autouse=True)
def _drop_reference_tape():
    """The reference's eager calls record onto its process-wide autograd
    tape, which holds every intermediate array until a backward: clear it
    after each test, so no array outlives the test that made it."""
    yield
    paddle.autograd.clear_tape()


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return Tensor(jnp.asarray(a))


def _params(jlayer):
    return _np(state_pytrees(jlayer)[0])


def _carry(jlayer, tlayer):
    """Load the reference layer's weights into the port's by name; the
    numpy state, for the reference's functional calls."""
    state = _params(jlayer)
    load_numpy_state(tlayer, state)
    return state


# -- the kernels' cross form --------------------------------------------------
def _cross_mask(kind, S_q, S_k, H=3, seed=0):
    """None, a bool key-padding [B, 1, 1, S_k] mask (key 0 always
    visible, so no row is masked everywhere), or a full additive
    [B, H, S_q, S_k] one."""
    rs = np.random.RandomState(seed)
    if kind == "bool":
        m = rs.rand(2, 1, 1, S_k) > 0.3
        m[..., 0] = True
        return m
    if kind == "additive":
        return rs.randn(2, H, S_q, S_k).astype(np.float32)
    return None


@pytest.mark.parametrize("S_q,S_k", [(16, 24), (24, 16)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", [None, "bool", "additive"])
def test_cross_forms_match_pallas(S_q, S_k, causal, kind):
    """The port's attention (forward and the dq / dk-dv plain backward
    through the autograd Function), its plain forward's lse and its plain
    backward, at S_q != S_k, against the Pallas kernel in interpret mode
    with 8-wide tiles (``_fwd_call`` for the lse, ``jax.vjp`` of the
    public entry for the gradients); causal is top-left aligned."""
    Bq, H, D = 2, 3, 16
    rs = np.random.RandomState(S_q + 2 * causal)
    q, do = (rs.randn(Bq, S_q, H, D).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(Bq, S_k, H, D).astype(np.float32) for _ in range(2))
    m = _cross_mask(kind, S_q, S_k)
    jm = None if m is None else jnp.asarray(m)
    ref_out, vjp = jax.vjp(
        lambda q_, k_, v_: pallas_fa.flash_attention(
            q_, k_, v_, causal=causal, mask=jm, block_q=8, block_k=8,
            interpret=True), *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    def fold(x, s):
        return jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(Bq * H, s, D)

    jbias = None if m is None else pallas_fa._fold_mask(jm, Bq, H, S_q, S_k)
    _, ref_lse = pallas_fa._fwd_call(
        fold(q, S_q), fold(k, S_k), fold(v, S_k), jbias, causal,
        1.0 / math.sqrt(D), 8, 8, True)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tm = None if m is None else _t(m)
    out = fa.attention(tq, tk, tv, causal=causal, mask=tm)
    out.backward(_t(do))
    assert out.shape == (Bq, S_q, H, D)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **KERNEL_TOL)
    for t, r in zip((tq, tk, tv), ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), r, **KERNEL_TOL)
    bias = None if tm is None else fa.fold_mask(tm, Bq, H, S_q, S_k)
    plain_q, plain_k, plain_v = (t.detach() for t in (tq, tk, tv))
    o, lse = fa.flash_attention_plain(plain_q, plain_k, plain_v, causal, bias)
    assert lse.shape == (Bq * H, S_q)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **KERNEL_TOL)
    grads = fa.flash_attention_bwd_plain(plain_q, plain_k, plain_v, o, lse,
                                         _t(do), causal, bias)
    assert [tuple(g.shape) for g in grads] == [q.shape, k.shape, v.shape]
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), r, **KERNEL_TOL)


def test_cross_causal_keys_past_the_last_query_get_zero_gradients():
    """Causal with S_q < S_k: keys past the last query are seen by none,
    so their dk and dv are exactly 0 (the kernels write zeros there)."""
    rs = np.random.RandomState(5)
    q, do = (_t(rs.randn(2, 5, 2, 16).astype(np.float32)) for _ in range(2))
    k, v = (_t(rs.randn(2, 11, 2, 16).astype(np.float32)) for _ in range(2))
    o, lse = fa.flash_attention_plain(q, k, v, causal=True)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                              causal=True)
    assert torch.all(dk[:, 5:] == 0) and torch.all(dv[:, 5:] == 0)
    assert torch.all(dk[:, :5].abs().sum(-1) > 0)


def test_cross_backward_wrapper_writes_into_out():
    """``flash_attention_bwd`` at S_q != S_k writes dq, dk and dv into the
    views it is given (what the attention Functions pass), equal to the
    plain backward; with no ``out`` only S_q == S_k has a default."""
    rs = np.random.RandomState(6)
    q, do = (_t(rs.randn(2, 7, 2, 16).astype(np.float32)) for _ in range(2))
    k, v = (_t(rs.randn(2, 10, 2, 16).astype(np.float32)) for _ in range(2))
    o, lse = fa.flash_attention_plain(q, k, v, causal=False)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False)
    out = tuple(torch.empty_like(t) for t in (q, k, v))
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, out=out, causal=False)
    for g, o_, w in zip(got, out, want):
        assert g.data_ptr() == o_.data_ptr()
        np.testing.assert_allclose(g.numpy(), w.numpy(), **KERNEL_TOL)
    with pytest.raises(ValueError, match="needs out="):
        fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)


class _FakeBernoulli:
    """Stands in for jax.random.bernoulli: hands out the given masks in
    order, checking the probability and shape asked for."""

    def __init__(self, masks, p):
        self.masks, self.p = list(masks), p

    def __call__(self, key, prob, shape):
        mask = self.masks.pop(0)
        assert abs(float(prob) - (1 - self.p)) < 1e-12
        assert tuple(shape) == tuple(mask.shape)
        return jnp.asarray(mask.numpy())


@pytest.mark.parametrize("S_q,S_k", [(9, 12), (12, 5)])
@pytest.mark.parametrize("causal", [False, True])
def test_cross_dropout_matches_reference(monkeypatch, S_q, S_k, causal):
    """Cross-attention with dropout (the port's plain forward and
    backward, mask [B, H, S_q, S_k] from ``dropout_keep_plain``) against
    the reference's composite and its vjp, handed the port's mask, with a
    bool padding mask over the keys."""
    Bq, H, D, p, seed = 2, 3, 16, 0.3, 91
    rs = np.random.RandomState(S_q + causal)
    q, do = (rs.randn(Bq, S_q, H, D).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(Bq, S_k, H, D).astype(np.float32) for _ in range(2))
    mask = _cross_mask("bool", S_q, S_k)
    keep = fa.dropout_keep_plain(seed, Bq, H, S_q, p, S_k=S_k)
    assert keep.shape == (Bq, H, S_q, S_k)
    monkeypatch.setattr(jax.random, "bernoulli", _FakeBernoulli([keep], p))
    ref_out, vjp = jax.vjp(
        lambda q_, k_, v_: unwrap(jfused.scaled_dot_product_attention(
            Tensor(q_), Tensor(k_), Tensor(v_), attn_mask=_j(mask),
            dropout_p=p, is_causal=causal, training=True)),
        *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    monkeypatch.setattr(port_random, "dropout_seed", lambda: seed)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    out = fa.attention(*ts, causal=causal, dropout_p=p, mask=_t(mask))
    out.backward(_t(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **KERNEL_TOL)
    for t, r in zip(ts, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   **KERNEL_TOL)


def test_dropout_keep_plain_key_length_keyword():
    """``S_k=S`` is bitwise the mask without the keyword (the callers that
    pass p fifth keep their meaning), and the [B, H, S_q, S_k] mask is
    the top-left corner of the square mask of the larger length: no draw
    depends on either length.  A ``StepSeed`` takes its counter."""
    seed, Bq, H, p = 0xC0FFEE, 2, 3, 0.2
    square = fa.dropout_keep_plain(seed, Bq, H, 21, p)
    assert torch.equal(fa.dropout_keep_plain(seed, Bq, H, 21, p, S_k=21),
                       square)
    assert torch.equal(fa.dropout_keep_plain(seed, Bq, H, 21, p, "cpu",
                                             S_k=21), square)
    for S_q, S_k in ((9, 21), (21, 9), (1, 13)):
        got = fa.dropout_keep_plain(seed, Bq, H, S_q, p, S_k=S_k)
        assert torch.equal(got, square[:, :, :S_q, :S_k])
        assert torch.equal(fa.dropout_keep(seed, Bq, H, S_q, p, "cpu",
                                           S_k=S_k), got)
    step = port_random.StepSeed(seed, torch.tensor([3], dtype=torch.int32))
    assert not torch.equal(fa.dropout_keep_plain(step, Bq, H, 9, p, S_k=13),
                           square[:, :, :9, :13])


# -- the layers ----------------------------------------------------------------
def _mha_pair(seed=3):
    paddle.seed(seed)
    jl = jnn.MultiHeadAttention(D_MODEL, NHEAD)
    tl = tnn.MultiHeadAttention(D_MODEL, NHEAD)
    _carry(jl, tl)
    return jl, tl


def _assert_cache(got, ref, kind):
    assert type(got).__name__ == kind and type(ref).__name__ == kind
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r.numpy()),
                                   **LAYER_TOL)


def test_multi_head_attention_caches_match_reference():
    """``gen_cache``: an empty incremental Cache ([B, 0, H, hd], the
    weight's dtype), then three one-token steps that each append their
    keys and values (S_q = 1 against S_k = 1, 2, 3); a StaticCache of the
    memory projected once, used with a padding mask (S_q = 1 and 4
    against S_k = 12).  Outputs and returned caches against the
    reference's."""
    jl, tl = _mha_pair()
    rs = np.random.RandomState(4)
    mem = rs.randn(B, S_SRC, D_MODEL).astype(np.float32)
    steps = rs.randn(3, B, 1, D_MODEL).astype(np.float32)
    jc, tc = jl.gen_cache(_j(mem)), tl.gen_cache(_t(mem))
    assert tc.k.shape == (B, 0, NHEAD, D_MODEL // NHEAD)
    assert tc.k.dtype == tl.k_proj.weight.dtype
    _assert_cache(tc, jc, "Cache")
    with torch.no_grad():
        for x in steps:
            jo, jc = jl(_j(x), _j(x), _j(x), None, jc)
            to, tc = tl(_t(x), _t(x), _t(x), None, tc)
            np.testing.assert_allclose(to.numpy(), np.asarray(jo.numpy()),
                                       **LAYER_TOL)
            _assert_cache(tc, jc, "Cache")
        assert tc.k.shape[1] == 3
        js = jl.gen_cache(_j(mem), _j(mem), jnn.MultiHeadAttention.StaticCache)
        ts = tl.gen_cache(_t(mem), _t(mem), tnn.MultiHeadAttention.StaticCache)
        _assert_cache(ts, js, "StaticCache")
        mask = np.arange(S_SRC)[None, :] < np.array([12, 7, 3])[:, None]
        mask = mask[:, None, None, :]
        for q in (steps[0], rs.randn(B, 4, D_MODEL).astype(np.float32)):
            jo, jr = jl(_j(q), _j(mem), _j(mem), _j(mask), js)
            to, tr = tl(_t(q), _t(mem), _t(mem), _t(mask), ts)
            np.testing.assert_allclose(to.numpy(), np.asarray(jo.numpy()),
                                       **LAYER_TOL)
            assert tr is ts
            # the same as attending over the memory without a cache
            np.testing.assert_allclose(
                tl(_t(q), _t(mem), _t(mem), _t(mask)).numpy(), to.numpy(),
                rtol=0, atol=1e-6)
        kv = tl.gen_cache(ts.k, ts.v)
        assert type(kv).__name__ == "Cache" and kv.k is ts.k


def _layer_grads(jlayer, tlayer, state, args, dy, n_in):
    """The port layer's output and gradients (the first ``n_in`` inputs'
    and every parameter's) against the reference's, from ``jax.vjp`` of a
    functional call.  ``args``: numpy arrays (None passes through)."""
    def jfn(params, *xs):
        call = list(xs) + [None if a is None else _j(a)
                           for a in args[n_in:]]
        out, _ = functional_call(jlayer, params,
                                 tuple(Tensor(x) if not isinstance(x, Tensor)
                                       and x is not None else x
                                       for x in call))
        return unwrap(out)

    jparams = {k: jnp.asarray(v) for k, v in state.items()}
    ref, vjp = jax.vjp(jfn, jparams, *(jnp.asarray(a) for a in args[:n_in]))
    ref_pgrads, *ref_xgrads = vjp(jnp.asarray(dy))
    xs = [_t(a).requires_grad_() for a in args[:n_in]]
    out = tlayer(*xs, *(None if a is None else _t(a) for a in args[n_in:]))
    out.backward(_t(dy))
    return out, ref, xs, ref_xgrads, ref_pgrads


def _assert_layer_grads(tlayer, out, ref, xs, ref_xgrads, ref_pgrads, tol):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    for x, r in zip(xs, ref_xgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), **tol)
    grads = {n: p.grad for n, p in tlayer.named_parameters()}
    assert set(grads) == set(ref_pgrads)
    for name, r in ref_pgrads.items():
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(r),
                                   err_msg=name, **tol)


def _inputs(seed=6):
    rs = np.random.RandomState(seed)
    tgt = rs.randn(B, S_TGT, D_MODEL).astype(np.float32)
    mem = rs.randn(B, S_SRC, D_MODEL).astype(np.float32)
    dy = rs.randn(B, S_TGT, D_MODEL).astype(np.float32)
    lens = np.array([S_SRC, 8, 5])
    src_mask = (np.arange(S_SRC)[None, :] < lens[:, None])[:, None, None, :]
    tgt_mask = np.asarray(
        jnn.Transformer.generate_square_subsequent_mask(S_TGT).numpy())
    return tgt, mem, dy, src_mask, tgt_mask


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_decoder_layer_matches_reference(normalize_before, activation):
    """``TransformerDecoderLayer`` post- and pre-LN, ReLU and GeLU, with
    the subsequent mask on the self-attention and a padding mask on the
    cross-attention (S_q = 9 against S_k = 12), eval mode, dropout 0:
    output, the target's and the memory's gradients and every
    parameter's."""
    paddle.seed(7)
    jl = jnn.TransformerDecoderLayer(D_MODEL, NHEAD, FFN, dropout=0.0,
                                     activation=activation,
                                     normalize_before=normalize_before)
    jl.eval()
    tl = tnn.TransformerDecoderLayer(D_MODEL, NHEAD, FFN, dropout=0.0,
                                     activation=activation,
                                     normalize_before=normalize_before)
    tl.eval()
    assert tl._config == jl._config
    state = _carry(jl, tl)
    tgt, mem, dy, src_mask, tgt_mask = _inputs()
    res = _layer_grads(jl, tl, state, (tgt, mem, tgt_mask, src_mask), dy, 2)
    _assert_layer_grads(tl, *res, LAYER_TOL)


def test_decoder_layer_cache_path_matches_reference():
    """The decoder layer's cache path: ``gen_cache(memory)`` gives the
    empty incremental Cache and the memory's StaticCache; nine one-token
    steps return ``(out, (incremental, static))`` equal to the reference's,
    and each step's output equals the last row of the whole prefix
    recomputed under the subsequent mask."""
    paddle.seed(8)
    jl = jnn.TransformerDecoderLayer(D_MODEL, NHEAD, FFN, dropout=0.0)
    tl = tnn.TransformerDecoderLayer(D_MODEL, NHEAD, FFN, dropout=0.0)
    jl.eval()
    tl.eval()
    _carry(jl, tl)
    tgt, mem, _, src_mask, tgt_mask = _inputs(9)
    jc, tc = jl.gen_cache(_j(mem)), tl.gen_cache(_t(mem))
    with torch.no_grad():
        whole = tl(_t(tgt), _t(mem), _t(tgt_mask), _t(src_mask))
        for t in range(S_TGT):
            x = tgt[:, t:t + 1]
            jo, jc = jl(_j(x), _j(mem), None, _j(src_mask), jc)
            to, tc = tl(_t(x), _t(mem), None, _t(src_mask), tc)
            np.testing.assert_allclose(to.numpy(), np.asarray(jo.numpy()),
                                       **LAYER_TOL)
            np.testing.assert_allclose(to[:, 0].numpy(),
                                       whole[:, t].numpy(), **LAYER_TOL)
            _assert_cache(tc[0], jc[0], "Cache")
            _assert_cache(tc[1], jc[1], "StaticCache")
    assert tc[0].k.shape[1] == S_TGT


def test_encoder_cache_path_matches_reference():
    """``TransformerEncoderLayer(src, src_mask, cache)`` and
    ``TransformerEncoder(src, src_mask, cache)`` with ``gen_cache(src)``
    (each layer's empty incremental Cache): the output and the returned
    caches (the layer's keys and values appended) equal the reference's,
    and the output equals the stack's without a cache."""
    paddle.seed(10)
    jenc = jnn.TransformerEncoder(
        jnn.TransformerEncoderLayer(D_MODEL, NHEAD, FFN, dropout=0.0), 2)
    tenc = tnn.TransformerEncoder(
        tnn.TransformerEncoderLayer(D_MODEL, NHEAD, FFN, dropout=0.0), 2)
    jenc.eval()
    tenc.eval()
    _carry(jenc, tenc)
    _, mem, _, src_mask, _ = _inputs(11)
    jc, tc = jenc.gen_cache(_j(mem)), tenc.gen_cache(_t(mem))
    assert len(tc) == 2 and all(c.k.shape[1] == 0 for c in tc)
    with torch.no_grad():
        jo, jc = jenc(_j(mem), _j(src_mask), jc)
        to, tc = tenc(_t(mem), _t(src_mask), tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo.numpy()),
                                   **LAYER_TOL)
        for g, r in zip(tc, jc):
            _assert_cache(g, r, "Cache")
        np.testing.assert_allclose(tenc(_t(mem), _t(src_mask)).numpy(),
                                   to.numpy(), rtol=0, atol=1e-6)
        jo1, jc1 = jenc.layers[0](_j(mem), _j(src_mask),
                                  jenc.layers[0].gen_cache(_j(mem)))
        to1, tc1 = tenc.layers[0](_t(mem), _t(src_mask),
                                  tenc.layers[0].gen_cache(_t(mem)))
        np.testing.assert_allclose(to1.numpy(), np.asarray(jo1.numpy()),
                                   **LAYER_TOL)
        _assert_cache(tc1, jc1, "Cache")


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_stack_matches_reference(normalize_before):
    """``TransformerDecoder`` of two layers (with its final LayerNorm when
    pre-LN): output, input gradients and every parameter's; its
    ``gen_cache(memory, do_zip=True)`` as two lists."""
    paddle.seed(12)
    norm = (lambda m: m.LayerNorm(D_MODEL)) if normalize_before \
        else (lambda m: None)
    jd = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(
        D_MODEL, NHEAD, FFN, dropout=0.0,
        normalize_before=normalize_before), LAYERS, norm(jnn))
    td = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
        D_MODEL, NHEAD, FFN, dropout=0.0,
        normalize_before=normalize_before), LAYERS, norm(tnn))
    jd.eval()
    td.eval()
    state = _carry(jd, td)
    assert ("norm.weight" in state) == normalize_before
    tgt, mem, dy, src_mask, tgt_mask = _inputs(13)
    res = _layer_grads(jd, td, state, (tgt, mem, tgt_mask, src_mask), dy, 2)
    _assert_layer_grads(td, *res, MODEL_TOL)
    inc, static = td.gen_cache(_t(mem), do_zip=True)
    assert len(inc) == len(static) == LAYERS
    assert [type(c).__name__ for c in inc + static] == \
        ["Cache"] * LAYERS + ["StaticCache"] * LAYERS


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_matches_reference(normalize_before):
    """``Transformer`` (2 + 2 layers, post- and pre-LN) with the source's
    padding mask on the encoder and the cross-attention and the
    subsequent mask on the decoder: output, the source's and the target's
    gradients and every parameter's."""
    paddle.seed(14)
    kw = dict(d_model=D_MODEL, nhead=NHEAD, num_encoder_layers=LAYERS,
              num_decoder_layers=LAYERS, dim_feedforward=FFN, dropout=0.0,
              normalize_before=normalize_before)
    jt, tt = jnn.Transformer(**kw), tnn.Transformer(**kw)
    jt.eval()
    tt.eval()
    state = _carry(jt, tt)
    tgt, mem, dy, src_mask, tgt_mask = _inputs(15)
    res = _layer_grads(jt, tt, state,
                       (mem, tgt, src_mask, tgt_mask, src_mask), dy, 2)
    _assert_layer_grads(tt, *res, MODEL_TOL)


def test_generate_square_subsequent_mask_matches_reference():
    """float32 [L, L], 0 on and below the diagonal, -1e9 above: equal to
    the reference's; on the device asked for."""
    for length in (1, 5, S_TGT):
        got = tnn.Transformer.generate_square_subsequent_mask(length, "cpu")
        ref = np.asarray(
            jnn.Transformer.generate_square_subsequent_mask(length).numpy())
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), ref)


def test_transformer_structure_and_custom_stacks():
    """A stack re-instantiates each layer from its constructor arguments
    (fresh weights); ``custom_encoder`` / ``custom_decoder`` take the
    place of the built ones, and their weights the same names."""
    tt = tnn.Transformer(D_MODEL, NHEAD, 3, 2, FFN)
    assert len(tt.encoder.layers) == 3 and len(tt.decoder.layers) == 2
    assert tt.encoder.norm is None and tt.decoder.norm is None
    w = [layer.cross_attn.q_proj.weight for layer in tt.decoder.layers]
    assert not torch.equal(w[0], w[1])
    enc = tnn.TransformerEncoder(
        tnn.TransformerEncoderLayer(D_MODEL, NHEAD, FFN), 1)
    dec = tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(D_MODEL, NHEAD, FFN), 1)
    custom = tnn.Transformer(D_MODEL, NHEAD, custom_encoder=enc,
                             custom_decoder=dec)
    assert custom.encoder is enc and custom.decoder is dec
    assert "decoder.layers.0.cross_attn.k_proj.weight" in custom.state_dict()


@pytest.mark.parametrize("normalize_before", [False, True])
def test_load_numpy_state_takes_the_reference_state(normalize_before):
    """``load_numpy_state`` of the reference's ``Transformer.state_dict()``
    (with the final norms when pre-LN) leaves nothing missing and nothing
    unexpected, and every value arrives exactly."""
    paddle.seed(16)
    kw = dict(d_model=D_MODEL, nhead=NHEAD, num_encoder_layers=LAYERS,
              num_decoder_layers=LAYERS, dim_feedforward=FFN,
              normalize_before=normalize_before)
    jt = jnn.Transformer(**kw)
    state = {k: np.asarray(v.numpy()) for k, v in jt.state_dict().items()}
    tt = tnn.Transformer(**kw)
    assert set(tt.state_dict()) == set(state)
    load_numpy_state(tt, state)
    for name, value in tt.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[name],
                                      err_msg=name)
    with pytest.raises(KeyError):
        load_numpy_state(tnn.Transformer(**dict(kw, num_decoder_layers=1)),
                         state)


# -- a seq2seq model (user code: neither package has a seq2seq class) --------
def _positions(n, d):
    """Sinusoidal positions (Vaswani et al., 2017, section 3.5), float32."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    rate = np.power(10000.0, -np.arange(0, d, 2, dtype=np.float64) / d)
    pe = np.zeros((n, d))
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * rate), np.cos(pos * rate)
    return pe.astype(np.float32)


POS = _positions(64, D_MODEL)
MODEL_KW = dict(d_model=D_MODEL, nhead=NHEAD, num_encoder_layers=LAYERS,
                num_decoder_layers=LAYERS, dim_feedforward=FFN, dropout=0.0)


class JSeq2Seq(jnn.Layer):
    """The reference's side: one embedding shared by source, target and
    the pre-softmax projection, scaled by sqrt(d_model), plus sinusoidal
    positions."""

    def __init__(self):
        super().__init__()
        self.embedding = jnn.Embedding(
            VOCAB, D_MODEL, weight_attr=jnn.initializer.Normal(
                0.0, D_MODEL ** -0.5))
        self.transformer = jnn.Transformer(**MODEL_KW)

    def embed(self, ids, start=0):
        n = ids.shape[1]
        return self.embedding(ids) * math.sqrt(D_MODEL) \
            + _j(POS[start:start + n])

    def logits(self, h):
        return paddle.matmul(h, self.embedding.weight, transpose_y=True)

    def forward(self, src, tgt):
        mask = paddle.unsqueeze(src != PAD, [1, 2])
        h = self.transformer(
            self.embed(src), self.embed(tgt), mask,
            jnn.Transformer.generate_square_subsequent_mask(tgt.shape[1]),
            mask)
        return self.logits(h)


class TSeq2Seq(tnn.Layer):
    """The port's side of the same model; the positions and the
    subsequent mask are buffers made once (not state)."""

    def __init__(self, device="cpu"):
        super().__init__()
        self.embedding = tnn.Embedding(
            VOCAB, D_MODEL, weight_attr=tnn.initializer.Normal(
                0.0, D_MODEL ** -0.5))
        self.transformer = tnn.Transformer(**MODEL_KW)
        self.register_buffer("pos", _t(POS), persistent=False)
        self.register_buffer(
            "tgt_mask", tnn.Transformer.generate_square_subsequent_mask(
                S_TGT, device), persistent=False)
        self.to(device)

    def embed(self, ids, start=0):
        n = ids.shape[1]
        return self.embedding(ids) * math.sqrt(D_MODEL) \
            + self.pos[start:start + n]

    def logits(self, h):
        return torch.matmul(h, self.embedding.weight.t())

    def forward(self, src, tgt):
        mask = (src != PAD)[:, None, None, :]
        n = tgt.shape[1]
        h = self.transformer(self.embed(src), self.embed(tgt), mask,
                             self.tgt_mask[:n, :n], mask)
        return self.logits(h)


def _seq2seq_pair(seed=20):
    paddle.seed(seed)
    jm = JSeq2Seq()
    tm = TSeq2Seq()
    state = _params(jm)
    load_numpy_state(tm, state)
    return jm, tm, state


def _batch(n, seed=21):
    """n sentence pairs: source lengths 5-12, target 4-9, padded with 0;
    the decoder's input starts with BOS, its labels are the target with
    -100 at the pads."""
    rs = np.random.RandomState(seed)
    src = np.zeros((n, S_SRC), np.int64)
    tgt_in = np.zeros((n, S_TGT), np.int64)
    labels = np.full((n, S_TGT), IGNORE, np.int64)
    for i in range(n):
        ls, lt = rs.randint(5, S_SRC + 1), rs.randint(4, S_TGT + 1)
        src[i, :ls] = rs.randint(2, VOCAB, ls)
        words = rs.randint(2, VOCAB, lt)
        labels[i, :lt] = words
        tgt_in[i, 0] = BOS
        tgt_in[i, 1:lt] = words[:-1]
    return src, tgt_in, labels


def _jax_loss(logits, labels):
    n_valid = paddle.sum((labels != IGNORE).astype("float32"))
    return JF.cross_entropy(logits, labels, reduction="sum") / n_valid


def _port_loss(logits, labels):
    n_valid = (labels != IGNORE).sum()
    return F.cross_entropy(logits, labels, reduction="sum") / n_valid


def test_seq2seq_loss_and_gradients_match_reference():
    """The seq2seq model's loss (softmax cross-entropy over the shared
    projection, -100 at target pads, summed over the valid tokens) and
    every parameter's gradient, in train mode at dropout 0."""
    jm, tm, state = _seq2seq_pair()
    src, tgt_in, labels = _batch(B)

    def jfn(params):
        out, _ = functional_call(jm, params, (_j(src), _j(tgt_in)))
        return unwrap(_jax_loss(out, _j(labels)))

    ref, ref_grads = jax.value_and_grad(jfn)(
        {k: jnp.asarray(v) for k, v in state.items()})
    loss = _port_loss(tm(_t(src), _t(tgt_in)), _t(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), **MODEL_TOL)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, r in ref_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(r),
                                   err_msg=name, **MODEL_TOL)


def _port_greedy(tm, src, n, cache=True):
    """Greedy decoding: the encoder once, then one decoder step a token
    with the caches (S_q = 1), or the whole prefix recomputed each
    step."""
    mask = (src != PAD)[:, None, None, :]
    tokens = torch.full((src.shape[0], 1), BOS, dtype=torch.int64)
    with torch.no_grad():
        memory = tm.transformer.encoder(tm.embed(src), mask)
        caches = tm.transformer.decoder.gen_cache(memory)
        for t in range(n):
            if cache:
                h, caches = tm.transformer.decoder(
                    tm.embed(tokens[:, -1:], t), memory, None, mask, caches)
            else:
                m = tnn.Transformer.generate_square_subsequent_mask(t + 1,
                                                                    "cpu")
                h = tm.transformer.decoder(tm.embed(tokens), memory, m, mask)
            nxt = tm.logits(h[:, -1]).argmax(-1)
            tokens = torch.cat([tokens, nxt[:, None]], 1)
    return tokens[:, 1:]


def _jax_greedy(jm, src, n):
    """The reference's own loop over its ``gen_cache``."""
    mask = paddle.unsqueeze(_j(src) != PAD, [1, 2])
    memory = jm.transformer.encoder(jm.embed(_j(src)), mask)
    caches = jm.transformer.decoder.gen_cache(memory)
    tok = np.full((src.shape[0], 1), BOS, np.int64)
    out = []
    for t in range(n):
        h, caches = jm.transformer.decoder(jm.embed(_j(tok), t), memory,
                                           None, mask, caches)
        tok = np.asarray(jm.logits(h).numpy())[:, -1].argmax(-1)[:, None]
        out.append(tok)
    return np.concatenate(out, 1)


def test_greedy_incremental_decoding_matches_reference():
    """Greedy decoding of 3 sources for 8 tokens with the caches gives the
    reference's tokens (its own gen_cache loop) and the port's tokens
    recomputed from the whole prefix with no cache."""
    jm, tm, _ = _seq2seq_pair(22)
    jm.eval()
    tm.eval()
    src = _batch(B, 23)[0]
    got = _port_greedy(tm, _t(src), 8)
    np.testing.assert_array_equal(got.numpy(), _jax_greedy(jm, src, 8))
    assert torch.equal(got, _port_greedy(tm, _t(src), 8, cache=False))


def test_model_fit_matches_reference():
    """``Model(net, inputs=[src, tgt_in], labels=[tgt_out]).fit`` with
    Adam(beta2 0.98, epsilon 1e-9) and NoamDecay(d_model, warmup 4000)
    stepped a batch by the LRScheduler callback: a 5-step loss trajectory
    (each step's loss as fit logs it to a callback) against the
    reference's ``Model.fit`` (dropout 0)."""
    jm, tm, _ = _seq2seq_pair(24)
    src, tgt_in, labels = _batch(5 * B, 25)
    hist = []
    for lib, net in (("jax", jm), ("torch", tm)):
        mod = paddle if lib == "jax" else ptt
        sched = mod.optimizer.lr.NoamDecay(d_model=D_MODEL, warmup_steps=4000)
        opt = mod.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                                 epsilon=1e-9, parameters=net.parameters())
        wrap = paddle.to_tensor if lib == "jax" else _t
        model = mod.Model(net, inputs=["src", "tgt_in"], labels=["tgt_out"])
        model.prepare(opt, _jax_loss if lib == "jax" else _port_loss)
        data = mod.io.TensorDataset([wrap(a) for a in (src, tgt_in, labels)])
        seen = []

        class StepLoss(mod.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                seen.append(float(logs["loss"]))

        model.fit(data, batch_size=B, shuffle=False, verbose=0, log_freq=1,
                  callbacks=[StepLoss()])
        hist.append(seen)
        assert sched.last_epoch == 5
    ref, got = hist
    assert len(got) == 5 and got[-1] < got[0]
    np.testing.assert_allclose(got, ref, **MODEL_TOL)
