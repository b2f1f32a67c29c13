"""Attention dropout in the port, on the CPU (the kernels' plain versions).

The keep mask is one pure function of (seed, b*H + h, q, k, p): Philox4x32-10
keyed by the call's seed (``dropout_keep_plain``, the same function as
csrc/dropout.cuh, which the card tests hold bitwise against it).  The JAX
package draws its mask with ``jax.random.bernoulli`` inside its XLA
composite (paddle_tpu/ops/fused.py); the two streams differ, so the
parity tests hand the port's mask to the reference through a fake
``bernoulli`` (monkeypatched in the test only), then hold the port's
forward and gradients against the reference's:
- function level, float32, atol = rtol = 1e-5 (summation order only);
- model level (a small GPT with attention dropout 0.1 and a small BERT
  whose attention layers drop 0.1, the masks fed in call order), loss and
  every gradient at rtol 1e-4 / atol 1e-6 (tests/test_torch_train.py's
  gradient tolerance).
The default configs (dropout 0.1) train at small width; p = 0 and eval
mode are bitwise the route without dropout; masks are deterministic per
``paddle_tpu_torch.seed`` and differ between seeds and between calls.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBertForPretraining
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.nn.layer_base import functional_call, state_pytrees
from paddle_tpu.ops import fused as jfused
from paddle_tpu.tensor import Tensor, unwrap
from paddle_tpu_torch.framework import random as port_random
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     GPTConfig, GPTForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-6)
GPT_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               max_position_embeddings=32)
BERT_CFG = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64)


def _words(counter, key):
    return ["%08x" % int(w) for w in fa.philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)]


def test_philox_known_answers():
    """Random123's known-answer vectors of Philox4x32-10."""
    assert _words((0, 0, 0, 0), (0, 0)) == [
        "6627e8d5", "e169c58d", "bc57ac4c", "9b00dbd8"]
    m = 0xFFFFFFFF
    assert _words((m, m, m, m), (m, m)) == [
        "408f276d", "41c83b0e", "a20bc7c6", "6d5451fd"]
    assert _words((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
                  (0xa4093822, 0x299f31d0)) == [
        "d16cfe09", "94fdcceb", "5001e420", "24126ea1"]


def test_mask_layout_is_the_documented_one():
    """Key k of query q in plane b*H + h reads the 16-bit half (k % 8) % 2
    of word (k % 8) // 2 of Philox((k // 8, q, b*H + h, 0), seed)."""
    seed, B, H, S, p = 0xFEDCBA9876543210, 2, 3, 21, 0.3
    keep = fa.dropout_keep_plain(seed, B, H, S, p)
    thr = fa.dropout_threshold(p)
    for b, h, q, k in ((0, 0, 0, 0), (1, 2, 20, 19), (1, 0, 7, 8),
                       (0, 1, 13, 3)):
        words = fa.philox4x32_10(
            tuple(torch.tensor(c) for c in (k // 8, q, b * H + h, 0)),
            (seed & 0xFFFFFFFF, seed >> 32))
        draw = (int(words[(k % 8) // 2]) >> (16 * (k % 2))) & 0xFFFF
        assert bool(keep[b, h, q, k]) == (draw >= thr)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_mask_is_a_pure_function_and_keeps_one_minus_p(p):
    """A [B, H, S, S] mask's slice equals the mask drawn for a smaller S,
    and plane (b, h)'s equals the one drawn for one head alone at plane
    index b*H + h; the keep rate lies within 4 sigma of 1 - p."""
    seed, B, H, S = 1234 + int(100 * p), 2, 3, 96
    keep = fa.dropout_keep_plain(seed, B, H, S, p)
    assert keep.shape == (B, H, S, S) and keep.dtype == torch.bool
    small = fa.dropout_keep_plain(seed, B, H, 37, p)
    assert torch.equal(keep[:, :, :37, :37], small)
    one = fa.dropout_keep_plain(seed, B * H, 1, S, p).reshape(B, H, S, S)
    assert torch.equal(keep, one)
    n = keep.numel()
    rate = keep.float().mean().item()
    assert abs(rate - (1 - p)) <= 4 * math.sqrt(p * (1 - p) / n), rate


@pytest.mark.parametrize("p", [0.1, 0.05, 0.2, 0.5, 0.9, 1e-4])
def test_threshold_is_within_1e4_of_p(p):
    """A 16-bit draw: the effective p is round(p * 2^16) / 2^16, within
    2^-17 of the requested one (an 8-bit draw would miss p = 0.1 by
    1.6e-3)."""
    thr = fa.dropout_threshold(p)
    assert abs(thr / 65536 - p) < 1e-4
    assert fa.dropout_keep_plain(1, 1, 1, 8, 0.0).all()
    assert not fa.dropout_keep_plain(1, 1, 1, 8, 1.0).any()


def _composite(causal, mask, p):
    """The reference's scaled_dot_product_attention (on the CPU its XLA
    composite) as a function of raw q, k, v arrays."""
    jm = None if mask is None else Tensor(jnp.asarray(mask))
    return lambda q, k, v: unwrap(jfused.scaled_dot_product_attention(
        Tensor(q), Tensor(k), Tensor(v), attn_mask=jm, dropout_p=p,
        is_causal=causal, training=True))


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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", [None, "bool", "additive"])
def test_attention_dropout_matches_reference(monkeypatch, causal, kind):
    """The port's attention with dropout (its plain forward and the
    dq/dk/dv plain backward through the autograd Function) against the
    reference's composite and its vjp, given the port's mask."""
    B, S, H, D, p, seed = 2, 24, 3, 16, 0.3, 77
    rs = np.random.RandomState(3 + causal)
    q, k, v, do = (rs.randn(B, S, H, D).astype(np.float32)
                   for _ in range(4))
    mask = None
    if kind == "bool":
        mask = rs.rand(B, 1, 1, S) > 0.3
        mask[..., 0] = True                      # every row sees key 0
    elif kind == "additive":
        mask = rs.randn(B, 1, S, S).astype(np.float32)
    keep = fa.dropout_keep_plain(seed, B, H, S, p)
    monkeypatch.setattr(jax.random, "bernoulli", _FakeBernoulli([keep], p))
    ref_out, vjp = jax.vjp(_composite(causal, mask, p),
                           *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    monkeypatch.setattr(port_random, "dropout_seed", lambda: seed)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.attention(*ts, causal=causal, dropout_p=p,
                       mask=None if mask is None else torch.from_numpy(mask))
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **TOL)
    for t, r in zip(ts, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **TOL)


def _record_seeds(monkeypatch):
    """Each seed the port draws for an attention call, in call order."""
    seeds, draw = [], port_random.dropout_seed

    def recording():
        seeds.append(draw())
        return seeds[-1]

    monkeypatch.setattr(port_random, "dropout_seed", recording)
    return seeds


def _jax_value_and_grad(jax_model, state, args):
    params = {k: jnp.asarray(v) for k, v in state.items()}
    buffers = state_pytrees(jax_model)[1]

    def loss_fn(prm):
        out, _ = functional_call(jax_model, prm, args, buffers=buffers,
                                 method="loss")
        return unwrap(out)

    return jax.value_and_grad(loss_fn)(params)


def _assert_model_parity(monkeypatch, jax_model, port_model, jax_args,
                         port_args, shape, p):
    state = {k: np.asarray(v)
             for k, v in state_pytrees(jax_model)[0].items()}
    load_numpy_state(port_model, state)
    port_model.train()
    seeds = _record_seeds(monkeypatch)
    loss = port_model.loss(*port_args)
    loss.backward()
    assert len(seeds) == 2                  # one mask per layer
    masks = [fa.dropout_keep_plain(s, *shape, p) for s in seeds]
    fake = _FakeBernoulli(masks, p)
    monkeypatch.setattr(jax.random, "bernoulli", fake)
    ref_loss, ref_grads = _jax_value_and_grad(jax_model, state, jax_args)
    assert not fake.masks                   # every mask was asked for
    np.testing.assert_allclose(loss.item(), float(ref_loss), **MODEL_TOL)
    grads = {n: t.grad for n, t in port_model.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, ref in ref_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(ref),
                                   err_msg=name, **MODEL_TOL)


def test_gpt_with_attention_dropout_matches_reference(monkeypatch):
    """A small GPT (dropout 0, attn_dropout 0.1): loss and every gradient
    against the reference's, the port's per-layer masks fed to the
    reference in call order."""
    cfg = dict(GPT_CFG, dropout=0.0, attn_dropout=0.1)
    ids = np.random.RandomState(1).randint(0, 64, (2, 16))
    paddle.seed(3)
    jax_model = JGPTForCausalLM(JGPTConfig(**cfg))
    jax_model.train()
    _assert_model_parity(
        monkeypatch, jax_model, GPTForCausalLM(GPTConfig(**cfg),
                                               device="cpu"),
        (paddle.to_tensor(ids, "int64"),), (torch.from_numpy(ids),),
        (2, 4, 16), 0.1)


def test_bert_with_attention_dropout_matches_reference(monkeypatch):
    """A small BERT whose attention layers drop 0.1 (hidden dropout 0):
    loss (MLM + NSP) and every gradient against the reference's, with the
    port's per-layer masks."""
    B, S = 2, 16
    rs = np.random.RandomState(2)
    ids, tt = rs.randint(0, 120, (B, S)), rs.randint(0, 2, (B, S))
    mlm = np.where(rs.rand(B, S) < 0.3, rs.randint(0, 120, (B, S)), -100)
    nsp = rs.randint(0, 2, (B,))
    paddle.seed(5)
    jax_model = JBertForPretraining(JBertConfig(**BERT_CFG, dropout=0.0))
    jax_model.train()
    port_model = BertForPretraining(BertConfig(**BERT_CFG, dropout=0.0),
                                    device="cpu")
    for model in (jax_model, port_model):
        for layer in model.bert.encoder.layers:
            layer.self_attn.dropout = 0.1
    _assert_model_parity(
        monkeypatch, jax_model, port_model,
        tuple(paddle.to_tensor(a, "int64") for a in (ids, mlm, nsp, tt)),
        tuple(torch.from_numpy(a) for a in (ids, mlm, nsp, tt)),
        (B, 4, S), 0.1)


def test_zero_p_and_eval_are_the_route_without_dropout():
    """p = 0 in training and any p in eval mode give bitwise the output
    and gradients of attention without dropout, and draw no seed."""
    rs = np.random.RandomState(4)
    qkv = rs.randn(2, 9, 3, 2, 16).astype(np.float32)
    mask = torch.from_numpy(rs.rand(2, 1, 1, 9) > 0.2)
    runs = []
    for p, training in ((None, True), (0.0, True), (0.3, False)):
        state = port_random.default_generator().get_state()
        t = torch.from_numpy(qkv).requires_grad_()
        kw = {} if p is None else dict(dropout_p=p, training=training)
        a = fused.packed_causal_attention(t, **kw)
        b = fused.scaled_dot_product_attention(*t.unbind(2), attn_mask=mask,
                                               **kw)
        (a.square().sum() + b.square().sum()).backward()
        assert torch.equal(state, port_random.default_generator().get_state())
        runs.append((a.detach(), b.detach(), t.grad))
    for run in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(run, runs[0]))
    ptt.seed(0)
    model = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu").eval()
    ptt.seed(0)
    plain = GPTForCausalLM(GPTConfig(**GPT_CFG, dropout=0.0,
                                     attn_dropout=0.0), device="cpu").eval()
    ids = torch.from_numpy(np.random.RandomState(5).randint(0, 64, (2, 16)))
    assert torch.equal(model(ids), plain(ids))


def test_masks_are_deterministic_per_seed_and_fresh_per_call():
    """Two runs from the same paddle_tpu_torch.seed draw the same masks;
    another seed, and each successive call, draw different ones.  Under
    torch.no_grad() in training the forward still drops."""
    x = torch.from_numpy(np.random.RandomState(6).randn(
        2, 16, 3, 2, 16).astype(np.float32))

    def two_calls(s):
        ptt.seed(s)
        return [fused.packed_causal_attention(x, dropout_p=0.5)
                for _ in range(2)]

    first, again, other = two_calls(1), two_calls(1), two_calls(2)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not torch.equal(first[0], first[1])
    assert not torch.equal(first[0], other[0])
    with torch.no_grad():
        assert not torch.equal(fused.packed_causal_attention(x, 0.5),
                               fused.packed_causal_attention(x, 0.0))


def test_dropout_in_training_changes_the_result_only_there():
    """Dropout in training returns a finite result of the right shape that
    differs from p = 0; the kernel wrappers refuse p outside [0, 1]."""
    x = torch.from_numpy(np.random.RandomState(7).randn(
        1, 12, 2, 16).astype(np.float32))
    out = fused.scaled_dot_product_attention(x, x, x, dropout_p=0.2)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert not torch.equal(out, fused.scaled_dot_product_attention(x, x, x))
    for p in (-0.1, 1.5):
        with pytest.raises(ValueError):
            fa.flash_attention(x, x, x, dropout_p=p)


def _train(model, opt, step_args, steps=3):
    losses = []
    for _ in range(steps):
        loss = model.loss(*step_args)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses


@pytest.mark.parametrize("name", ["gpt", "bert"])
def test_default_configs_train(name):
    """GPTConfig() and BertConfig() left at their dropout 0.1 (attention
    and hidden) train at small width for 3 AdamW steps: finite losses
    that fall, the same over two runs from one paddle_tpu_torch.seed."""
    rs = np.random.RandomState(8)
    runs = []
    for _ in range(2):
        ptt.seed(9)
        if name == "gpt":
            cfg = GPTConfig(**GPT_CFG)
            assert cfg.dropout == cfg.attn_dropout == 0.1
            model = GPTForCausalLM(cfg, device="cpu").train()
            args = (torch.from_numpy(
                np.random.RandomState(8).randint(0, 64, (4, 16))),)
        else:
            cfg = BertConfig(**BERT_CFG)
            assert cfg.dropout == 0.1
            model = BertForPretraining(cfg, device="cpu").train()
            B, S = 4, 16
            rs = np.random.RandomState(8)
            ids, tt = rs.randint(0, 120, (B, S)), rs.randint(0, 2, (B, S))
            mlm = np.where(rs.rand(B, S) < 0.3,
                           rs.randint(0, 120, (B, S)), -100)
            args = tuple(torch.from_numpy(a) for a in
                         (ids, mlm, rs.randint(0, 2, (B,)), tt))
        opt = ptt.optimizer.AdamW(learning_rate=1e-2,
                                  parameters=model.parameters())
        runs.append(_train(model, opt, args))
    losses = runs[0]
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0], losses
    assert runs[0] == runs[1]
