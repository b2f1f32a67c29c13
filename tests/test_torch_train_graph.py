"""The training engine's captured step, on the CPU.

On a CUDA device ``Model.fit`` captures the step of each batch signature
once as a CUDA graph and replays it; the graph freezes every value a
kernel takes by value, so what changes per step is read from device
memory: the optimizer's scalars (``Optimizer.begin_step``) and attention
dropout's step counter, the Philox counter's fourth word
(framework/random.py ``StepKeys``/``StepSeed``, csrc/dropout.cuh).  Held
here on the CPU:
- the mask in the new seed form (``dropout_keep_plain``): Random123's
  known answers with a non-zero fourth word, bitwise the int form at
  counter 0, a distinct mask at every step, keep rate within 4 sigma;
- the attention forward and q, k, v gradients at a step other than the
  first against the reference's XLA composite given the port's mask
  (``jax.random.bernoulli`` monkeypatched in the test only, as in
  tests/test_torch_attention_dropout.py), float32, atol = rtol = 1e-5;
- the engine's host prologue: the step count, the lr of a scheduler
  stepped mid-run and the dropout counter advance once per executed step,
  as the dygraph loop's do, the first step of a signature included, and
  never at the capture; the per-call keys stay fixed;
- the graph path's plumbing (static buffers, the signature cache, a short
  last batch's second capture, the ring's copy of the static loss, fresh
  outputs) through a CPU stand-in for the CUDA capture whose replay runs
  the captured body: losses and parameters bitwise the eager step's over
  a run with dropout 0.1;
- on the CPU ``Model.fit`` stays the eager step (no capture);
- ``Optimizer.step()`` is ``begin_step()`` then ``apply_step()``.
The card tests (tests/test_torch_cuda.py) hold the real graph bitwise
against ``_step_eager``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu.ops import fused as jfused
from paddle_tpu.tensor import Tensor, unwrap
from paddle_tpu_torch.framework import random as port_random
from paddle_tpu_torch.framework.random import StepKeys, StepSeed
from paddle_tpu_torch.hapi.callbacks import Callback
from paddle_tpu_torch.hapi.engine import TrainEngine, _StepGraph
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(atol=1e-5, rtol=1e-5)
GPT_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               max_position_embeddings=32)


def _counter(value):
    return torch.tensor([value], dtype=torch.int32)


def _words(counter, key):
    return ["%08x" % int(w) for w in fa.philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)]


def test_philox_known_answers_with_the_fourth_word():
    """Random123's known-answer vectors of Philox4x32-10 whose counter's
    fourth word (the step's, in the new seed form) is not zero."""
    assert _words((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF)) == [
        "408f276d", "41c83b0e", "a20bc7c6", "6d5451fd"]
    assert _words((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
                  (0xA4093822, 0x299F31D0)) == [
        "d16cfe09", "94fdcceb", "5001e420", "24126ea1"]


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_step_seed_at_counter_zero_is_the_int_seed(p):
    key = 0x0123456789ABCDEF
    assert torch.equal(
        fa.dropout_keep_plain(StepSeed(key, _counter(0)), 2, 3, 37, p),
        fa.dropout_keep_plain(key, 2, 3, 37, p))


def test_the_counter_is_the_fourth_word_of_the_philox_counter():
    """The mask of (key, counter s) is Philox keyed by the key at counter
    (k // 8, q, b*H + h, s), as csrc/dropout.cuh draws it; a negative int32
    counter is read as its 32-bit word."""
    key, B, H, S, p = 987654321987, 1, 2, 16, 0.25
    for step, word in ((7, 7), (-1, 0xFFFFFFFF)):
        mask = fa.dropout_keep_plain(StepSeed(key, _counter(step)), B, H, S,
                                     p)
        thr = fa.dropout_threshold(p)
        for plane, q, group in ((0, 0, 0), (1, 5, 1), (1, 15, 0)):
            w = [int(x) for x in fa.philox4x32_10(
                tuple(torch.tensor(c) for c in (group, q, plane, word)),
                (key & 0xFFFFFFFF, key >> 32))]
            draws = [(w[e // 2] >> (16 * (e % 2))) & 0xFFFF
                     for e in range(8)]
            got = mask[plane // H, plane % H, q, 8 * group:8 * group + 8]
            assert got.tolist() == [d >= thr for d in draws]


@pytest.mark.parametrize("p", [0.1, 0.3])
def test_every_step_draws_its_own_mask(p):
    """One key, steps 0..5: six different masks, each keeping 1 - p of
    the pairs within 4 sigma."""
    key, B, H, S = 4242, 2, 3, 64
    masks = [fa.dropout_keep_plain(StepSeed(key, _counter(s)), B, H, S, p)
             for s in range(6)]
    n = masks[0].numel()
    sigma = math.sqrt(n * p * (1 - p))
    for i, m in enumerate(masks):
        assert abs(int(m.sum()) - n * (1 - p)) < 4 * sigma
        for other in masks[:i]:
            assert not torch.equal(m, other)
    # a step's mask is a pure function of (key, counter)
    assert torch.equal(masks[3], fa.dropout_keep_plain(
        StepSeed(key, _counter(3)), B, H, S, p))


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
@pytest.mark.parametrize("kind", [None, "bool"])
def test_attention_at_a_later_step_matches_reference(monkeypatch, causal,
                                                     kind):
    """The port's attention inside an engine step (a StepKeys scope at
    step 3: the call draws a StepSeed) against the reference's composite
    and its vjp given the port's mask of that step, forward and q, k, v
    gradients through the autograd Function."""
    B, S, H, D, p = 2, 24, 3, 16, 0.3
    rs = np.random.RandomState(11 + causal)
    q, k, v, do = (rs.randn(B, S, H, D).astype(np.float32)
                   for _ in range(4))
    mask = None
    if kind == "bool":
        mask = rs.rand(B, 1, 1, S) > 0.3
        mask[..., 0] = True
    ptt.seed(5)
    keys = StepKeys("cpu")
    for _ in range(3):
        keys.advance()
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    with keys.scope():
        out = fa.attention(*ts, causal=causal, dropout_p=p,
                           mask=None if mask is None else
                           torch.from_numpy(mask))
    out.backward(torch.from_numpy(do))
    assert len(keys.keys) == 1 and int(keys.counter) == 3
    keep = fa.dropout_keep_plain(StepSeed(keys.keys[0], keys.counter), B, H,
                                 S, p)
    assert not torch.equal(keep, fa.dropout_keep_plain(keys.keys[0], B, H,
                                                       S, p))
    monkeypatch.setattr(jax.random, "bernoulli", _FakeBernoulli([keep], p))
    ref_out, vjp = jax.vjp(_composite(causal, mask, p),
                           *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **TOL)
    for t, r in zip(ts, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **TOL)


def test_step_keys_hand_out_fixed_keys_and_the_counter():
    """Inside a scope the i-th call of every step gets keys[i] (drawn once,
    from the framework generator) and the one counter; outside it,
    dropout_seed is the dygraph's int draw."""
    ptt.seed(1)
    keys = StepKeys("cpu")
    seen = []
    for _ in range(3):
        keys.advance()
        with keys.scope():
            seen.append([port_random.dropout_seed() for _ in range(2)])
    assert keys.step == 3 and int(keys.counter) == 3
    assert all(s == StepSeed(keys.keys[i], keys.counter)
               for step in seen for i, s in enumerate(step))
    assert len(keys.keys) == 2 and keys.keys[0] != keys.keys[1]
    ptt.seed(1)
    assert keys.keys == [port_random.dropout_seed() for _ in range(2)]
    assert isinstance(port_random.dropout_seed(), int)


def _gpt(seed=3, **overrides):
    ptt.seed(seed)
    return GPTForCausalLM(GPTConfig(**{**GPT_CFG, **overrides}),
                          device="cpu")


def _lm_loss(logits, labels):
    logp = logits[:, :-1].float().log_softmax(-1)
    return -logp.gather(-1, labels[:, 1:, None])[..., 0].mean()


def _stand_in(engine):
    """Put ``engine`` on its graph path with a CPU stand-in for the CUDA
    warm-up and capture: the warm-up is the eager step on the current
    stream, the capture records nothing, and each replay runs the
    captured body (under the step's keys) on the static batch and writes
    the static loss and outputs in place, as a replay of the graph
    does."""
    def capture(sig, s_in, s_lab):
        g = _StepGraph(None, s_in, s_lab, torch.zeros(()), None, {})

        def replay():
            with engine._keys.scope():
                loss, outs = engine._body(s_in, s_lab)
            g.loss.copy_(loss)
            if g.outs is None:
                g.outs = torch.empty_like(outs)
            g.outs.copy_(outs.detach())

        g.replay = replay
        return g

    engine._warm_up = engine._eager
    engine._capture = capture
    engine._keys = StepKeys("cpu")
    engine._replaying = True
    return engine


def _engine(net, lr, graph):
    model = ptt.Model(net).prepare(
        ptt.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                            parameters=net.parameters()), _lm_loss)
    engine = TrainEngine(model)
    _stand_in(engine)
    if not graph:           # the eager step, with the keys
        engine.step = engine._step_eager
    model._engine = engine
    return model, engine.begin()


def _batches(n, B=2, S=16, short=0):
    rs = np.random.RandomState(4)
    out = [torch.from_numpy(rs.randint(0, 64, (B, S))) for _ in range(n)]
    if short:
        out.append(torch.from_numpy(rs.randint(0, 64, (short, S))))
    return out


def test_prologue_runs_once_per_executed_step(monkeypatch):
    """On the graph path (stand-in capture) over 6 steps of one
    signature with a StepDecay stepped after the third: the step count,
    the lr the update reads and the dropout counter each advance once a
    step, the first step (eager, then the capture) included, and equal
    the dygraph loop's; the keys stay those of the first step."""
    sched = ptt.optimizer.lr.StepDecay(0.01, step_size=1, gamma=0.5)
    net = _gpt(attn_dropout=0.1)
    model, engine = _engine(net, sched, graph=True)
    opt = model._optimizer
    seen, plain = [], fa.dropout_keep_plain

    def recording(seed, *args, **kw):
        seen.append(fa._key_and_step(seed))
        return plain(seed, *args, **kw)

    monkeypatch.setattr(fa, "dropout_keep_plain", recording)
    got = []
    for i, ids in enumerate(_batches(6)):
        engine.step([ids], [ids])
        got.append((opt._step_count, opt._lr_now, engine._keys.step))
        if i == 2:
            sched.step()
    assert engine.captures == 1 and engine.replays == 5
    assert got == [(i + 1, 0.01 if i < 3 else 0.005, i + 1)
                   for i in range(6)]
    # two attention calls a step, each mask drawn in the forward and in
    # dq and dk/dv: per step one key per call, the step's counter
    keys = engine._keys.keys
    assert len(keys) == 2
    per_step = len(seen) // 6
    for i in range(6):
        step = seen[i * per_step:(i + 1) * per_step]
        assert {s for _, s in step} == {i + 1}
        assert {k for k, _ in step} == set(keys)

    # the dygraph loop's step counts and lrs
    sched2 = ptt.optimizer.lr.StepDecay(0.01, step_size=1, gamma=0.5)
    net2 = _gpt(attn_dropout=0.1)
    opt2 = ptt.optimizer.AdamW(learning_rate=sched2, weight_decay=0.01,
                               parameters=net2.parameters())
    want = []
    for i, ids in enumerate(_batches(6)):
        _lm_loss(net2(ids), ids).backward()
        opt2.step()
        opt2.clear_grad()
        want.append((opt2._step_count, opt2._lr_now, i + 1))
        if i == 2:
            sched2.step()
    assert got == want


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_graph_path_is_bitwise_the_eager_step(dropout):
    """Model.fit over 7 batches and a short last one, through the graph
    path (stand-in capture) and through ``_step_eager`` with the same
    keys, from one seed: the same losses and parameters bitwise, two
    captures (one a signature), no eager step after a signature's
    first."""
    runs = []
    for graph in (True, False):
        net = _gpt(dropout=dropout, attn_dropout=dropout)
        model, engine = _engine(net, 0.01, graph)
        data = torch.cat(_batches(7, short=1))
        hist = model.fit(ptt.io.TensorDataset([data, data]), batch_size=2,
                         shuffle=False, verbose=0, log_freq=3)
        runs.append((hist["step_loss"], [p.detach().clone()
                                         for p in net.parameters()]))
        if graph:
            assert engine.captures == 2 and engine.replays == 6
            assert len(engine.graph_launches) == 2
    (losses, params), (eager_losses, eager_params) = runs
    assert len(losses) == 8 and all(math.isfinite(x) for x in losses)
    assert losses == eager_losses
    assert all(torch.equal(a, b) for a, b in zip(params, eager_params))


def test_replay_returns_the_static_outputs_and_a_copy_of_the_loss():
    """A replayed step returns the graph's static outputs (no copy: the
    next replay overwrites them, and fit drops them) and hands the ring a
    copy of the static loss, so every step's loss survives."""
    net = _gpt(dropout=0.0, attn_dropout=0.0)
    model, engine = _engine(net, 0.01, graph=True)
    ids = _batches(3)
    engine.step([ids[0]], [ids[0]])
    out1 = engine.step([ids[1]], [ids[1]])
    g = next(iter(engine._graphs.values()))
    assert out1 is g.outs
    held = out1.clone()
    assert engine.step([ids[2]], [ids[2]]) is g.outs
    assert not torch.equal(held, g.outs)
    assert all(t is not g.loss for t in engine.ring._pending)
    losses = engine.drain()
    assert len(losses) == 3 and len(set(losses)) == 3


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_a_loaded_optimizer_state_is_captured_again(dropout):
    """fit, save the optimizer's state, fit on, load the saved state (its
    slots are new tensors) and fit again: the next begin() drops the
    graph captured over the old slots and captures the step anew over the
    loaded ones; losses and parameters bitwise the eager step's doing the
    same, and the loaded moments differ from the ones replaced."""
    data = torch.cat(_batches(8))
    runs = []
    for graph in (True, False):
        net = _gpt(dropout=dropout, attn_dropout=dropout)
        model, engine = _engine(net, 0.01, graph)
        opt = model._optimizer

        def fit(lo, hi):
            part = data[lo * 2:hi * 2]
            return model.fit(ptt.io.TensorDataset([part, part]),
                             batch_size=2, shuffle=False,
                             verbose=0)["step_loss"]

        losses = fit(0, 3)
        saved = opt.state_dict()
        losses += fit(3, 5)
        before = [v.clone() for s in opt._slots.values()
                  for v in s.values()]
        opt.set_state_dict(saved)
        assert opt._step_count == 3
        assert not all(torch.equal(a, v) for a, v in zip(
            before, (v for s in opt._slots.values() for v in s.values())))
        losses += fit(5, 8)
        runs.append((losses, [p.detach().clone() for p in net.parameters()]))
        if graph:
            assert engine.captures == 2 and engine.replays == 6
    (losses, params), (eager_losses, eager_params) = runs
    assert len(losses) == 8 and all(math.isfinite(x) for x in losses)
    assert losses == eager_losses
    assert all(torch.equal(a, b) for a, b in zip(params, eager_params))


class _Replacer(Callback):
    """A user callback that replaces training state mid-fit: after step 1
    the first parameter's ``.data`` (clipped, a new tensor), after step 3
    the optimizer's slots (``set_state_dict`` of a state saved after step
    0)."""

    def __init__(self, net, opt):
        super().__init__()
        self.net, self.opt = net, opt

    def on_train_batch_end(self, step, logs=None):
        if step == 0:
            self.saved = self.opt.state_dict()
        elif step == 1:
            p = self.net.parameters()[0]
            p.data = p.data.clamp(-0.05, 0.05)
        elif step == 3:
            self.opt.set_state_dict(self.saved)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_a_callback_that_replaces_state_mid_fit_is_captured_again(dropout):
    """A user callback replaces a parameter's tensor and then the
    optimizer's slots between two steps of one fit: fit drops the graph
    before the next step and captures anew (three captures in all), and
    losses and parameters are bitwise the eager step's with the same
    callback."""
    data = torch.cat(_batches(6))
    runs = []
    for graph in (True, False):
        net = _gpt(dropout=dropout, attn_dropout=dropout)
        model, engine = _engine(net, 0.01, graph)
        hist = model.fit(ptt.io.TensorDataset([data, data]), batch_size=2,
                         shuffle=False, verbose=0,
                         callbacks=[_Replacer(net, model._optimizer)])
        runs.append((hist["step_loss"],
                     [p.detach().clone() for p in net.parameters()]))
        if graph:
            assert engine.captures == 3 and engine.replays == 3
    (losses, params), (eager_losses, eager_params) = runs
    assert len(losses) == 6 and all(math.isfinite(x) for x in losses)
    assert losses == eager_losses
    assert all(torch.equal(a, b) for a, b in zip(params, eager_params))


def test_fit_on_the_cpu_is_the_eager_step():
    net = _gpt(dropout=0.1, attn_dropout=0.1)
    model = ptt.Model(net).prepare(
        ptt.optimizer.AdamW(learning_rate=0.01,
                            parameters=net.parameters()), _lm_loss)
    data = torch.cat(_batches(3))
    seeds, draw = [], port_random.dropout_seed

    def recording():
        seeds.append(draw())
        return seeds[-1]

    port_random.dropout_seed, saved = recording, port_random.dropout_seed
    try:
        model.fit(ptt.io.TensorDataset([data, data]), batch_size=2,
                  shuffle=False, verbose=0)
    finally:
        port_random.dropout_seed = saved
    engine = model._engine
    assert engine._keys is None and engine.captures == 0
    # the dygraph draw: a fresh int seed for every call
    assert len(seeds) == 6 and len(set(seeds)) == 6
    assert all(isinstance(s, int) for s in seeds)


def test_step_is_begin_step_then_apply_step():
    nets = [_gpt(dropout=0.0, attn_dropout=0.0) for _ in range(2)]
    opts = [ptt.optimizer.AdamW(learning_rate=0.01,
                                parameters=n.parameters()) for n in nets]
    ids = _batches(1)[0]
    for i in range(2):
        for net, opt in zip(nets, opts):
            _lm_loss(net(ids), ids).backward()
        opts[0].step()
        opts[1].begin_step()
        opts[1].apply_step()
        for opt in opts:
            opt.clear_grad()
    assert opts[0]._step_count == opts[1]._step_count == 2
    assert all(torch.equal(a, b) for a, b in
               zip(nets[0].parameters(), nets[1].parameters()))
    fresh = ptt.optimizer.AdamW(learning_rate=0.01,
                                parameters=nets[0].parameters())
    with pytest.raises(RuntimeError, match="begin_step"):
        fresh.apply_step()
