"""The port's GPT training slice against the JAX package's, on the CPU.

A tiny GPT (tests/test_models.py's ``_tiny_gpt``: vocab 64, hidden 32, 2
layers, 4 heads, dropout 0) is built by the JAX package and its weights
carried over by name (``load_numpy_state``).  Held against the
reference, with the same token ids:
- ``loss(ids)`` and EVERY parameter gradient vs ``jax.value_and_grad`` of
  ``functional_call(..., method="loss")``, at rtol 1e-4 / atol 1e-6 (the
  tolerance of test_models.py's gradient parity);
- a 5-step AdamW trajectory (losses and final parameters) vs
  ``opt.apply_pytree``; resuming from JAX's step-3 state
  (``load_numpy_optimizer_state``) reaches JAX's step 5;
- ``Model.fit(shuffle=False)`` per-step losses vs the JAX package's
  ``paddle.Model.fit`` with the same loss on the logits;
- the optimizers, LR schedulers and gradient clips on the cases of
  tests/test_optimizer_torch_parity.py and tests/test_lr_torch_parity.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.hapi.callbacks import Callback
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.nn.clip import clip_grad_norm_ as jax_clip_grad_norm_
from paddle_tpu.nn.layer_base import functional_call, state_pytrees
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_numpy_optimizer_state,
                                     load_numpy_state)

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=32, dropout=0.0, attn_dropout=0.0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LR, WD = 1e-3, 0.01
IDS = np.random.RandomState(1).randint(0, 64, (2, 16))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(3)
    m = JGPTForCausalLM(JGPTConfig(**CFG))
    m.train()
    return m


@pytest.fixture(scope="module")
def state0(jax_model):
    return _np(state_pytrees(jax_model)[0])


def _port_model(state):
    m = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_numpy_state(m, state)
    return m.train()


def _jax_loss_and_grad(jax_model, params):
    buffers = state_pytrees(jax_model)[1]

    def loss_fn(p):
        out, _ = functional_call(jax_model, p,
                                 (paddle.to_tensor(IDS, "int64"),),
                                 buffers=buffers, method="loss")
        return out.value if hasattr(out, "value") else out

    return jax.value_and_grad(loss_fn)(params)


@pytest.fixture(scope="module")
def jax_trajectory(jax_model, state0):
    """Five AdamW steps of the reference through apply_pytree: (losses,
    params after each step, opt state after each step)."""
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=WD)
    params = {k: jnp.asarray(v) for k, v in state0.items()}
    state = opt.init_pytree(params)
    losses, params_at, state_at = [], [], []
    for t in range(1, 6):
        loss, grads = _jax_loss_and_grad(jax_model, params)
        params, state = opt.apply_pytree(params, grads, state, lr=LR, step=t)
        losses.append(float(loss))
        params_at.append(_np(params))
        state_at.append({k: _np(v) for k, v in state.items()})
    return losses, params_at, state_at


def test_loss_and_every_gradient_match_jax(jax_model, state0):
    params = {k: jnp.asarray(v) for k, v in state0.items()}
    ref_loss, ref_grads = _jax_loss_and_grad(jax_model, params)
    model = _port_model(state0)
    loss = model.loss(torch.from_numpy(IDS))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(ref_loss), **GRAD_TOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, ref in ref_grads.items():  # per leaf, every parameter
        assert grads[name] is not None, name
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(ref),
                                   err_msg=name, **GRAD_TOL)


def _port_adamw_steps(model, n, opt=None):
    opt = opt or ptt.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                     parameters=model.parameters())
    losses = []
    for _ in range(n):
        loss = model.loss(torch.from_numpy(IDS))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses


# The key third of each qkv bias has an exactly-zero gradient (adding a
# constant to every key of a query shifts its scores alike, and softmax is
# shift-invariant), so both frameworks compute it as rounding noise of
# about 1e-10, which Adam scales to about lr * 1e-10 / eps = 1e-5 per step.
# Those entries are held at atol 5e-5; every other entry at GRAD_TOL.
KEY_BIAS_ATOL = 5e-5


def _assert_params(model, ref):
    H = CFG["hidden_size"]
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), ref[name]
        if name.endswith("attn.qkv.bias"):
            np.testing.assert_allclose(got[H:2 * H], want[H:2 * H],
                                       atol=KEY_BIAS_ATOL, rtol=0,
                                       err_msg=name)
            got, want = np.delete(got, np.s_[H:2 * H]), \
                np.delete(want, np.s_[H:2 * H])
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)


def test_adamw_trajectory_matches_apply_pytree(state0, jax_trajectory):
    ref_losses, ref_params, _ = jax_trajectory
    model = _port_model(state0)
    losses = _port_adamw_steps(model, 5)
    np.testing.assert_allclose(losses, ref_losses, **GRAD_TOL)
    assert losses[-1] < losses[0]
    _assert_params(model, ref_params[-1])


def test_resume_from_jax_optimizer_state(jax_trajectory):
    """The JAX run's parameters and AdamW moments after step 3, carried
    over, continue to the JAX run's step 5."""
    ref_losses, ref_params, ref_state = jax_trajectory
    model = _port_model(ref_params[2])
    opt = ptt.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                              parameters=model.parameters())
    load_numpy_optimizer_state(opt, model, ref_state[2], step_count=3)
    assert opt._step_count == 3
    losses = _port_adamw_steps(model, 2, opt)
    np.testing.assert_allclose(losses, ref_losses[3:], **GRAD_TOL)
    _assert_params(model, ref_params[4])


def test_load_numpy_optimizer_state_is_strict(state0, jax_trajectory):
    model = _port_model(state0)
    opt = ptt.optimizer.AdamW(parameters=model.parameters())
    good = jax_trajectory[2][0]
    with pytest.raises(KeyError):
        load_numpy_optimizer_state(opt, model, {k: v for k, v in good.items()
                                                if k != "gpt.ln_f.bias"}, 1)
    bad = dict(good, **{"gpt.ln_f.bias": {"moment1": np.zeros(32)}})
    with pytest.raises(KeyError):
        load_numpy_optimizer_state(opt, model, bad, 1)
    bad = dict(good, **{"gpt.ln_f.bias": {"moment1": np.zeros(3),
                                          "moment2": np.zeros(3)}})
    with pytest.raises(ValueError):
        load_numpy_optimizer_state(opt, model, bad, 1)


def _jax_lm_loss(logits, labels):
    lv = logits.value if hasattr(logits, "value") else logits
    yv = labels.value if hasattr(labels, "value") else labels
    logp = jax.nn.log_softmax(lv[:, :-1].astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, yv[:, 1:, None], axis=-1)[..., 0]
    return nll.mean()


def _torch_lm_loss(logits, labels):
    logp = torch.log_softmax(logits[:, :-1].float(), -1)
    return -logp.gather(-1, labels[:, 1:, None].long())[..., 0].mean()


class _StepLosses(Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))


def test_model_fit_losses_match_jax_fit(state0):
    """Model.prepare(AdamW, lm_loss).fit(shuffle=False): the same
    per-step losses as the reference's fit over the same 4 batches, and
    the same final parameters."""
    data = np.random.RandomState(2).randint(0, 64, (8, 16))
    paddle.seed(3)
    jnet = JGPTForCausalLM(JGPTConfig(**CFG))
    jnet.set_state_dict({k: paddle.to_tensor(v) for k, v in state0.items()})
    jmodel = paddle.Model(jnet)
    jmodel.prepare(paddle.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                          parameters=jnet.parameters()),
                   _jax_lm_loss)
    rec = _StepLosses()
    jmodel.fit(paddle.io.TensorDataset([paddle.to_tensor(data),
                                        paddle.to_tensor(data)]),
               batch_size=2, epochs=1, shuffle=False, verbose=0,
               callbacks=[rec])

    net = _port_model(state0)
    model = ptt.Model(net).prepare(
        ptt.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                            parameters=net.parameters()), _torch_lm_loss)
    t = torch.from_numpy(data)
    hist = model.fit(ptt.io.TensorDataset([t, t]), batch_size=2, epochs=1,
                     shuffle=False, verbose=0, log_freq=3)
    assert len(rec.losses) == 4
    np.testing.assert_allclose(hist["step_loss"], rec.losses, **GRAD_TOL)
    np.testing.assert_allclose(hist["loss"], [np.mean(rec.losses)],
                               **GRAD_TOL)
    _assert_params(net, _np(state_pytrees(jnet)[0]))


@pytest.mark.parametrize("drop_last", [False, True])
def test_fit_drop_last_steps_match_jax_fit(state0, drop_last):
    """``fit(drop_last=...)`` over 7 samples in batches of 2: the
    reference's fit takes 4 steps a epoch, the last of one sample, or 3
    with ``drop_last``; the port's fit takes the same steps, with the same
    losses, over two epochs."""
    data = np.random.RandomState(6).randint(0, 64, (7, 16))
    paddle.seed(3)
    jnet = JGPTForCausalLM(JGPTConfig(**CFG))
    jnet.set_state_dict({k: paddle.to_tensor(v) for k, v in state0.items()})
    jmodel = paddle.Model(jnet)
    jmodel.prepare(paddle.optimizer.SGD(learning_rate=0.05,
                                        parameters=jnet.parameters()),
                   _jax_lm_loss)
    rec = _StepLosses()
    jmodel.fit(paddle.io.TensorDataset([paddle.to_tensor(data),
                                        paddle.to_tensor(data)]),
               batch_size=2, epochs=2, shuffle=False, verbose=0,
               drop_last=drop_last, callbacks=[rec])

    net = _port_model(state0)
    model = ptt.Model(net).prepare(
        ptt.optimizer.SGD(learning_rate=0.05, parameters=net.parameters()),
        _torch_lm_loss)
    t = torch.from_numpy(data)
    hist = model.fit(ptt.io.TensorDataset([t, t]), batch_size=2, epochs=2,
                     shuffle=False, verbose=0, drop_last=drop_last)
    assert len(rec.losses) == 2 * (3 if drop_last else 4)
    assert len(hist["step_loss"]) == len(rec.losses)
    np.testing.assert_allclose(hist["step_loss"], rec.losses, **GRAD_TOL)


def test_model_batch_api_and_evaluate(state0):
    net = _port_model(state0)
    model = ptt.Model(net).prepare(ptt.optimizer.AdamW(learning_rate=LR),
                                   _torch_lm_loss)
    ids = torch.from_numpy(IDS)
    outs, loss = model.eval_batch([ids], [ids])
    assert outs.shape == (2, 16, 64) and not net.training
    ref = _torch_lm_loss(net(ids), ids).item()
    assert loss == pytest.approx(ref, rel=1e-6)
    res = model.evaluate(ptt.io.TensorDataset([ids, ids]), batch_size=1,
                         verbose=0)
    assert np.isfinite(res["loss"])
    assert model.predict_batch([ids]).shape == (2, 16, 64)
    first = model.train_batch([ids], [ids])
    assert first == pytest.approx(loss, rel=1e-5) and net.training
    assert model.train_batch([ids], [ids]) < first


def test_fit_with_eval_data_and_shuffle(state0):
    net = _port_model(state0)
    model = ptt.Model(net).prepare(
        ptt.optimizer.SGD(learning_rate=0.1, parameters=net.parameters()),
        _torch_lm_loss)
    t = torch.from_numpy(np.random.RandomState(5).randint(0, 64, (6, 16)))
    ds = ptt.io.TensorDataset([t, t])
    ptt.seed(0)
    hist = model.fit(ds, eval_data=ds, batch_size=4, epochs=2, verbose=0)
    assert len(hist["loss"]) == len(hist["eval_loss"]) == 2
    assert len(hist["step_loss"]) == 4       # 6 samples: batches 4 and 2
    assert hist["eval_loss"][1] < hist["eval_loss"][0]


def test_forward_with_labels_names_the_missing_kernels(state0):
    """forward(ids, labels) was refused until the softmax cross-entropy
    kernels were ported; it now gives the reference's (logits, loss), and
    the loss is loss(ids)'s up to the float32 head order (the fused loss
    streams vocab chunks; tests/test_torch_xent.py holds it against JAX)."""
    model = _port_model(state0)
    ids = torch.from_numpy(IDS)
    logits, loss = model(ids, labels=ids)
    assert logits.shape == (2, 16, 64) and loss.shape == ()
    np.testing.assert_allclose(loss.item(), model.loss(ids).item(),
                               **GRAD_TOL)


# ---------------------------------------------------------------------------
# optimizers, schedulers and clips: the port against the reference (and,
# for the update rules, against torch.optim, on the cases of
# tests/test_optimizer_torch_parity.py)
# ---------------------------------------------------------------------------
_RS = np.random.RandomState(3)
_W0 = _RS.randn(5, 3).astype(np.float32)
_GRADS = [_RS.randn(5, 3).astype(np.float32) for _ in range(10)]

OPTIMIZERS = {
    "sgd": (lambda m, ps: m.SGD(learning_rate=0.1, parameters=ps),
            lambda ps: torch.optim.SGD(ps, lr=0.1)),
    "momentum": (lambda m, ps: m.Momentum(learning_rate=0.05, momentum=0.9,
                                          parameters=ps),
                 lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9)),
    "adam": (lambda m, ps: m.Adam(learning_rate=1e-2, beta1=0.9,
                                  beta2=0.999, epsilon=1e-8, parameters=ps),
             lambda ps: torch.optim.Adam(ps, lr=1e-2, betas=(0.9, 0.999),
                                         eps=1e-8)),
    "adamw": (lambda m, ps: m.AdamW(learning_rate=1e-2, weight_decay=0.05,
                                    parameters=ps),
              lambda ps: torch.optim.AdamW(ps, lr=1e-2, weight_decay=0.05)),
}


def _run_jax(factory):
    p = paddle.to_tensor(_W0.copy(), stop_gradient=False)
    opt = factory(paddle.optimizer, [p])
    for g in _GRADS:
        p.grad = paddle.to_tensor(g)
        opt.step()
        opt.clear_grad()
    return np.asarray(p.numpy())


def _run_port(factory, grads=_GRADS):
    p = torch.nn.Parameter(torch.tensor(_W0.copy()))
    opt = factory(ptt.optimizer, [p])
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
        opt.clear_grad()
    return p.detach().numpy(), opt


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_update_matches_reference_and_torch_optim(name):
    ours, theirs = OPTIMIZERS[name]
    got, _ = _run_port(ours)
    np.testing.assert_allclose(got, _run_jax(ours), rtol=1e-6, atol=1e-7)
    t = torch.tensor(_W0.copy(), requires_grad=True)
    opt = theirs([t])
    for g in _GRADS:
        t.grad = torch.tensor(g)
        opt.step()
        opt.zero_grad()
    np.testing.assert_allclose(got, t.detach().numpy(), atol=1e-6)


def test_adam_moments_are_float32_for_bfloat16_params():
    p = torch.nn.Parameter(torch.tensor(_W0, dtype=torch.bfloat16))
    opt = ptt.optimizer.AdamW(learning_rate=1e-2, parameters=[p])
    p.grad = torch.tensor(_GRADS[0], dtype=torch.bfloat16)
    opt.step()
    slots = opt._slots[id(p)]
    assert p.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in slots.values())


def test_optimizer_state_dict_round_trip_and_lr():
    sched = ptt.optimizer.lr.StepDecay(0.5, step_size=2, gamma=0.5)
    _, opt = _run_port(lambda m, ps: m.Adam(learning_rate=sched,
                                            parameters=ps), _GRADS[:3])
    sd = opt.state_dict()
    assert sd["step_count"] == 3 and set(sd) == {
        "step_count", "0__moment1", "0__moment2", "LR_Scheduler"}
    p = torch.nn.Parameter(torch.zeros(5, 3))
    fresh = ptt.optimizer.Adam(
        learning_rate=ptt.optimizer.lr.StepDecay(0.5, step_size=2,
                                                 gamma=0.5), parameters=[p])
    sched.step()
    sd = opt.state_dict()
    fresh.set_state_dict(sd)
    assert fresh._step_count == 3 and fresh.get_lr() == sched()
    assert torch.equal(fresh._slots[id(p)]["moment2"], sd["0__moment2"])
    with pytest.raises(RuntimeError):
        fresh.set_lr(0.1)
    plain = ptt.optimizer.SGD(learning_rate=0.3, parameters=[p])
    plain.set_lr(0.2)
    assert plain.get_lr() == 0.2


@pytest.mark.parametrize("name", sorted(set(OPTIMIZERS) - {"sgd"}))
def test_state_dict_is_a_snapshot(name):
    """A state_dict() taken before a step keeps its moments through the
    step (the reference's state arrays are immutable; the port's kernel
    updates the slots in place, so state_dict() hands out copies)."""
    ours, _ = OPTIMIZERS[name]
    _, opt = _run_port(ours, _GRADS[:2])
    saved = opt.state_dict()
    frozen = {k: v.clone() for k, v in saved.items()
              if isinstance(v, torch.Tensor)}
    p = opt._parameter_list[0]
    p.grad = torch.tensor(_GRADS[2])
    opt.step()
    for k, v in frozen.items():
        assert torch.equal(saved[k], v), k
        assert not torch.equal(opt.state_dict()[k], v), k


def test_optimizer_with_global_norm_clip_matches_reference():
    def factory(m, ps):
        clip = (paddle.nn.ClipGradByGlobalNorm if m is paddle.optimizer
                else tnn.ClipGradByGlobalNorm)(0.5)
        return m.Adam(learning_rate=1e-2, parameters=ps, grad_clip=clip)

    got, _ = _run_port(factory)
    np.testing.assert_allclose(got, _run_jax(factory), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_grad_clips_match_reference(clip):
    rs = np.random.RandomState(7)
    grads = [(rs.randn(4, 3) * 2).astype(np.float32),
             (rs.randn(6) * 0.1).astype(np.float32)]
    make = {"value": lambda m: m.ClipGradByValue(0.5),
            "norm": lambda m: m.ClipGradByNorm(1.0),
            "global_norm": lambda m: m.ClipGradByGlobalNorm(1.5)}[clip]
    ref = make(paddle.nn)([(None, paddle.to_tensor(g)) for g in grads])
    got = make(tnn)([(None, torch.tensor(g)) for g in grads])
    for (_, r), (_, g) in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r.numpy()),
                                   rtol=1e-6, atol=1e-7)


def test_clip_grad_norm_matches_reference():
    rs = np.random.RandomState(8)
    grads = [(rs.randn(4, 3) * 2).astype(np.float32),
             rs.randn(5).astype(np.float32)]
    jps = [paddle.to_tensor(np.zeros_like(g), stop_gradient=False)
           for g in grads]
    tps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for jp, tp, g in zip(jps, tps, grads):
        jp.grad = paddle.to_tensor(g)
        tp.grad = torch.tensor(g)
    ref = jax_clip_grad_norm_(jps, 1.0)
    got = tnn.clip_grad_norm_(tps, 1.0)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(),
                                   np.asarray(jp.grad.numpy()), rtol=1e-6)


SCHEDULERS = {
    "noam": lambda m: m.NoamDecay(64, 10, learning_rate=0.5),
    "piecewise": lambda m: m.PiecewiseDecay([5, 11], [0.5, 0.1, 0.01]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "inverse_time": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "polynomial": lambda m: m.PolynomialDecay(0.5, decay_steps=10),
    "polynomial_cycle": lambda m: m.PolynomialDecay(0.5, decay_steps=7,
                                                    cycle=True),
    "linear_warmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.5, T_max=15), 5, 0.0, 0.5),
    "exponential": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
    "multistep": lambda m: m.MultiStepDecay(0.5, [5, 11, 17], gamma=0.2),
    "step": lambda m: m.StepDecay(0.5, step_size=7, gamma=0.3),
    "lambda": lambda m: m.LambdaDecay(0.5, lr_lambda=lambda e: 1 / (1 + e)),
    "cosine": lambda m: m.CosineAnnealingDecay(0.5, T_max=20),
    "one_cycle": lambda m: m.OneCycleLR(0.5, total_steps=20),
    "cyclic": lambda m: m.CyclicLR(0.1, 0.5, step_size_up=4,
                                   mode="triangular2"),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_scheduler_curve_matches_reference(name):
    def curve(sched):
        out = []
        for _ in range(25):
            out.append(sched())
            sched.step()
        return out

    got = curve(SCHEDULERS[name](ptt.optimizer.lr))
    assert got == curve(SCHEDULERS[name](paddle.optimizer.lr))


def test_reduce_on_plateau_matches_reference_and_torch():
    losses = [1.0, 0.9, 0.85, 0.85, 0.85, 0.85, 0.84, 0.84, 0.84, 0.84,
              0.84, 0.84, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5]
    ours = ptt.optimizer.lr.ReduceOnPlateau(0.5, factor=0.1, patience=3)
    ref = paddle.optimizer.lr.ReduceOnPlateau(0.5, factor=0.1, patience=3)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=0.5)
    ts = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, factor=0.1,
                                                    patience=3)
    for lv in losses:
        ours.step(metrics=lv)
        ref.step(metrics=lv)
        ts.step(lv)
        assert ours() == ref()
        np.testing.assert_allclose(ours(), opt.param_groups[0]["lr"],
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# the DataLoader subset
# ---------------------------------------------------------------------------
def test_dataloader_batches_collate_and_drop_last():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    y = np.arange(5)
    ds = ptt.io.TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    batches = list(ptt.io.DataLoader(ds, batch_size=2))
    assert len(batches) == 3 and batches[-1][0].shape == (1, 2)
    assert torch.equal(batches[0][1], torch.tensor([0, 1]))
    assert len(ptt.io.DataLoader(ds, batch_size=2, drop_last=True)) == 2
    coll = ptt.io.default_collate_fn([(np.ones(2), 1, 0.5),
                                      (np.zeros(2), 2, 1.5)])
    assert coll[0].shape == (2, 2) and coll[1].dtype == torch.int64
    assert coll[2].dtype == torch.float32
    with pytest.raises(NotImplementedError):
        ptt.io.DataLoader(ds, num_workers=2)


def test_random_sampler_follows_its_generator():
    ds = ptt.io.TensorDataset([torch.arange(12)])

    def order(gen_seed):
        g = torch.Generator().manual_seed(gen_seed)
        return [b[0].tolist() for b in ptt.io.DataLoader(
            ds, batch_size=5, shuffle=True, generator=g)]

    assert order(1) == order(1) != order(2)
    assert sorted(sum(order(1), [])) == list(range(12))
    ptt.seed(4)
    first = list(ptt.io.RandomSampler(ds))
    ptt.seed(4)
    assert list(ptt.io.RandomSampler(ds)) == first
    sampler = ptt.io.RandomSampler(ds, generator=torch.Generator())
    assert list(sampler) != list(sampler)        # epochs continue the stream
    assert list(ptt.io.SequenceSampler(ds)) == list(range(12))
