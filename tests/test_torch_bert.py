"""The port's BERT/ERNIE pretraining slice against the JAX package's, on
the CPU.

A tiny BertForPretraining (tests/test_bert_hf_parity.py's sizes: vocab
120, hidden 32, 2 layers, 4 heads, intermediate 64, S = 16, dropout 0)
is built by the JAX package and its weights carried over by name
(``load_numpy_state``: the tied word embedding and ``mlm_bias``
included).  Held against the reference, with the same inputs, at rtol
1e-4 / atol 1e-6 (test_torch_train.py's gradient tolerance):
- ``loss(ids, mlm_labels, nsp_labels, token_type_ids)`` and EVERY
  parameter gradient vs ``jax.value_and_grad`` of ``functional_call(...,
  method="loss")``;
- a 5-step AdamW trajectory (losses and final parameters) vs
  ``opt.apply_pytree``, and a resume from JAX's step-3 optimizer state;
- the masked ``BertModel.forward`` / ``BertForPretraining.forward`` with
  a [B, 1, 1, S] bool padding mask, and ``ErnieModel`` with four segment
  types;
- ``TransformerEncoderLayer`` in its post-LN / pre-LN, GeLU / ReLU, with
  and without biases forms.
``Model.fit`` on BertForPretraining with [ids, token_type_ids, mask]
inputs and [mlm_labels, nsp_labels] labels gives the losses of the same
steps run by hand.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBertForPretraining
from paddle_tpu.models.bert import ErnieModel as JErnieModel
from paddle_tpu.nn.layer.transformer import \
    TransformerEncoderLayer as JEncoderLayer
from paddle_tpu.nn.layer_base import functional_call, state_pytrees
from paddle_tpu.ops import fused as jfused
from paddle_tpu.tensor import Tensor, unwrap
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     ErnieModel, load_numpy_optimizer_state,
                                     load_numpy_state)
from paddle_tpu_torch.nn import LayerList, TransformerEncoder, \
    TransformerEncoderLayer
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import fused

CFG = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, dropout=0.0)
TOL = dict(rtol=1e-4, atol=1e-6)
LR, WD = 1e-3, 0.01
B, S = 2, 16
_RS = np.random.RandomState(1)
IDS = _RS.randint(0, 120, (B, S))
TT = _RS.randint(0, 2, (B, S))
MLM = np.where(_RS.rand(B, S) < 0.3, _RS.randint(0, 120, (B, S)), -100)
NSP = _RS.randint(0, 2, (B,))
LENS = np.array([S, 9])
MASK = (np.arange(S)[None, :] < LENS[:, None])[:, None, None, :]
# The key projection's bias has an exactly-zero gradient (softmax is
# shift-invariant over a query's keys), so both frameworks compute it as
# rounding noise of about 1e-8 here, which Adam normalises to a step of up
# to lr in a direction the noise picks.  Those entries are held within
# two such steps per AdamW step of the reference; every other at TOL.
KEY_BIAS_ATOL = 2 * LR


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(5)
    m = JBertForPretraining(JBertConfig(**CFG))
    m.train()
    return m


@pytest.fixture(scope="module")
def state0(jax_model):
    return _np(state_pytrees(jax_model)[0])


def _port_model(state):
    m = BertForPretraining(BertConfig(**CFG), device="cpu")
    load_numpy_state(m, state)
    return m.train()


def _loss_args(lib):
    if lib == "jax":
        return tuple(paddle.to_tensor(a, "int64")
                     for a in (IDS, MLM, NSP, TT))
    return tuple(torch.from_numpy(a) for a in (IDS, MLM, NSP, TT))


def _jax_loss_and_grad(jax_model, params):
    buffers = state_pytrees(jax_model)[1]

    def loss_fn(p):
        out, _ = functional_call(jax_model, p, _loss_args("jax"),
                                 buffers=buffers, method="loss")
        return unwrap(out)

    return jax.value_and_grad(loss_fn)(params)


@pytest.fixture(scope="module")
def jax_trajectory(jax_model, state0):
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


def test_weights_carry_over_exactly(state0):
    """Every parameter, the tied word embedding and mlm_bias included, is
    the reference's, bit for bit; the tie holds (one tensor)."""
    model = _port_model(state0)
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    assert set(got) == set(state0)
    for name, ref in state0.items():
        np.testing.assert_array_equal(got[name], ref, err_msg=name)
    assert "mlm_bias" in got and len(list(model.parameters())) == len(got)


def test_loss_and_every_gradient_match_jax(jax_model, state0):
    params = {k: jnp.asarray(v) for k, v in state0.items()}
    ref_loss, ref_grads = _jax_loss_and_grad(jax_model, params)
    model = _port_model(state0)
    loss = model.loss(*_loss_args("torch"))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(ref_loss), **TOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, ref in ref_grads.items():
        assert grads[name] is not None, name
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(ref),
                                   err_msg=name, **TOL)


def _port_adamw_steps(model, n, opt=None):
    opt = opt or ptt.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                     parameters=model.parameters())
    losses = []
    for _ in range(n):
        loss = model.loss(*_loss_args("torch"))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses


def _assert_params(model, ref, steps):
    for name, p in model.named_parameters():
        tol = dict(atol=KEY_BIAS_ATOL * steps, rtol=0) \
            if name.endswith("k_proj.bias") else TOL
        np.testing.assert_allclose(p.detach().numpy(), ref[name],
                                   err_msg=name, **tol)


def test_adamw_trajectory_matches_apply_pytree(state0, jax_trajectory):
    ref_losses, ref_params, _ = jax_trajectory
    model = _port_model(state0)
    losses = _port_adamw_steps(model, 5)
    np.testing.assert_allclose(losses, ref_losses, **TOL)
    assert losses[-1] < losses[0]
    _assert_params(model, ref_params[-1], 5)


def test_resume_from_jax_optimizer_state(jax_trajectory):
    ref_losses, ref_params, ref_state = jax_trajectory
    model = _port_model(ref_params[2])
    opt = ptt.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                              parameters=model.parameters())
    load_numpy_optimizer_state(opt, model, ref_state[2], step_count=3)
    losses = _port_adamw_steps(model, 2, opt)
    np.testing.assert_allclose(losses, ref_losses[3:], **TOL)
    _assert_params(model, ref_params[4], 2)


def test_masked_forward_matches_jax(jax_model, state0):
    """BertForPretraining.forward and BertModel.forward with a [B, 1, 1, S]
    bool padding mask (the reference's MHA shape) and segment ids, and
    without segment ids (the type-0 row is added)."""
    model = _port_model(state0).eval()
    jax_model.eval()
    try:
        for tt in (TT, None):
            jargs = [paddle.to_tensor(IDS, "int64"),
                     None if tt is None else paddle.to_tensor(tt, "int64"),
                     paddle.to_tensor(MASK)]
            targs = [torch.from_numpy(IDS),
                     None if tt is None else torch.from_numpy(tt),
                     torch.from_numpy(MASK)]
            ref = jax_model(*jargs)
            with torch.no_grad():
                got = model(*targs)
                seq, pooled = model.bert(*targs)
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g.numpy(), np.asarray(r.numpy()),
                                           **TOL)
            ref_seq, ref_pooled = jax_model.bert(*jargs)
            np.testing.assert_allclose(seq.numpy(),
                                       np.asarray(ref_seq.numpy()), **TOL)
            np.testing.assert_allclose(pooled.numpy(),
                                       np.asarray(ref_pooled.numpy()), **TOL)
    finally:
        jax_model.train()


def test_ernie_model_matches_jax():
    paddle.seed(6)
    jm = JErnieModel(num_layers=1, hidden_size=32, num_heads=4,
                     intermediate_size=64, vocab_size=50, dropout=0.0)
    jm.eval()
    m = ErnieModel(num_layers=1, hidden_size=32, num_heads=4,
                   intermediate_size=64, vocab_size=50, dropout=0.0,
                   device="cpu").eval()
    assert m.cfg.type_vocab_size == 4
    load_numpy_state(m, _np(state_pytrees(jm)[0]))
    rs = np.random.RandomState(2)
    ids, tt = rs.randint(0, 50, (2, 12)), rs.randint(0, 4, (2, 12))
    mask = (np.arange(12)[None, :] < np.array([12, 5])[:, None])
    ref = jm(paddle.to_tensor(ids, "int64"), paddle.to_tensor(tt, "int64"),
             paddle.to_tensor(mask[:, None, None, :]))
    with torch.no_grad():
        got = m(torch.from_numpy(ids), torch.from_numpy(tt),
                torch.from_numpy(mask)[:, None, None, :])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r.numpy()), **TOL)


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("activation,bias_attr", [("gelu", None),
                                                  ("gelu", False),
                                                  ("relu", None)])
def test_encoder_layer_forms_match_jax(normalize_before, activation,
                                       bias_attr):
    """Post-LN and pre-LN, GeLU (the bias+GeLU kernel, or with
    ``bias_attr=False`` the plain GeLU of the matmul) and ReLU, with an
    additive [B, 1, S, S] mask; output and input gradient."""
    paddle.seed(7)
    jl = JEncoderLayer(32, 4, 64, dropout=0.0, activation=activation,
                       normalize_before=normalize_before,
                       bias_attr=bias_attr)
    jl.train()
    layer = TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                    activation=activation,
                                    normalize_before=normalize_before,
                                    bias_attr=bias_attr)
    params = _np(state_pytrees(jl)[0])
    load_numpy_state(layer, params)
    rs = np.random.RandomState(3)
    x = rs.randn(2, 7, 32).astype(np.float32)
    m = rs.randn(2, 1, 7, 7).astype(np.float32)
    dy = rs.randn(2, 7, 32).astype(np.float32)

    def jfn(xx):
        out, _ = functional_call(jl, {k: jnp.asarray(v)
                                      for k, v in params.items()},
                                 (Tensor(xx), Tensor(jnp.asarray(m))))
        return unwrap(out)

    ref, vjp = jax.vjp(jfn, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = layer(tx, torch.from_numpy(m))
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(dy))[0]),
                               rtol=1e-4, atol=1e-5)


def test_linear_bias_gelu_without_bias_matches_jax():
    """The slice-2 fault: ``linear_bias_gelu(x, w, None)`` raised; it is
    the reference's plain erf GeLU of the matmul."""
    rs = np.random.RandomState(4)
    x = rs.randn(3, 5, 16).astype(np.float32)
    w = (0.3 * rs.randn(16, 24)).astype(np.float32)
    ref = jfused.linear_bias_gelu(Tensor(jnp.asarray(x)),
                                  Tensor(jnp.asarray(w)), None,
                                  training=False)
    got = fused.linear_bias_gelu(torch.from_numpy(x), torch.from_numpy(w),
                                 None, training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.numpy()),
                               rtol=1e-5, atol=1e-5)


def test_encoder_stack_names_and_fresh_layers():
    """LayerList names its sublayers 0, 1, ... (the reference's state-dict
    names); a stack re-instantiates each layer from its constructor
    arguments, so the layers start from different weights."""
    enc = TransformerEncoder(TransformerEncoderLayer(16, 2, 32), 3)
    assert isinstance(enc.layers, LayerList) and len(enc.layers) == 3
    names = list(enc.state_dict())
    assert names[0] == "layers.0.self_attn.q_proj.weight"
    assert "layers.2.norm2.bias" in names
    w = [layer.linear1.weight for layer in enc.layers]
    assert not torch.equal(w[0], w[1]) and enc.layers[-1] is enc.layers[2]


def _fit_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels):
    """loss() on the logits, through F.cross_entropy (bench.py's BERT
    Model.fit loss): MLM summed over labelled tokens over their count,
    plus the mean NSP loss."""
    mlm = F.cross_entropy(mlm_logits, mlm_labels, reduction="none")
    denom = (mlm_labels != -100).float().sum().clamp(min=1.0)
    return mlm.sum() / denom + F.cross_entropy(nsp_logits, nsp_labels)


def test_model_fit_with_masked_batches(state0):
    """Model.fit with [ids, token_type_ids, mask] inputs and [mlm, nsp]
    labels (shuffle off) gives the losses of the same AdamW steps run by
    hand; without a mask the loss on the logits is loss()."""
    ids = torch.from_numpy(np.concatenate([IDS, IDS[::-1]]))
    tt = torch.from_numpy(np.concatenate([TT, TT[::-1]]))
    mask = torch.from_numpy(np.concatenate([MASK, MASK[::-1]]))
    mlm = torch.from_numpy(np.concatenate([MLM, MLM[::-1]]))
    nsp = torch.from_numpy(np.concatenate([NSP, NSP[::-1]]))
    net = _port_model(state0)
    np.testing.assert_allclose(
        _fit_loss(*net(*_loss_args("torch")[::3]), *_loss_args("torch")[1:3])
        .item(), net.loss(*_loss_args("torch")).item(), rtol=1e-6)
    opt = ptt.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                              parameters=net.parameters())
    model = ptt.Model(net, labels=["mlm", "nsp"]).prepare(opt, _fit_loss)
    hist = model.fit(ptt.io.TensorDataset([ids, tt, mask, mlm, nsp]),
                     batch_size=2, epochs=1, shuffle=False, verbose=0)
    by_hand = _port_model(state0)
    opt = ptt.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                              parameters=by_hand.parameters())
    losses = []
    for i in (0, 2):
        sl = slice(i, i + 2)
        loss = _fit_loss(*by_hand(ids[sl], tt[sl], mask[sl]), mlm[sl],
                         nsp[sl])
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    np.testing.assert_allclose(hist["step_loss"], losses, rtol=1e-6)
