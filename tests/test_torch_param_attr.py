"""Parameter attributes, default initialisers, regularizers and the
optimizer's state keys of the port against the JAX package, on the CPU.

- ``ParamAttr``'s fields reach the parameter as they do in the reference
  (``name``, ``optimize_attr``, ``regularizer``, ``need_clip``,
  ``trainable``), and survive a cast;
- parameter names follow the reference's ``param_<n>`` counter: both
  packages, each from a fresh counter (the fixture resets both; the
  reference's module-level ``_name_counters`` is monkeypatched here, in
  the test only), name a small BERT's parameters alike;
- the default weight initialiser is XavierUniform (every value within
  sqrt(6 / (fan_in + fan_out)), variance limit^2 / 3 within 1.5 %: the
  sample variance of 131,072 draws has a standard error of 0.25 % of it,
  so 1.5 % is six of them) and ``Embedding``'s Normal(0, 1) (standard
  deviation within 0.02 of 1, seven standard errors at 64,000 draws), in
  both packages; the parent's Normal(0, 0.02) fails both;
- ``need_clip=False`` keeps a gradient out of each clip class, as in the
  reference;
- ``L1Decay``/``L2Decay`` as ``weight_decay`` and per-parameter learning
  rates give the reference's eager steps (rtol 1e-6, atol 1e-7: float32
  rounding of the same ops); AdamW refuses ``L1Decay`` with the
  reference's ``TypeError``;
- ``Optimizer.state_dict`` keys slots ``f"{name}__{slot}"`` as the
  reference does, and each side's saved state loads into the other.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.layer_base as jlayer_base
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.layer_base as tlayer_base
from paddle_tpu_torch import nn as tnn

RTOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture
def fresh_names(monkeypatch):
    """Both packages' parameter-name counters from zero."""
    monkeypatch.setattr(jlayer_base, "_name_counters", {})
    monkeypatch.setattr(tlayer_base, "_name_counters", {})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def test_param_attr_fields_reach_the_parameter():
    for pkg, ns in ((ptt, tnn), (paddle, paddle.nn)):
        reg = pkg.regularizer.L2Decay(0.1)
        lin = ns.Linear(4, 3, weight_attr=pkg.ParamAttr(
            name="fc_w", learning_rate=0.5, regularizer=reg,
            need_clip=False, trainable=False))
        w, b = lin.weight, lin.bias
        assert w.name == "fc_w" and w.optimize_attr == {"learning_rate": 0.5}
        assert w.regularizer is reg and w.need_clip is False
        assert b.optimize_attr == {"learning_rate": 1.0}
        assert b.regularizer is None and b.need_clip is True
    port = tnn.Linear(4, 3, weight_attr=ptt.ParamAttr(trainable=False))
    assert port.weight.requires_grad is False
    assert tnn.Linear(2, 2, weight_attr="named").weight.name == "named"


def test_attributes_survive_a_cast():
    lin = tnn.Linear(4, 3, weight_attr=ptt.ParamAttr(
        name="w", learning_rate=0.3, need_clip=False))
    w = lin.weight
    lin.astype("bfloat16")
    lin.to(dtype=torch.float32)
    assert lin.weight is w and w.dtype == torch.float32
    assert w.name == "w" and w.optimize_attr == {"learning_rate": 0.3}
    assert w.need_clip is False
    import copy
    twin = copy.deepcopy(lin)
    assert twin.weight.name == "w" and twin.weight.need_clip is False


def test_names_follow_the_reference_scheme(fresh_names):
    from paddle_tpu.models.bert import BertConfig as JBertConfig
    from paddle_tpu.models.bert import BertForPretraining as JBert
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    cfg = dict(vocab_size=50, hidden_size=16, num_layers=2, num_heads=2,
               intermediate_size=32, max_position_embeddings=16)
    ours = BertForPretraining(BertConfig(**cfg), device="cpu")
    ref = JBert(JBertConfig(**cfg))
    got = {n: p.name for n, p in ours.named_parameters()}
    want = {n: p.name for n, p in ref.named_parameters()}
    assert got == want
    assert sorted(got.values()) == sorted(
        f"param_{i}" for i in range(len(got)))


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_default_initialisers_are_the_references(pkg):
    ns = tnn if pkg == "port" else paddle.nn
    (ptt if pkg == "port" else paddle).seed(0)
    w = _np(ns.Linear(256, 512).weight).astype(np.float64)
    limit = np.sqrt(6.0 / (256 + 512))
    assert np.abs(w).max() <= limit
    assert abs(w.var() / (limit ** 2 / 3) - 1) < 0.015
    assert abs(w.mean()) < 6 * limit / np.sqrt(3 * w.size)
    assert (_np(ns.Linear(256, 512).bias) == 0).all()
    e = _np(ns.Embedding(1000, 64).weight).astype(np.float64)
    assert abs(e.std() - 1.0) < 0.02 and abs(e.mean()) < 0.02


def _grads(shapes, step):
    rs = np.random.RandomState(50 + step)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("clip", ["value", "norm", "global"])
def test_need_clip_false_is_honoured_by_the_clips(clip):
    make = {"value": lambda m: m.ClipGradByValue(0.1),
            "norm": lambda m: m.ClipGradByNorm(0.1),
            "global": lambda m: m.ClipGradByGlobalNorm(0.1)}[clip]
    g = _grads([(4, 3), (3,)], 0)
    ours = tnn.Linear(4, 3, weight_attr=ptt.ParamAttr(need_clip=False))
    ref = paddle.nn.Linear(4, 3, weight_attr=paddle.ParamAttr(
        need_clip=False))
    got = make(tnn)([(p, torch.from_numpy(x)) for p, x in
                     zip((ours.weight, ours.bias), g)])
    want = make(paddle.nn)([(p, paddle.to_tensor(x)) for p, x in
                            zip((ref.weight, ref.bias), g)])
    np.testing.assert_array_equal(got[0][1].numpy(), g[0])
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), **RTOL)


W_SHAPES = [(5, 3), (3,)]


def _run(pkg, make, steps=3, attrs=None):
    """``steps`` eager steps of ``make(optimizer module, params)`` on a
    Linear(5, 3) of fixed weights; returns the parameters and the
    optimizer."""
    rs = np.random.RandomState(7)
    w0 = [rs.randn(*s).astype(np.float32) for s in W_SHAPES]
    attrs = attrs or [None, None]
    if pkg == "port":
        lin = tnn.Linear(5, 3, weight_attr=attrs[0], bias_attr=attrs[1])
        ps = [lin.weight, lin.bias]
        with torch.no_grad():
            for p, v in zip(ps, w0):
                p.copy_(torch.from_numpy(v))
        opt = make(ptt, ps)
        for i in range(steps):
            for p, g in zip(ps, _grads(W_SHAPES, i)):
                p.grad = torch.from_numpy(g)
            opt.step()
            opt.clear_grad()
        return [p.detach().numpy() for p in ps], opt
    lin = paddle.nn.Linear(5, 3, weight_attr=attrs[0], bias_attr=attrs[1])
    ps = [lin.weight, lin.bias]
    for p, v in zip(ps, w0):
        p.set_value(v)
    opt = make(paddle, ps)
    for i in range(steps):
        for p, g in zip(ps, _grads(W_SHAPES, i)):
            p.grad = paddle.to_tensor(g)
        opt.step()
        opt.clear_grad()
    return [_np(p) for p in ps], opt


REGULARIZED = {
    "sgd_l1": lambda m, ps: m.optimizer.SGD(
        0.1, parameters=ps, weight_decay=m.regularizer.L1Decay(0.05)),
    "sgd_l2": lambda m, ps: m.optimizer.SGD(
        0.1, parameters=ps, weight_decay=m.regularizer.L2Decay(0.05)),
    "momentum_l1": lambda m, ps: m.optimizer.Momentum(
        0.1, parameters=ps,
        weight_decay=m.regularizer.L1DecayRegularizer(0.05)),
    "adam_l1": lambda m, ps: m.optimizer.Adam(
        0.1, parameters=ps, weight_decay=m.regularizer.L1Decay(0.05)),
    "adam_l2": lambda m, ps: m.optimizer.Adam(
        0.1, parameters=ps, weight_decay=m.regularizer.L2Decay(0.05)),
    "adamw_l2": lambda m, ps: m.optimizer.AdamW(
        0.1, parameters=ps, weight_decay=m.regularizer.L2Decay(0.05)),
    "adagrad_l1": lambda m, ps: m.optimizer.Adagrad(
        0.1, parameters=ps, weight_decay=m.regularizer.L1Decay(0.05)),
}


@pytest.mark.parametrize("name", sorted(REGULARIZED))
def test_regularizers_as_weight_decay_match_the_reference(name):
    got, _ = _run("port", REGULARIZED[name])
    want, _ = _run("reference", REGULARIZED[name])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **RTOL)


def test_adamw_refuses_l1decay_like_the_reference():
    for m in (ptt, paddle):
        with pytest.raises(TypeError, match="DECOUPLED"):
            m.optimizer.AdamW(weight_decay=m.regularizer.L1Decay(0.1))


@pytest.mark.parametrize("opt", ["sgd", "adam", "lamb"])
def test_per_parameter_learning_rates_match_the_reference(opt):
    make = {"sgd": lambda m, ps: m.optimizer.SGD(0.1, parameters=ps),
            "adam": lambda m, ps: m.optimizer.Adam(0.1, parameters=ps),
            "lamb": lambda m, ps: m.optimizer.Lamb(0.1, parameters=ps)}[opt]
    got, _ = _run("port", make, attrs=[
        ptt.ParamAttr(learning_rate=0.25), ptt.ParamAttr(learning_rate=3.0)])
    want, _ = _run("reference", make, attrs=[
        paddle.ParamAttr(learning_rate=0.25),
        paddle.ParamAttr(learning_rate=3.0)])
    plain, _ = _run("port", make)
    for a, b, c in zip(got, want, plain):
        np.testing.assert_allclose(a, b, **RTOL)
        assert not np.array_equal(a, c)


def test_adamw_apply_decay_param_fun_matches_the_reference(fresh_names):
    """The eager step decays the parameters whose name the function
    accepts (param_0, the weight), steps the rest without decay, and
    counts the step once."""
    def make(m, ps):
        return m.optimizer.AdamW(0.1, parameters=ps, weight_decay=0.2,
                                 apply_decay_param_fun=lambda n: n ==
                                 "param_0")
    got, opt = _run("port", make)
    want, ref = _run("reference", make)
    assert opt._step_count == ref._step_count == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **RTOL)


@pytest.mark.parametrize("make", [
    lambda m, ps: m.optimizer.Adam(0.1, parameters=ps),
    lambda m, ps: m.optimizer.RMSProp(0.1, parameters=ps, centered=True),
    lambda m, ps: m.optimizer.Lamb(0.1, parameters=ps)],
    ids=["adam", "rmsprop", "lamb"])
def test_state_dict_keys_and_cross_loading(fresh_names, make, monkeypatch):
    """Both sides key the slots ``param_<n>__<slot>`` from a fresh
    counter; the reference's saved state loads into the port and gives its
    next step, and the port's loads into the reference."""
    _, opt = _run("port", make, steps=2)
    monkeypatch.setattr(jlayer_base, "_name_counters", {})
    _, ref = _run("reference", make, steps=2)
    ours, theirs = opt.state_dict(), ref.state_dict()
    assert sorted(ours) == sorted(theirs)
    assert any(k.startswith("param_0__") for k in ours)
    for k, v in ours.items():
        if k != "step_count":
            np.testing.assert_allclose(v.numpy(), _np(theirs[k]), **RTOL)
    # the reference's state into a port optimizer over fresh parameters of
    # the same names, and the port's into the reference's
    monkeypatch.setattr(tlayer_base, "_name_counters", {})
    monkeypatch.setattr(jlayer_base, "_name_counters", {})
    _, port2 = _run("port", make, steps=0)
    _, ref2 = _run("reference", make, steps=0)
    port2.set_state_dict({k: v if k == "step_count" else _np(v)
                          for k, v in theirs.items()})
    ref2.set_state_dict({k: v if k == "step_count" else v.numpy()
                         for k, v in ours.items()})
    assert port2._step_count == ref2._step_count == 2
    for k, v in port2.state_dict().items():
        if k != "step_count":
            np.testing.assert_allclose(v.numpy(), _np(theirs[k]), **RTOL)
    for k, v in ref2.state_dict().items():
        if k != "step_count":
            np.testing.assert_allclose(_np(v), ours[k].numpy(), **RTOL)
