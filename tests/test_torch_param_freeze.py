"""Faults C10-C13 of the port against the JAX package, on the CPU.

- C10: a parameter frozen the reference's ways (``stop_gradient = True``,
  ``trainable = False``) stays bitwise as it was through one
  ``opt.step()`` and one ``Model.fit`` step while the others move as the
  reference's do (float32, 1e-5); ``set_value`` and
  ``nn.Parameter(value, dtype, name, trainable)`` build what the
  reference's build; the training engine captures its step again when
  the trainable set changed since the capture (its graph path through a
  CPU stand-in, as tests/test_torch_train_graph.py drives it);
- C11: ``LayerList.append``, ``insert`` (which renumbers), ``extend`` and
  ``__setitem__`` give the reference's ``state_dict`` names, and
  ``load_numpy_state`` carries its weights;
- C12: ``clip_grad_norm_(parameters, max_norm, norm_type,
  error_if_nonfinite)`` in the positional and keyword forms scales the
  gradients as the reference's does (1e-6); ``relu``, ``gelu``,
  ``softmax``, ``log_softmax``, ``tanh`` and ``cross_entropy`` import
  from the reference's submodule paths and compute what the reference's
  do (1e-6);
- C13: both packages' ``GenerationMetrics`` expose the same ``# TYPE``
  names, the port's snapshot keys hold the reference's, and the
  generation engine's ``compile_count`` is 0 on the CPU (1 on the card:
  tests/test_torch_cuda.py).

Float32 throughout; 1e-5 where an optimizer step runs (the two packages'
libraries round a square root or a sum in their own order), 1e-6 for one
function.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.hapi.engine import TrainEngine
from paddle_tpu_torch.models import load_numpy_state

from test_torch_train_graph import _stand_in

RS = np.random.RandomState(0)
X = RS.randn(6, 4).astype(np.float32)
Y = RS.randn(6, 3).astype(np.float32)


def _nets():
    """The same two-layer net in both packages, the port's holding the
    reference's weights."""
    j = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 3))
    t = tnn.Sequential(tnn.Linear(4, 8), tnn.ReLU(), tnn.Linear(8, 3))
    load_numpy_state(t, {k: np.asarray(v.numpy())
                         for k, v in j.state_dict().items()})
    return j, t


def _freeze(p, way):
    if way == "stop_gradient":
        p.stop_gradient = True
    else:
        p.trainable = False


def _state(net):
    return {k: np.asarray(v.numpy() if not isinstance(v, torch.Tensor)
                          else v.detach().numpy()).copy()
            for k, v in net.state_dict().items()}


def _close(got, want, tol):
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= tol, k


@pytest.mark.parametrize("way", ["stop_gradient", "trainable"])
def test_a_frozen_parameter_stays_through_opt_step(way):
    j, t = _nets()
    _freeze(j[0].weight, way)
    _freeze(t[0].weight, way)
    assert t[0].weight.requires_grad is False
    assert t[0].weight.stop_gradient is True and not t[0].weight.trainable
    before = _state(t)
    jopt = paddle.optimizer.AdamW(learning_rate=0.1, weight_decay=0.01,
                                  parameters=j.parameters())
    topt = ptt.optimizer.AdamW(learning_rate=0.1, weight_decay=0.01,
                               parameters=t.parameters())
    jl = (j(paddle.to_tensor(X)) - paddle.to_tensor(Y)).square().mean()
    jl.backward()
    jopt.step()
    tl = (t(torch.from_numpy(X)) - torch.from_numpy(Y)).square().mean()
    tl.backward()
    topt.step()
    got, want = _state(t), _state(j)
    assert np.array_equal(got["0.weight"], before["0.weight"])
    assert np.array_equal(want["0.weight"], before["0.weight"])
    assert not np.array_equal(got["2.weight"], before["2.weight"])
    _close(got, want, 1e-5)


@pytest.mark.parametrize("way", ["stop_gradient", "trainable"])
def test_a_frozen_parameter_stays_through_a_fit_step(way):
    j, t = _nets()
    _freeze(j[0].weight, way)
    _freeze(t[0].weight, way)
    before = _state(t)
    jm = paddle.Model(j).prepare(
        paddle.optimizer.Adam(learning_rate=0.1, parameters=j.parameters()),
        jnn.MSELoss())
    tm = ptt.Model(t).prepare(
        ptt.optimizer.Adam(learning_rate=0.1, parameters=t.parameters()),
        tnn.MSELoss())
    jm.fit(paddle.io.TensorDataset([paddle.to_tensor(X),
                                    paddle.to_tensor(Y)]),
           batch_size=6, epochs=1, verbose=0, shuffle=False)
    tm.fit(ptt.io.TensorDataset([torch.from_numpy(X), torch.from_numpy(Y)]),
           batch_size=6, epochs=1, verbose=0, shuffle=False)
    got, want = _state(t), _state(j)
    assert np.array_equal(got["0.weight"], before["0.weight"])
    assert np.array_equal(want["0.weight"], before["0.weight"])
    assert not np.array_equal(got["0.bias"], before["0.bias"])
    _close(got, want, 1e-5)


def test_a_freeze_between_fits_recaptures_the_step():
    """The engine's graph path (a CPU stand-in for the capture): a second
    ``fit`` replays the first's graph; a freeze before the third makes
    ``begin()`` drop it and capture again, and the frozen weight stays;
    a thaw captures again."""
    _, t = _nets()
    model = ptt.Model(t).prepare(
        ptt.optimizer.SGD(learning_rate=0.1, parameters=t.parameters()),
        tnn.MSELoss())
    engine = model._engine = _stand_in(TrainEngine(model))
    data = ptt.io.TensorDataset([torch.from_numpy(X), torch.from_numpy(Y)])

    def fit():
        model.fit(data, batch_size=3, epochs=1, verbose=0, shuffle=False)

    fit()
    fit()
    assert engine.captures == 1 and engine.replays == 3
    t[0].weight.stop_gradient = True
    frozen = t[0].weight.detach().clone()
    bias = t[0].bias.detach().clone()
    fit()
    assert engine.captures == 2
    assert torch.equal(t[0].weight, frozen)
    assert not torch.equal(t[0].bias, bias)
    t[0].weight.trainable = True
    fit()
    assert engine.captures == 3
    assert not torch.equal(t[0].weight, frozen)


def test_set_value_is_the_references():
    j, t = _nets()
    v = RS.randn(8, 4).astype(np.float32)
    j[0].weight.set_value(v)
    t[0].weight.set_value(v)
    assert np.array_equal(t[0].weight.detach().numpy(),
                          np.asarray(j[0].weight.numpy()))
    ptr = t[0].weight.data_ptr()
    t[0].weight.set_value(torch.from_numpy(v * 2).double())
    assert t[0].weight.data_ptr() == ptr      # in place
    assert t[0].weight.dtype == torch.float32
    assert np.array_equal(t[0].weight.detach().numpy(), v * 2)


@pytest.mark.parametrize("dtype,trainable", [(None, True),
                                             ("float32", False),
                                             ("bfloat16", True)])
def test_parameter_constructor_is_the_references(dtype, trainable):
    v = RS.randn(3, 2).astype(np.float32)
    j = jnn.Parameter(v, dtype=dtype, name="w_0", trainable=trainable)
    t = tnn.Parameter(v, dtype=dtype, name="w_0", trainable=trainable)
    assert isinstance(t, torch.nn.Parameter)
    assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    assert t.name == j.name == "w_0"
    assert t.trainable == j.trainable == trainable
    assert t.stop_gradient == j.stop_gradient == (not trainable)
    assert np.array_equal(t.detach().float().numpy(),
                          np.asarray(j.numpy()).astype(np.float32))
    # positional, the reference's order
    assert tnn.Parameter(v, "float32", "w_1", False).stop_gradient


# -- C11: LayerList -----------------------------------------------------------
def _built_list(nn, seed):
    paddle.seed(seed)
    torch.manual_seed(seed)
    lst = nn.LayerList([nn.Linear(2, 3)])
    lst.append(nn.Linear(3, 4))
    lst.insert(1, nn.Linear(5, 2))          # renumbers: 0, 1 (new), 2
    lst.extend([nn.Linear(4, 4), nn.Linear(4, 1)])
    lst[3] = nn.Linear(6, 6)
    return lst


def test_layer_list_methods_build_the_references_names():
    j, t = _built_list(jnn, 0), _built_list(tnn, 0)
    assert len(t) == len(j) == 5
    assert list(t.state_dict()) == list(j.state_dict())
    assert [tuple(p.shape) for p in t.parameters()] == \
        [tuple(p.shape) for p in j.parameters()]
    state = {k: np.asarray(v.numpy()) for k, v in j.state_dict().items()}
    load_numpy_state(t, state)
    for k, v in t.state_dict().items():
        assert np.array_equal(v.numpy(), state[k]), k
    assert t[1].weight.shape == (5, 2) and t[3].weight.shape == (6, 6)


# -- C12: clip_grad_norm_ and the functional submodules -----------------------
@pytest.mark.parametrize("form", ["positional", "keyword"])
def test_clip_grad_norm_takes_the_references_arguments(form):
    rs = np.random.RandomState(3)
    vals = [rs.randn(4, 3).astype(np.float32), rs.randn(3).astype(np.float32)]
    grads = [3 * rs.randn(*v.shape).astype(np.float32) for v in vals]
    jp = [jnn.Parameter(v) for v in vals]
    tp = [tnn.Parameter(v) for v in vals]
    for a, b, g in zip(jp, tp, grads):
        a.grad = paddle.to_tensor(g)
        b.grad = torch.from_numpy(g.copy())
    if form == "positional":
        jn = jclip.clip_grad_norm_(jp, 1.0, 2.0, False)
        tn = tnn.clip_grad_norm_(tp, 1.0, 2.0, False)
    else:
        kw = dict(max_norm=1.0, norm_type=2.0, error_if_nonfinite=False)
        jn = jclip.clip_grad_norm_(parameters=jp, **kw)
        tn = tnn.clip_grad_norm_(parameters=tp, **kw)
    assert abs(float(tn) - float(np.asarray(jn.numpy()))) <= 1e-6 * float(tn)
    for a, b in zip(jp, tp):
        assert np.abs(b.grad.numpy() - np.asarray(a.grad.numpy())).max() \
            <= 1e-6


@pytest.mark.parametrize("module,name,args", [
    ("activation", "relu", ()),
    ("activation", "gelu", ()),
    ("activation", "softmax", (-1,)),
    ("activation", "log_softmax", (-1,)),
    ("activation", "tanh", ()),
])
def test_activations_import_from_the_references_submodule(module, name,
                                                          args):
    jf = getattr(importlib.import_module(
        f"paddle_tpu.nn.functional.{module}"), name)
    tf = getattr(importlib.import_module(
        f"paddle_tpu_torch.nn.functional.{module}"), name)
    assert tf is getattr(ptt.nn.functional, name)
    x = np.random.RandomState(4).randn(3, 5).astype(np.float32)
    got = tf(torch.from_numpy(x), *args).numpy()
    want = np.asarray(jf(paddle.to_tensor(x), *args).numpy())
    assert np.abs(got - want).max() <= 1e-6


def test_cross_entropy_imports_from_the_references_loss_module():
    from paddle_tpu.nn.functional.loss import cross_entropy as jce
    from paddle_tpu_torch.nn.functional.loss import cross_entropy as tce

    rs = np.random.RandomState(5)
    logits = rs.randn(4, 7).astype(np.float32)
    labels = rs.randint(0, 7, (4,)).astype(np.int64)
    got = float(tce(torch.from_numpy(logits), torch.from_numpy(labels)))
    want = float(np.asarray(jce(paddle.to_tensor(logits),
                                paddle.to_tensor(labels)).numpy()))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    with pytest.raises(AttributeError):
        importlib.import_module("paddle_tpu_torch.nn.functional.loss").nope


# -- C13: compile_count ------------------------------------------------------
def _type_names(text):
    return sorted(line.split()[2] for line in text.splitlines()
                  if line.startswith("# TYPE"))


def test_generation_metrics_expose_the_references_names():
    from paddle_tpu.serving.metrics import GenerationMetrics as J
    from paddle_tpu_torch.serving.metrics import GenerationMetrics as T

    j, t = J(4, 16), T(4, 16)
    assert _type_names(t.prometheus_text()) == \
        _type_names(j.prometheus_text())
    assert set(t.snapshot()) >= set(j.snapshot())
    j.set_compile_count(3)
    t.set_compile_count(3)
    assert t.snapshot()["compile_count"] == j.snapshot()["compile_count"] \
        == 3
    assert "paddle_genserve_compile_count 3" in t.prometheus_text()


def test_generation_engine_compile_count_is_zero_on_the_cpu():
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import GenerationEngine

    model = GPTForCausalLM(GPTConfig(
        vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
        max_position_embeddings=32, dropout=0.0, attn_dropout=0.0),
        device="cpu").eval()
    eng = GenerationEngine(model, device="cpu", max_slots=2,
                           max_seq_len=16, prompt_buckets="8").start()
    try:
        assert eng.compile_count == eng.capture_count == 0
        assert eng.metrics.snapshot()["compile_count"] == 0
        assert len(eng.generate([3, 4, 5], 3, timeout=60)) == 3
    finally:
        eng.stop()
