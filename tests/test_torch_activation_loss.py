"""The port's activations, losses, containers and initializers
(paddle_tpu_torch/nn) on the CPU against the JAX package's, from numpy
inputs of a fixed seed, with tests/test_torch_conv.py's helpers: outputs
and the gradients of one random projection within 1e-5 x max(1,
max|ref|) (float32)."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn import initializer as JI
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import tensor_ops
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.nn import initializer as I
from tests.test_torch_conv import _both, _close


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
ACTIVATIONS = [
    ("relu6", {}), ("sigmoid", {}), ("leaky_relu", {"negative_slope": 0.2}),
    ("elu", {"alpha": 0.7}), ("selu", {}), ("celu", {"alpha": 1.3}),
    ("silu", {}), ("swish", {}), ("mish", {}), ("hardswish", {}),
    ("hardsigmoid", {}), ("hardsigmoid", {"slope": 0.2, "offset": 0.4}),
    ("hardtanh", {"min": -0.5, "max": 2.0}),
    ("hardshrink", {"threshold": 0.4}), ("softshrink", {"threshold": 0.3}),
    ("tanhshrink", {}), ("softplus", {"beta": 2.0, "threshold": 3.0}),
    ("softsign", {}), ("thresholded_relu", {"threshold": 0.5}),
    ("log_sigmoid", {}), ("glu", {"axis": 1}), ("maxout", {"groups": 2}),
    ("maxout", {"groups": 3, "axis": 2}), ("relu", {}), ("tanh", {}),
    ("gelu", {}), ("gelu", {"approximate": True}), ("softmax", {"axis": 1}),
    ("log_softmax", {"axis": 0})]


@pytest.mark.parametrize("name,kw", ACTIVATIONS,
                         ids=[f"{n}-{kw}" for n, kw in ACTIVATIONS])
def test_activation_matches_reference(name, kw):
    x = (3 * np.random.RandomState(9).randn(4, 6, 3)).astype(np.float32)
    _both(lambda a: getattr(JF, name)(a, **kw),
          lambda a: getattr(F, name)(a, **kw), [x], diff=(0,))


LAYERS = [("ReLU", ()), ("ReLU6", ()), ("GELU", (True,)), ("Sigmoid", ()),
          ("Tanh", ()), ("Tanhshrink", ()), ("LeakyReLU", (0.3,)),
          ("ELU", (0.5,)), ("CELU", (0.5,)), ("SELU", ()), ("Silu", ()),
          ("Swish", ()), ("Mish", ()), ("Hardswish", ()), ("Hardsigmoid", ()),
          ("Hardtanh", (-2.0, 1.0)), ("Hardshrink", (0.2,)),
          ("Softshrink", (0.2,)), ("Softplus", (1.5, 4.0)), ("Softsign", ()),
          ("ThresholdedReLU", (0.1,)), ("LogSigmoid", ()), ("Softmax", (0,)),
          ("LogSoftmax", (1,)), ("Maxout", (3, 2)), ("GLU", (1,))]


@pytest.mark.parametrize("cls,args", LAYERS, ids=[c for c, _ in LAYERS])
def test_activation_layer_matches_reference(cls, args):
    """The layer hands its positional arguments to the functional form as
    the reference's does (the forms' gradients are held above)."""
    x = (3 * np.random.RandomState(9).randn(4, 6, 3)).astype(np.float32)
    _both(getattr(jnn, cls)(*args), getattr(nn, cls)(*args), [x])


@pytest.mark.parametrize("n,fmt", [(1, "NCHW"), (3, "NCHW"), (3, "NHWC")])
def test_prelu_matches_reference(n, fmt):
    x = np.random.RandomState(11).randn(2, 3, 4, 3).astype(np.float32)
    w = np.random.RandomState(12).rand(n).astype(np.float32)
    _both(lambda a, ww: JF.prelu(a, ww, fmt),
          lambda a, ww: F.prelu(a, ww, fmt), [x, w], diff=(0, 1))
    jl, pl = jnn.PReLU(n, 0.1, data_format=fmt), nn.PReLU(n, 0.1,
                                                          data_format=fmt)
    _close(pl.weight, jl.weight.numpy())
    _both(jl, pl, [x], diff=(0,))


def test_one_hot_and_label_smooth_match_reference():
    lab = np.array([[0, 3], [2, 1]], np.int64)
    _both(lambda a: JF.one_hot(a, 5), lambda a: F.one_hot(a, 5), [lab])
    assert F.one_hot(torch.from_numpy(lab), 5).dtype == torch.float32
    soft = np.random.RandomState(13).rand(3, 4).astype(np.float32)
    prior = np.random.RandomState(14).rand(4).astype(np.float32)
    _both(lambda a: JF.label_smooth(a, epsilon=0.2),
          lambda a: F.label_smooth(a, epsilon=0.2), [soft], diff=(0,))
    _both(lambda a, p: JF.label_smooth(a, p, 0.3),
          lambda a, p: F.label_smooth(a, p, 0.3), [soft, prior], diff=(0,))


def test_gumbel_softmax_draws_a_distribution():
    torch.manual_seed(0)
    x = torch.randn(64, 5)
    y = F.gumbel_softmax(x, temperature=0.5)
    torch.testing.assert_close(y.sum(-1), torch.ones(64))
    h = F.gumbel_softmax(x.requires_grad_(), hard=True, axis=-1)
    assert set(h.detach().unique().tolist()) == {0.0, 1.0}
    assert torch.equal(h.detach().sum(-1), torch.ones(64))
    h.sum().backward()
    assert x.grad is not None


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _loss_inputs(rs):
    logits = rs.randn(6, 5).astype(np.float32)
    logp = np.log(np.exp(logits) / np.exp(logits).sum(1, keepdims=True))
    prob = 1 / (1 + np.exp(-rs.randn(6, 5))).astype(np.float32)
    target = rs.rand(6, 5).astype(np.float32)
    pm1 = np.where(rs.rand(6) > 0.5, 1.0, -1.0).astype(np.float32)
    return dict(
        logits=logits, logp=logp.astype(np.float32), prob=prob.astype(
            np.float32), target=target, binary=(rs.rand(6, 5) > 0.5).astype(
            np.float32), pm1=pm1,
        labels=np.array([0, 4, 2, -100, 1, 3], np.int64),
        classw=rs.rand(5).astype(np.float32),
        a=rs.randn(6).astype(np.float32), b=rs.randn(6).astype(np.float32),
        x1=rs.randn(6, 4).astype(np.float32),
        x2=rs.randn(6, 4).astype(np.float32),
        norm=np.array([3.0], np.float32))


LOSSES = [
    ("nll_loss", ("logp", "labels"), {}),
    ("nll_loss", ("logp", "labels", "classw"), {"reduction": "sum"}),
    ("nll_loss", ("logp", "labels", "classw"), {}),
    ("nll_loss", ("logp", "labels"), {"reduction": "none"}),
    ("mse_loss", ("logits", "target"), {}),
    ("l1_loss", ("logits", "target"), {"reduction": "sum"}),
    ("smooth_l1_loss", ("logits", "target"), {"delta": 0.5}),
    ("binary_cross_entropy", ("prob", "binary"), {}),
    ("binary_cross_entropy", ("prob", "target", "target"),
     {"reduction": "none"}),
    ("binary_cross_entropy_with_logits", ("logits", "binary"), {}),
    ("binary_cross_entropy_with_logits", ("logits", "target"),
     {"pos_weight": "classw", "reduction": "sum"}),
    ("kl_div", ("logp", "prob"), {}),
    ("kl_div", ("logp", "prob"), {"reduction": "batchmean"}),
    ("margin_ranking_loss", ("a", "b", "pm1"), {"margin": 0.3}),
    ("hinge_embedding_loss", ("a", "pm1"), {"margin": 0.5}),
    ("cosine_embedding_loss", ("x1", "x2", "pm1"), {"margin": 0.1}),
    ("sigmoid_focal_loss", ("logits", "binary"), {}),
    ("sigmoid_focal_loss", ("logits", "binary", "norm"),
     {"reduction": "mean", "gamma": 1.5}),
    ("square_error_cost", ("logits", "target"), {}),
    ("cross_entropy", ("logits", "labels"), {"ignore_index": -100}),
    ("cross_entropy", ("logits", "prob"), {"soft_label": True}),
    ("softmax_with_cross_entropy", ("logits", "labels"), {}),
]


@pytest.mark.parametrize("name,args,kw", LOSSES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(LOSSES)])
def test_loss_matches_reference(name, args, kw):
    data = _loss_inputs(np.random.RandomState(15))
    if name == "nll_loss" and len(args) == 2 and not kw:
        data["labels"] = np.array([0, 4, 2, 3, 1, 3], np.int64)
    arrays = [data[a] for a in args]
    kw = dict(kw)
    if kw.get("pos_weight") == "classw":
        kw["pos_weight"] = None
        jpw, ppw = paddle.to_tensor(data["classw"]), torch.from_numpy(
            data["classw"])
    else:
        jpw = ppw = None
    jkw = dict(kw, **({"pos_weight": jpw} if jpw is not None else {}))
    pkw = dict(kw, **({"pos_weight": ppw} if ppw is not None else {}))
    _both(lambda *a: getattr(JF, name)(*a, **jkw),
          lambda *a: getattr(F, name)(*a, **pkw), arrays, diff=(0,))


LOSS_LAYERS = [
    ("CrossEntropyLoss", {}, ("logits", "labels")),
    ("CrossEntropyLoss", {"weight": "classw"}, ("logits", "labels")),
    ("MSELoss", {}, ("logits", "target")),
    ("L1Loss", {"reduction": "none"}, ("logits", "target")),
    ("NLLLoss", {"reduction": "sum"}, ("logp", "labels")),
    ("BCELoss", {}, ("prob", "binary")),
    ("BCEWithLogitsLoss", {}, ("logits", "target")),
    ("KLDivLoss", {"reduction": "sum"}, ("logp", "prob")),
    ("SmoothL1Loss", {"delta": 2.0}, ("logits", "target")),
    ("MarginRankingLoss", {"margin": 0.2}, ("a", "b", "pm1")),
    ("CosineEmbeddingLoss", {"margin": 0.2}, ("x1", "x2", "pm1")),
    ("HingeEmbeddingLoss", {}, ("a", "pm1")),
]


@pytest.mark.parametrize("cls,kw,args", LOSS_LAYERS,
                         ids=[f"{c}-{i}" for i, (c, _, _) in
                              enumerate(LOSS_LAYERS)])
def test_loss_layer_matches_reference(cls, kw, args):
    data = _loss_inputs(np.random.RandomState(16))
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("weight") == "classw":
        jkw["weight"] = paddle.to_tensor(data["classw"])
        pkw["weight"] = torch.from_numpy(data["classw"])
    _both(getattr(jnn, cls)(**jkw), getattr(nn, cls)(**pkw),
          [data[a] for a in args], diff=(0,))


def test_ctc_loss_matches_reference():
    """Per-sample losses and their gradient against the reference's
    alpha recursion (1e-4: its log-sum-exp adds 1e-30 inside the log);
    ``mean`` divides each loss by its label length before the mean, as
    the reference's, and the layer passes its blank and reduction."""
    rs = np.random.RandomState(17)
    T, B, C, L = 12, 3, 6, 4
    logits = rs.randn(T, B, C).astype(np.float32)
    labels = rs.randint(1, C, (B, L)).astype(np.int64)
    il = np.array([12, 10, 9], np.int64)
    ll = np.array([4, 2, 3], np.int64)
    raw = _both(lambda *a: JF.ctc_loss(*a, reduction="none"),
                lambda *a: F.ctc_loss(*a, reduction="none"),
                [logits, labels, il, ll], diff=(0,), tol=1e-4).detach()
    args = [torch.from_numpy(a) for a in (logits, labels, il, ll)]
    torch.testing.assert_close(F.ctc_loss(*args, reduction="sum"), raw.sum())
    torch.testing.assert_close(F.ctc_loss(*args), (raw / args[3]).mean())
    torch.testing.assert_close(nn.CTCLoss(reduction="mean")(*args),
                               (raw / args[3]).mean())


# ---------------------------------------------------------------------------
# containers, common layers, initializers
# ---------------------------------------------------------------------------
def _tree():
    return lambda m: (m.Sequential(
        m.Conv2D(3, 4, 3), m.BatchNorm2D(4), m.ReLU(),
        m.Sequential(m.Conv2D(4, 2, 1), m.Flatten(), m.Identity())),
        m.Sequential(("conv", m.Conv2D(3, 4, 1)), ("bn", m.BatchNorm2D(4))))


def test_sequential_state_dict_names_are_the_references():
    for jm, pm in zip(_tree()(jnn), _tree()(nn)):
        # the same names (the reference lists the parameters first)
        assert sorted(pm.state_dict()) == sorted(jm.state_dict())
        load_numpy_state(pm, {k: np.asarray(v.numpy())
                              for k, v in jm.state_dict().items()})
    jm, pm = _tree()(jnn)[0], _tree()(nn)[0]
    load_numpy_state(pm, {k: np.asarray(v.numpy())
                          for k, v in jm.state_dict().items()})
    x = np.random.RandomState(18).randn(2, 3, 5, 5).astype(np.float32)
    out = _both(jm, pm, [x], diff=(0,))
    assert out.shape == (2, 18)
    assert len(pm) == 4 and isinstance(pm[1], nn.BatchNorm2D)
    assert isinstance(pm[1:3], nn.Sequential) and len(pm[1:3]) == 2


def test_layer_dict_and_parameter_list():
    d = nn.LayerDict({"a": nn.Linear(2, 3), "b": nn.ReLU()})
    d["c"] = nn.Identity()
    assert list(d.keys()) == ["a", "b", "c"] and "b" in d and len(d) == 3
    assert list(d.state_dict()) == ["a.weight", "a.bias"]
    assert isinstance(d.pop("b"), nn.ReLU) and list(d) == ["a", "c"]
    ps = nn.ParameterList([torch.nn.Parameter(torch.ones(2)),
                           torch.nn.Parameter(torch.zeros(3))])
    ps.append(torch.nn.Parameter(torch.ones(1)))
    assert list(ps.state_dict()) == ["0", "1", "2"] and len(ps) == 3
    assert ps[-1].shape == (1,)


@pytest.mark.parametrize("start,stop", [(0, -1), (1, -1), (1, 2), (-2, -1)])
def test_flatten_matches_reference(start, stop):
    import paddle_tpu.tensor_ops as JT

    x = np.random.RandomState(19).randn(2, 3, 4, 5).astype(np.float32)
    _both(lambda a: JT.flatten(a, start, stop),
          lambda a: tensor_ops.flatten(a, start, stop), [x], diff=(0,))
    _both(jnn.Flatten(start, stop), nn.Flatten(start, stop), [x])


@pytest.mark.parametrize("shape", [(5,), (6, 7), (8, 3, 3, 3),
                                   (4, 2, 5)])
def test_fans_are_the_references(shape):
    assert I._fans(shape) == JI._fans(shape)


def test_initializers_draw_the_references_distributions():
    """The draws are torch's, so each is held by what defines it: bounds,
    moments, orthogonality, the exact Dirac and Assign values."""
    torch.manual_seed(0)
    shape = (64, 32, 3, 3)
    fi, fo = 32 * 9, 64 * 9
    checks = [
        (I.Uniform(-0.3, 0.2), -0.3, 0.2, -0.05, 0.5 / math.sqrt(12)),
        (I.XavierUniform(), None, None, 0.0, math.sqrt(2 / (fi + fo))),
        (I.XavierNormal(), None, None, 0.0, math.sqrt(2 / (fi + fo))),
        (I.KaimingUniform(), None, None, 0.0, math.sqrt(2 / fi)),
        (I.KaimingNormal(), None, None, 0.0, math.sqrt(2 / fi)),
        (I.Normal(0.5, 0.1), None, None, 0.5, 0.1),
        (I.TruncatedNormal(0.0, 2.0), -4.0, 4.0, 0.0, 2.0 * 0.8796)]
    for init, lo, hi, mean, std in checks:
        w = init(shape)
        assert w.shape == shape and w.dtype == torch.float32
        assert abs(float(w.mean()) - mean) < 0.05 * max(std, 0.1), init
        assert abs(float(w.std()) / std - 1) < 0.05, (init, float(w.std()))
        if lo is not None:
            assert float(w.min()) >= lo and float(w.max()) <= hi
    q = I.Orthogonal(gain=2.0)((6, 4))
    torch.testing.assert_close(q.t() @ q, 4 * torch.eye(4), atol=1e-5,
                               rtol=0)
    q = I.Orthogonal()((3, 8))
    torch.testing.assert_close(q @ q.t(), torch.eye(3), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        I.Dirac(groups=2)((4, 2, 3, 3)).numpy(),
        np.asarray(JI.Dirac(groups=2)((4, 2, 3, 3))))
    v = np.arange(6, dtype=np.float32)
    np.testing.assert_array_equal(I.Assign(v)((2, 3)).numpy(),
                                  np.asarray(JI.Assign(v)((2, 3))))
    assert I.Constant(2.5)((2,), torch.bfloat16).dtype == torch.bfloat16
    assert I.MSRAInitializer is I.KaimingNormal
