"""The port's convolution, pooling and normalisation functions and layers
(paddle_tpu_torch/nn) on the CPU against the JAX package's (paddle_tpu/nn),
from numpy inputs of a fixed seed (activations, losses, containers and
initializers: tests/test_torch_activation_loss.py).

Every reference function here is XLA math (none reaches a Pallas kernel),
run eagerly on its tape; gradients are read from it after ``backward`` of
the same random projection of the output on both sides.  Tolerances:
float32 outputs and gradients within 1e-5 x max(1, max|ref|) (a sum of
at most a few hundred float32 products, in another order); the batch
norm's running statistics 1e-5 too (the reference takes the variance as
E[x^2] - E[x]^2, PyTorch by Welford's update).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.models import load_numpy_state

TOL = 1e-5


def _close(got, ref, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    # equal infinities and NaNs: a window wholly in the padding is -inf
    # (max) or 0 / 0 (exclusive average) on both sides
    same = (got == ref) | (np.isnan(got) & np.isnan(ref))
    got, ref = np.where(same, 0, got), np.where(same, 0, ref)
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    err = float(np.abs(got.astype(np.float64) - ref).max()) if ref.size \
        else 0.0
    assert err <= tol * scale, f"{what}: max err {err:.3e} > " \
                               f"{tol * scale:.3e}"


def _both(ref_fn, port_fn, arrays, diff=(), seed=0, tol=TOL):
    """ref_fn and port_fn on the same arrays; outputs compared, and for
    the inputs of index ``diff`` the gradients of sum(out * r) for one
    random r."""
    jt = [paddle.to_tensor(a, stop_gradient=i not in diff)
          for i, a in enumerate(arrays)]
    pt = [torch.tensor(a, requires_grad=i in diff and
                       np.issubdtype(a.dtype, np.floating))
          for i, a in enumerate(arrays)]
    jo, po = ref_fn(*jt), port_fn(*pt)
    _close(po, jo.numpy(), tol, "output")
    if diff:
        r = np.asarray(np.random.RandomState(seed + 99).randn(
            *po.shape), np.float32)
        (jo * paddle.to_tensor(r)).sum().backward()
        (po * torch.from_numpy(r)).sum().backward()
        for i in diff:
            _close(pt[i].grad, jt[i].grad.numpy(), tol, f"grad {i}")
    return po


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------
CONV_CASES = [
    # nsp, transpose, padding, stride, dilation, groups, channel_last
    (2, False, [1, 2], 2, 1, 1, False),
    (2, False, [1, 0, 2, 1], 1, 2, 1, False),
    (2, False, [[0, 0], [0, 0], [2, 1], [0, 3]], 2, 1, 1, False),
    (2, False, [[1, 2], [2, 0]], 1, 1, 2, False),
    (2, False, "SAME", 2, 1, 1, False),
    (2, False, "SAME", 1, 2, 1, True),
    (2, False, "VALID", 2, 1, 2, True),
    (1, False, "SAME", 2, 1, 1, True),
    (3, False, 1, 2, 1, 1, False),
    (3, False, [1, 0, 0, 1, 1, 0], 1, 1, 2, False),
    (2, True, 1, 2, 1, 1, False),
    (2, True, [1, 0, 2, 1], 2, 1, 2, False),
    (2, True, "SAME", 1, 1, 1, False),
    (1, True, "SAME", 1, 2, 2, True),
    (2, True, "VALID", 1, 2, 1, True),
    (1, True, 0, 3, 1, 1, False),
    (3, True, 1, 2, 1, 2, False),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=[
    f"{c[0]}d{'T' if c[1] else ''}-pad{c[2]}-s{c[3]}-d{c[4]}-g{c[5]}"
    f"{'-last' if c[6] else ''}" for c in CONV_CASES])
def test_conv_matches_reference(case):
    nsp, transpose, padding, stride, dilation, groups, last = case
    rs = np.random.RandomState(len(str(case)))
    cin, cout, k = 4, 6, 3
    sp = {1: (11,), 2: (9, 8), 3: (5, 6, 5)}[nsp]
    x = rs.randn(2, cin, *sp).astype(np.float32)
    if last:
        x = np.moveaxis(x, 1, -1).copy()
    w = rs.randn(*((cin, cout // groups) if transpose else
                   (cout, cin // groups)), *(k,) * nsp).astype(np.float32)
    b = rs.randn(cout).astype(np.float32)
    fmt = {1: "NCL", 2: "NCHW", 3: "NCDHW"}[nsp]
    if last:
        fmt = {1: "NLC", 2: "NHWC", 3: "NDHWC"}[nsp]
    name = f"conv{nsp}d" + ("_transpose" if transpose else "")
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=fmt)
    if transpose:
        kw["output_padding"] = 1 if stride > 1 and not isinstance(
            padding, str) else 0
    _both(lambda *a: getattr(JF, name)(*a, **kw),
          lambda *a: getattr(F, name)(*a, **kw), [x, w, b], diff=(0, 1, 2))


def test_conv_transpose_output_size_matches_reference():
    rs = np.random.RandomState(3)
    x = rs.randn(1, 3, 5, 5).astype(np.float32)
    w = rs.randn(3, 2, 3, 3).astype(np.float32)
    kw = dict(stride=2, padding=1, output_size=[10, 9])
    out = _both(lambda *a: JF.conv2d_transpose(*a, **kw),
                lambda *a: F.conv2d_transpose(*a, **kw), [x, w])
    assert out.shape == (1, 2, 10, 9)
    with pytest.raises(ValueError, match="unreachable"):
        F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                           stride=2, padding=1, output_size=[13, 9])


def test_conv_transpose_string_padding_at_stride_2_raises_as_reference():
    x, w = np.zeros((1, 2, 4, 4), np.float32), np.zeros((2, 2, 3, 3),
                                                         np.float32)
    with pytest.raises(ValueError):
        JF.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                            stride=2, padding="SAME")
    with pytest.raises(ValueError, match="string padding"):
        F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                           stride=2, padding="SAME")


def test_conv_refuses_wrong_channels():
    with pytest.raises(ValueError, match="input channels"):
        F.conv2d(torch.zeros(1, 3, 5, 5), torch.zeros(4, 2, 3, 3))


@pytest.mark.parametrize("cls,nsp", [("Conv1D", 1), ("Conv2D", 2),
                                     ("Conv3D", 3), ("Conv1DTranspose", 1),
                                     ("Conv2DTranspose", 2),
                                     ("Conv3DTranspose", 3)])
def test_conv_layers_match_reference(cls, nsp):
    paddle.seed(nsp)
    kw = dict(stride=2, padding=1, groups=2)
    if "Transpose" in cls:
        kw["output_padding"] = 1
    jl, pl = getattr(jnn, cls)(4, 6, 3, **kw), getattr(nn, cls)(4, 6, 3, **kw)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert sorted(state) == sorted(pl.state_dict()) == ["bias", "weight"]
    assert tuple(pl.weight.shape) == state["weight"].shape
    load_numpy_state(pl, state)
    x = np.random.RandomState(nsp).randn(
        2, 4, *(6,) * nsp).astype(np.float32)
    _both(jl, pl, [x], diff=(0,))


def test_conv_default_initializer_is_the_references():
    """Uniform(+-sqrt(1 / fan_in)), fan_in = in_c / groups * prod(k)."""
    w = nn.Conv2D(8, 16, 3, groups=2).weight.detach()
    bound = math.sqrt(1.0 / (4 * 9))
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert abs(float(w.mean())) < 0.05 * bound


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------
POOL_CASES = [
    # name, kernel, stride, padding, ceil_mode, extra, spatial
    ("max_pool2d", 3, 2, 1, False, {}, (9, 9)),
    ("max_pool2d", 2, 2, 0, True, {}, (7, 9)),
    ("max_pool2d", 3, 2, 1, True, {}, (8, 7)),
    ("max_pool2d", [3, 2], [2, 1], "SAME", False, {}, (7, 6)),
    ("max_pool2d", 3, 2, [[0, 1], [1, 2]], True, {}, (8, 9)),
    ("max_pool1d", 3, 2, 1, True, {}, (10,)),
    ("max_pool3d", 2, 2, 0, True, {}, (5, 4, 5)),
    ("avg_pool2d", 3, 2, 1, False, {"exclusive": False}, (9, 9)),
    ("avg_pool2d", 3, 2, 1, True, {}, (8, 8)),
    ("avg_pool2d", 3, 2, 1, True, {"exclusive": False}, (8, 8)),
    ("avg_pool2d", 3, 2, "SAME", False, {}, (8, 7)),
    ("avg_pool2d", 3, 1, [1, 0, 2, 1], False, {}, (6, 6)),
    ("avg_pool2d", 2, 2, 0, True, {"data_format": "NHWC"}, (7, 6)),
    ("avg_pool1d", 3, 2, 1, True, {"exclusive": True}, (10,)),
    ("avg_pool3d", 3, 2, 1, True, {"exclusive": False}, (6, 5, 6)),
]


@pytest.mark.parametrize("case", POOL_CASES, ids=[
    f"{c[0]}-k{c[1]}-s{c[2]}-p{c[3]}-ceil{int(c[4])}-"
    f"{'-'.join(f'{k}{v}' for k, v in c[5].items())}" for c in POOL_CASES])
def test_pool_matches_reference(case):
    name, k, s, p, ceil, extra, sp = case
    rs = np.random.RandomState(len(str(case)))
    x = rs.randn(2, 3, *sp).astype(np.float32)
    if extra.get("data_format") == "NHWC":
        x = np.moveaxis(x, 1, -1).copy()
    kw = dict(stride=s, padding=p, ceil_mode=ceil, **extra)
    _both(lambda a: getattr(JF, name)(a, k, **kw),
          lambda a: getattr(F, name)(a, k, **kw), [x], diff=(0,))


def test_ceil_mode_keeps_the_window_pytorch_drops():
    """k = 2, s = 2 over 5 with pad 1 and ceil_mode: the reference widens
    the right pad to 2 and keeps a fourth window, which starts in the
    padding (max -inf, exclusive average 0 / 0); PyTorch's own ceil_mode
    drops it.  The port gives the reference's 4 outputs."""
    x = np.arange(10, dtype=np.float32).reshape(1, 2, 5)
    kw = dict(stride=2, padding=1, ceil_mode=True)
    for name in ("avg_pool1d", "max_pool1d"):
        out = _both(lambda a: getattr(JF, name)(a, 2, **kw),
                    lambda a: getattr(F, name)(a, 2, **kw), [x])
        assert out.shape == (1, 2, 4)
        assert getattr(torch.nn.functional, name)(
            torch.from_numpy(x), 2, 2, 1, ceil_mode=True).shape == (1, 2, 3)


@pytest.mark.parametrize("name,out,sp", [
    ("adaptive_avg_pool2d", (1, 1), (7, 7)),
    ("adaptive_avg_pool2d", (2, 3), (8, 9)),
    ("adaptive_avg_pool2d", (3, 2), (7, 5)),
    ("adaptive_max_pool2d", (2, 2), (8, 6)),
    ("adaptive_max_pool2d", (3, 3), (7, 10)),
    ("adaptive_avg_pool1d", 3, (11,))])
def test_adaptive_pool_matches_reference(name, out, sp):
    x = np.random.RandomState(len(sp)).randn(2, 3, *sp).astype(np.float32)
    _both(lambda a: getattr(JF, name)(a, out),
          lambda a: getattr(F, name)(a, out), [x], diff=(0,))


def test_adaptive_avg_pool2d_channel_last_matches_reference():
    x = np.random.RandomState(4).randn(2, 7, 5, 3).astype(np.float32)
    _both(lambda a: JF.adaptive_avg_pool2d(a, (3, 2), "NHWC"),
          lambda a: F.adaptive_avg_pool2d(a, (3, 2), "NHWC"), [x],
          diff=(0,))


@pytest.mark.parametrize("cls,args,sp", [
    ("MaxPool1D", (3, 2, 1), (9,)), ("MaxPool2D", (3, 2, 1), (9, 8)),
    ("MaxPool3D", (2, 2, 0), (4, 5, 4)), ("AvgPool1D", (3, 2, 1), (9,)),
    ("AvgPool2D", (3, 2, 1), (9, 8)), ("AvgPool3D", (2, 2, 1), (4, 5, 4)),
    ("AdaptiveAvgPool1D", (3,), (9,)), ("AdaptiveAvgPool2D", ((2, 3),),
                                        (6, 9)),
    ("AdaptiveMaxPool2D", (2,), (6, 8))])
def test_pool_layers_match_reference(cls, args, sp):
    x = np.random.RandomState(len(sp)).randn(2, 3, *sp).astype(np.float32)
    kw = {"ceil_mode": True} if cls[:3] in ("Max", "Avg") else {}
    _both(getattr(jnn, cls)(*args, **kw), getattr(nn, cls)(*args, **kw),
          [x], diff=(0,))


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,fmt", [((4, 3, 5, 5), "NCHW"),
                                       ((4, 5, 5, 3), "NHWC"),
                                       ((8, 3), "NCHW")])
def test_batch_norm_training_steps_and_eval_match_reference(shape, fmt):
    """Three training steps (output, input and affine gradients, running
    statistics after each), then eval mode and use_global_stats."""
    rs = np.random.RandomState(len(shape))
    C = shape[-1] if fmt == "NHWC" else shape[1]
    w, b = 1 + 0.1 * rs.randn(C), 0.1 * rs.randn(C)
    j_rm, j_rv = paddle.to_tensor(np.zeros(C, np.float32)), \
        paddle.to_tensor(np.ones(C, np.float32))
    p_rm, p_rv = torch.zeros(C), torch.ones(C)
    for step in range(3):
        x = (rs.randn(*shape) * (step + 1) + step).astype(np.float32)
        _both(lambda a, ww, bb: JF.batch_norm(a, j_rm, j_rv, ww, bb,
                                              training=True,
                                              data_format=fmt),
              lambda a, ww, bb: F.batch_norm(a, p_rm, p_rv, ww, bb,
                                             training=True, data_format=fmt),
              [x, w.astype(np.float32), b.astype(np.float32)],
              diff=(0, 1, 2), seed=step)
        _close(p_rm, j_rm.numpy(), what=f"running mean, step {step}")
        _close(p_rv, j_rv.numpy(), what=f"running var, step {step}")
    x = rs.randn(*shape).astype(np.float32)
    for kw in (dict(training=False), dict(training=True,
                                          use_global_stats=True)):
        _both(lambda a: JF.batch_norm(a, j_rm, j_rv, None, None,
                                      data_format=fmt, **kw),
              lambda a: F.batch_norm(a, p_rm, p_rv, None, None,
                                     data_format=fmt, **kw), [x], diff=(0,))
    _close(p_rv, j_rv.numpy(), what="running var moved in eval")


@pytest.mark.parametrize("cls,shape", [("BatchNorm1D", (6, 4, 5)),
                                       ("BatchNorm2D", (4, 4, 3, 5)),
                                       ("BatchNorm3D", (2, 4, 3, 2, 3)),
                                       ("SyncBatchNorm", (4, 4, 3, 3))])
def test_batch_norm_layers_match_reference(cls, shape):
    jl, pl = getattr(jnn, cls)(4, momentum=0.8), \
        getattr(nn, cls)(4, momentum=0.8)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert sorted(pl.state_dict()) == sorted(state) == [
        "_mean", "_variance", "bias", "weight"]
    assert all(v.dtype == torch.float32 for v in pl.state_dict().values())
    load_numpy_state(pl, state)
    rs = np.random.RandomState(7)
    for _ in range(2):
        _both(jl, pl, [rs.randn(*shape).astype(np.float32)])
    for k, v in jl.state_dict().items():
        _close(pl.state_dict()[k], v.numpy(), what=k)
    jl.eval(), pl.eval()
    _both(jl, pl, [rs.randn(*shape).astype(np.float32)])


def test_fluid_batch_norm_takes_its_activation():
    jl, pl = jnn.BatchNorm(3, act="relu"), nn.BatchNorm(3, act="relu")
    x = np.random.RandomState(2).randn(4, 3, 2, 2).astype(np.float32)
    out = _both(jl, pl, [x], diff=(0,))
    assert float(out.min()) == 0.0


def test_convert_sync_batchnorm_keeps_values_and_names():
    paddle.seed(1)
    net = nn.Sequential(nn.Conv2D(3, 4, 1), nn.BatchNorm2D(4), nn.ReLU(),
                        nn.Sequential(nn.BatchNorm2D(4)))
    net.train()
    net(torch.randn(2, 3, 4, 4))           # move the statistics
    before = {k: v.clone() for k, v in net.state_dict().items()}
    out = nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert out is net
    assert isinstance(net[1], nn.SyncBatchNorm)
    assert isinstance(net[3][0], nn.SyncBatchNorm)
    after = net.state_dict()
    assert sorted(after) == sorted(before)
    assert all(torch.equal(after[k], before[k]) for k in before)


def test_astype_casts_the_batch_norm_statistics():
    bn = nn.BatchNorm2D(3)
    bn.astype("bfloat16")
    assert bn._mean.dtype == bn._variance.dtype == bn.weight.dtype \
        == torch.bfloat16
    bn.train()
    out = bn(torch.randn(4, 3, 2, 2, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and bn._mean.abs().sum() > 0


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_group_norm_matches_reference(fmt):
    rs = np.random.RandomState(5)
    x = rs.randn(2, 6, 4, 3).astype(np.float32)
    if fmt == "NHWC":
        x = np.moveaxis(x, 1, -1).copy()
    w, b = (1 + rs.randn(6)).astype(np.float32), rs.randn(6).astype(
        np.float32)
    _both(lambda a, ww, bb: JF.group_norm(a, 3, 1e-5, ww, bb, fmt),
          lambda a, ww, bb: F.group_norm(a, 3, 1e-5, ww, bb, fmt),
          [x, w, b], diff=(0, 1, 2))


def test_norm_layers_match_reference():
    rs = np.random.RandomState(6)
    for cls, args, shape in (
            ("GroupNorm", (2, 4), (2, 4, 3, 3)),
            ("InstanceNorm1D", (4,), (2, 4, 7)),
            ("InstanceNorm2D", (4,), (2, 4, 3, 5)),
            ("InstanceNorm3D", (4,), (2, 4, 3, 2, 3)),
            ("LocalResponseNorm", (3,), (2, 5, 3, 3)),
            ("LocalResponseNorm", (4, 1e-2, 0.5, 2.0), (2, 6, 2, 3))):
        jl, pl = getattr(jnn, cls)(*args), getattr(nn, cls)(*args)
        state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
        assert sorted(pl.state_dict()) == sorted(state)
        if state:
            load_numpy_state(pl, {k: v + rs.randn(*v.shape).astype(
                np.float32) for k, v in state.items()})
            jl.set_state_dict({k: v.numpy() for k, v in
                               pl.state_dict().items()})
        _both(jl, pl, [rs.randn(*shape).astype(np.float32)])


def test_normalize_matches_reference():
    x = np.random.RandomState(8).randn(3, 5, 2).astype(np.float32)
    for p, axis in ((2, 1), (1, -1), (3, 0)):
        _both(lambda a: JF.normalize(a, p, axis),
              lambda a: F.normalize(a, p, axis), [x], diff=(0,))
