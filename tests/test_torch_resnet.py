"""The port's ResNets (paddle_tpu_torch/vision/models/resnet.py) on the
CPU against the JAX package's, from the same weights and data, in float64
on both sides: in float32 a 2 x 3 x 32 x 32 batch leaves layer4's batch
norm 2 values a channel, whose normalisation amplifies the two
frameworks' float32 rounding into gradients 5 % apart (measured on
resnet18), where float64 holds the first step's gradients to 5e-11.  The
reference's eager ResNet compiles every op on its first step (~20 s for
resnet18), so its trajectory is computed once per module.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.vision import models as jmodels
from paddle_tpu.vision.models import resnet as jresnet
from paddle_tpu.vision.models.resnet import _s2d_stem_conv as j_s2d
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.vision import models as tmodels
from paddle_tpu_torch.vision.models.resnet import _s2d_stem_conv
from tests.test_torch_vision import _rel, _same_names, _state

F64_TOL = 1e-9       # relative, float64 ResNet eval and blocks


# ---------------------------------------------------------------------------
# ResNet (BASELINE.md config 2): resnet18 at 2 x 3 x 32 x 32 in float64
# ---------------------------------------------------------------------------
STEPS, LR = 3, 0.01


def _batches():
    """(images, one-hot labels): the loss takes soft labels, the
    composite cross-entropy in float64 on both sides (hard labels go to
    the port's kernel route, whose plain version computes in float32 as
    the kernel does, held in float32 by the LeNet tests)."""
    rs = np.random.RandomState(0)
    return [(rs.rand(2, 3, 32, 32), np.eye(7)[rs.randint(0, 7, 2)])
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def resnet18_reference():
    """The reference's float64 resnet18(num_classes=7): its initial state,
    then for each of STEPS Momentum steps the logits, the loss, every
    parameter's gradient and the state after the step."""
    paddle.seed(0)
    jm = jmodels.resnet18(num_classes=7)
    jm.astype("float64")
    state0 = _state(jm)
    opt = paddle.optimizer.Momentum(learning_rate=LR, momentum=0.9,
                                    parameters=jm.parameters())
    steps = []
    for x, y in _batches():
        logits = jm(paddle.to_tensor(x, dtype="float64"))
        loss = jnn.CrossEntropyLoss(soft_label=True)(
            logits, paddle.to_tensor(y, dtype="float64"))
        loss.backward()
        grads = {n: np.asarray(p.grad.numpy())
                 for n, p in jm.named_parameters()}
        opt.step()
        opt.clear_grad()
        steps.append((np.asarray(logits.numpy()), float(loss.numpy()),
                      grads, _state(jm)))
    return state0, steps


# float64: a step's rounding difference grows about 1e3-fold a step
# through layer4's 2-value batch-norm channels (measured: gradients 5e-11,
# 2e-7, 6e-4 apart at steps 0, 1, 2), so each step has its tolerance
STEP_TOL = (1e-9, 1e-5, 1e-2)


def test_resnet18_train_steps_match_reference(resnet18_reference):
    """Logits, loss and every gradient of each step, and every parameter
    and running statistic after it, each step within its STEP_TOL."""
    state0, steps = resnet18_reference
    tm = tmodels.resnet18(num_classes=7, device="cpu")
    _same_names(tm, state0)
    tm.astype("float64")
    load_numpy_state(tm, state0)
    opt = ptt.optimizer.Momentum(learning_rate=LR, momentum=0.9,
                                 parameters=tm.parameters())
    for tol, (x, y), (jlogits, jloss, jgrads, jstate) in zip(
            STEP_TOL, _batches(), steps):
        logits = tm(torch.from_numpy(x))
        loss = nn.CrossEntropyLoss(soft_label=True)(logits,
                                                    torch.from_numpy(y))
        loss.backward()
        assert _rel(logits, jlogits) < tol
        assert abs(float(loss) - jloss) <= tol * abs(jloss)
        for n, p in tm.named_parameters():
            assert _rel(p.grad, jgrads[n]) < tol, n
        opt.step()
        opt.clear_grad()
        for k, v in jstate.items():
            assert _rel(tm.state_dict()[k], v) < tol, k


def test_resnet18_eval_reads_the_running_statistics(resnet18_reference):
    """Eval mode on the state after the first step (its statistics moved
    once): the same logits from the same running statistics.  Statistics
    that moved once do not normalise a random network's residual stream,
    which grows to logits of ~1e18, float64 rounding with it: 1e-6."""
    state = resnet18_reference[1][0][3]
    tm = tmodels.resnet18(num_classes=7, device="cpu")
    tm.astype("float64")
    load_numpy_state(tm, state)
    jm = jmodels.resnet18(num_classes=7)
    jm.astype("float64")
    jm.set_state_dict(state)
    tm.eval(), jm.eval()
    x = np.random.RandomState(5).rand(3, 3, 32, 32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert _rel(got, jm(paddle.to_tensor(x, dtype="float64")).numpy()) \
        < 1e-6


def test_bottleneck_block_matches_reference():
    """ResNet-50's block with a strided downsample, in train mode: output,
    input gradient, every parameter gradient and the statistics."""
    paddle.seed(3)

    def block(m):
        down = m.Sequential(m.Conv2D(16, 32, 1, stride=2, bias_attr=False),
                            m.BatchNorm2D(32))
        return (jresnet if m is jnn else tmodels).BottleneckBlock(
            16, 8, stride=2, downsample=down)

    jb, tb = block(jnn), block(nn)
    jb.astype("float64")
    tb.astype("float64")
    _same_names(tb, _state(jb))
    load_numpy_state(tb, _state(jb))
    x = np.random.RandomState(4).randn(4, 16, 8, 8)
    r = np.random.RandomState(5).randn(4, 32, 4, 4)
    jx = paddle.to_tensor(x, dtype="float64", stop_gradient=False)
    tx = torch.tensor(x, requires_grad=True)
    jo, to = jb(jx), tb(tx)
    assert _rel(to, jo.numpy()) < 1e-12
    (jo * paddle.to_tensor(r, dtype="float64")).sum().backward()
    (to * torch.from_numpy(r)).sum().backward()
    assert _rel(tx.grad, jx.grad.numpy()) < 1e-10
    for n, p in tb.named_parameters():
        assert _rel(p.grad, dict(jb.named_parameters())[n].grad.numpy()) \
            < 1e-10, n
    for k, v in _state(jb).items():
        assert _rel(tb.state_dict()[k], v) < 1e-12, k


def test_s2d_stem_is_the_standard_stem():
    """The space-to-depth stem equals the 7x7 / 2 / 3 conv it rewrites
    (float64), in the port and against the reference's s2d stem; a model
    built with it keeps the [64, 3, 7, 7] checkpoint layout."""
    rs = np.random.RandomState(6)
    x, w = rs.randn(2, 3, 16, 20), rs.randn(64, 3, 7, 7)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    std = torch.nn.functional.conv2d(tx, tw, stride=2, padding=3)
    s2d = _s2d_stem_conv(tx, tw)
    assert _rel(s2d, std.numpy()) < 1e-12
    ref = j_s2d(paddle.to_tensor(x, dtype="float64"),
                paddle.to_tensor(w, dtype="float64"))
    assert _rel(s2d, ref.numpy()) < 1e-12
    m = tmodels.resnet18(num_classes=3, s2d_stem=True, device="cpu")
    assert tuple(m.conv1.weight.shape) == (64, 3, 7, 7)
    m.astype("float64")
    std_m = tmodels.resnet18(num_classes=3, device="cpu")
    std_m.astype("float64")
    std_m.set_state_dict(m.state_dict())
    m.eval(), std_m.eval()
    x = torch.from_numpy(rs.rand(1, 3, 32, 32))
    with torch.no_grad():
        assert _rel(m(x), std_m(x).numpy()) < 1e-10
