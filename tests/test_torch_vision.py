"""The port's vision models and datasets (paddle_tpu_torch/vision) and
``Model.fit`` over them, on the CPU, against the JAX package's
(paddle_tpu/vision, paddle_tpu.Model), from the same weights and data.

LeNet runs in float32 (no batch norm: logits, 5 Adam steps and a
``Model.fit`` epoch within 1e-5 of the reference, relative).  The ResNets
run in float64 on both sides: in float32 a 2 x 3 x 32 x 32 batch leaves
layer4's batch norm 2 values a channel, whose normalisation amplifies the
two frameworks' float32 rounding into gradients 5 % apart (measured on
resnet18), where float64 holds the first step's gradients to 5e-11.  The reference's
eager ResNet compiles every op on its first step (~20 s for resnet18), so
its trajectory is computed once per module.
"""
import gzip
import pickle
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import metric as jmetric
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import models as jmodels
from paddle_tpu.vision.models import resnet as jresnet
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import models as tmodels

F32_TOL = 1e-5       # relative, float32 LeNet


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _same_names(tm, jstate):
    """The reference's state_dict names and shapes (its dict lists the
    parameters before the buffers, PyTorch's each layer's in turn)."""
    tstate = tm.state_dict()
    assert sorted(tstate) == sorted(jstate)
    assert all(tuple(tstate[k].shape) == np.shape(v)
               for k, v in jstate.items())


def _rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max()) / max(1e-30,
                                                 float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,mode", [("MNIST", "train"), ("MNIST", "test"),
                                       ("Cifar10", "train"),
                                       ("Cifar10", "test")])
def test_synthetic_samples_are_the_references(name, mode):
    j, t = getattr(jds, name)(mode=mode), getattr(tds, name)(mode=mode)
    assert t.synthetic and j.synthetic and len(t) == len(j)
    for i in (0, 1, 7, len(j) - 1):
        (ji, jl), (ti, tl) = j[i], t[i]
        assert ti.dtype == np.float32 and tl.dtype == np.int64
        np.testing.assert_array_equal(ti, ji)
        assert int(tl) == int(jl)


def test_local_files_load_as_the_references(tmp_path):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, 5).astype(np.uint8)
    ip, lp = tmp_path / "img.gz", tmp_path / "lbl.gz"
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    j = jds.MNIST(str(ip), str(lp))
    t = tds.MNIST(str(ip), str(lp))
    assert not t.synthetic and len(t) == 5
    for i in range(5):
        np.testing.assert_array_equal(t[i][0], j[i][0])
        assert t[i][0].shape == (1, 28, 28) and int(t[i][1]) == labels[i]
    cdir = tmp_path / "cifar"
    cdir.mkdir()
    d = {b"data": rs.randint(0, 256, (4, 3072)).astype(np.uint8),
         b"labels": [1, 2, 3, 4]}
    with open(cdir / "test_batch", "wb") as f:
        pickle.dump(d, f)
    j, t = jds.Cifar10(str(cdir), mode="test"), tds.Cifar10(str(cdir),
                                                            mode="test")
    assert not t.synthetic and len(t) == 4
    np.testing.assert_array_equal(t[3][0], j[3][0])
    assert int(t[3][1]) == 4


# ---------------------------------------------------------------------------
# LeNet (BASELINE.md config 1)
# ---------------------------------------------------------------------------
def _mnist_batch(n, seed=0):
    ds = jds.MNIST(mode="train")
    idx = np.random.RandomState(seed).choice(len(ds), n, replace=False)
    return (np.stack([ds[i][0] for i in idx]),
            np.stack([ds[i][1] for i in idx]))


def test_lenet_logits_and_adam_trajectory_match_reference():
    paddle.seed(0)
    jm = jmodels.LeNet()
    tm = tmodels.LeNet(device="cpu")
    _same_names(tm, _state(jm))
    load_numpy_state(tm, _state(jm))
    x, y = _mnist_batch(64)
    assert _rel(tm(torch.from_numpy(x)), jm(paddle.to_tensor(x)).numpy()) \
        < F32_TOL
    jopt = paddle.optimizer.Adam(learning_rate=1e-3,
                                 parameters=jm.parameters())
    topt = ptt.optimizer.Adam(learning_rate=1e-3,
                              parameters=tm.parameters())
    jl_fn, tl_fn = jnn.CrossEntropyLoss(), nn.CrossEntropyLoss()
    jlosses, tlosses = [], []
    for step in range(5):
        xb, yb = x[step * 12:(step + 1) * 12], y[step * 12:(step + 1) * 12]
        jl = jl_fn(jm(paddle.to_tensor(xb)), paddle.to_tensor(yb))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = tl_fn(tm(torch.from_numpy(xb)), torch.from_numpy(yb))
        tl.backward()
        topt.step()
        topt.clear_grad()
        jlosses.append(float(jl.numpy()))
        tlosses.append(float(tl))
    np.testing.assert_allclose(tlosses, jlosses, rtol=F32_TOL)
    assert tlosses[-1] < tlosses[0]
    for k, v in _state(jm).items():
        assert _rel(tm.state_dict()[k], v) < F32_TOL, k


class _Head:
    """The first ``n`` samples of a dataset."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __getitem__(self, i):
        return self.ds[i]

    def __len__(self):
        return self.n


def test_lenet_fit_and_evaluate_match_reference():
    """Model.fit (Adam 1e-3, CrossEntropyLoss, Accuracy, shuffle=False,
    batch 64 over 256 synthetic MNIST samples): every step's loss and
    accuracy, then evaluate's loss and accuracy on 128 test samples."""
    paddle.seed(1)
    jnet = jmodels.LeNet()
    tnet = tmodels.LeNet(device="cpu")
    load_numpy_state(tnet, _state(jnet))
    runs = []
    for mod, net, ds, cb, metric, opt in (
            (paddle, jnet, jds, jcb, jmetric, paddle.optimizer.Adam),
            (ptt, tnet, tds, tcb, tmetric, ptt.optimizer.Adam)):
        logs = []

        class Logs(cb.Callback):
            def on_train_batch_end(self, step, l=None):
                logs.append((l["loss"], l["acc"]))

        model = mod.Model(net)
        model.prepare(opt(learning_rate=1e-3, parameters=net.parameters()),
                      (jnn if mod is paddle else nn).CrossEntropyLoss(),
                      metric.Accuracy())
        model.fit(_Head(ds.MNIST(mode="train"), 256), batch_size=64,
                  epochs=1, shuffle=False, verbose=0, callbacks=[Logs()])
        res = model.evaluate(_Head(ds.MNIST(mode="test"), 128),
                             batch_size=64, verbose=0)
        runs.append((np.asarray(logs, float), res))
    (jlogs, jres), (tlogs, tres) = runs
    assert tlogs.shape == jlogs.shape == (4, 2)
    np.testing.assert_allclose(tlogs, jlogs, rtol=F32_TOL)
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=F32_TOL)
    assert tres["acc"] == jres["acc"]


@pytest.mark.parametrize("name,kw", [
    ("resnet50", {}), ("resnet34", {"num_classes": 10}),
    ("wide_resnet50_2", {}), ("resnext50_32x4d", {}),
    ("vgg11", {"batch_norm": True, "num_classes": 0}),
    ("mobilenet_v1", {"scale": 0.5}), ("mobilenet_v2", {})])
def test_model_families_have_the_references_state(name, kw):
    """The reference's state_dict names and shapes (checkpoints load
    across); a forward at 1 x 3 x 32 x 32 gives the class count."""
    paddle.seed(0)
    jstate = _state(getattr(jresnet if "res" in name else jmodels,
                            name)(**kw))
    tm = getattr(tmodels, name)(device="cpu", **kw)
    _same_names(tm, jstate)
    load_numpy_state(tm, jstate)
    tm.eval()
    with torch.no_grad():
        out = tm(torch.rand(1, 3, 32, 32))
    n = kw.get("num_classes", 1000)
    if n:
        assert out.shape == (1, n) and torch.isfinite(out).all()


def test_models_run_on_the_card_by_default():
    """device=None means the CUDA card; without one the constructor
    raises instead of building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.LeNet()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.resnet50()
