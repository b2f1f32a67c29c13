"""Gradient accumulation in ``Model.fit`` (``accum_steps=k`` and its alias
``accumulate_grad_batches``) against the JAX package's
``Model.fit(accum_steps=k)`` (its ``microbatch_scan`` inside the one
jitted step), on the CPU, float32, dropout 0, shuffle off:

- a small BERT (MLM + NSP, padded batches, Momentum), weights carried
  over: every step's loss and the weights after 3 steps within rtol 1e-5,
  atol 1e-6 (float32 rounding of the same ops in two frameworks);
- a small conv net with batch norm (LarsMomentum; its running statistics
  move through the microbatches in order) bitwise the microbatch loop
  written out in the port: the reference's accumulated fit raises on a
  batch-norm network;
- accum_steps=4 against accum_steps=1 at the same global batch, on a model
  whose loss is a mean over equal microbatches (mean of means = the
  mean): losses and weights within rtol 1e-5 (reassociation), as
  tests/test_layout3d.py holds the reference;
- the outputs a metric sees are re-merged to global order;
- the reference's ``ValueError``s: a batch that k does not divide, k < 1.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu_torch.hapi.engine import microbatch_split
from paddle_tpu_torch.models import BertConfig, BertForPretraining

TOL = dict(rtol=1e-5, atol=1e-6)
CFG = dict(vocab_size=60, hidden_size=16, num_layers=2, num_heads=2,
           intermediate_size=32, max_position_embeddings=16, dropout=0.0)
N, S = 24, 12


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy().copy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _bert_data():
    rs = np.random.RandomState(12)
    lens = rs.randint(S // 2, S + 1, N)
    return [rs.randint(0, 60, (N, S)), rs.randint(0, 2, (N, S)),
            (np.arange(S)[None] < lens[:, None])[:, None, None, :],
            np.where(rs.rand(N, S) < 0.3, rs.randint(0, 60, (N, S)), -100),
            rs.randint(0, 2, N)]


def _bert_loss(F):
    def loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels):
        mlm = F.cross_entropy(mlm_logits, mlm_labels, reduction="none",
                              ignore_index=-100)
        denom = (mlm_labels != -100).astype("float32").sum() \
            if F is paddle.nn.functional else \
            (mlm_labels != -100).float().sum()
        return mlm.sum() / denom + F.cross_entropy(nsp_logits, nsp_labels)
    return loss


class _Losses:
    """A callback of each package recording every step's loss."""

    @staticmethod
    def make(pkg):
        seen = []

        class Record(pkg.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                seen.append(float(logs["loss"]))

        return Record(), seen


def _fit(pkg, net, opt, loss, data, batch, labels=None, **kw):
    m = pkg.Model(net, labels=labels)
    m.prepare(opt, loss)
    cb, seen = _Losses.make(pkg)
    if pkg is ptt:
        data = [torch.from_numpy(np.ascontiguousarray(a)) for a in data]
    m.fit(pkg.io.TensorDataset(data), batch_size=batch, shuffle=False,
          verbose=0, callbacks=[cb], **kw)
    return seen


@pytest.mark.parametrize("alias", [False, True],
                         ids=["accum_steps", "accumulate_grad_batches"])
def test_bert_accumulation_matches_the_reference(alias):
    paddle.seed(4)
    ref = JBert(JBertConfig(**CFG))
    ours = BertForPretraining(BertConfig(**CFG), device="cpu")
    ours.set_state_dict({k: _np(v) for k, v in ref.state_dict().items()})
    data = _bert_data()
    kw = {"accumulate_grad_batches" if alias else "accum_steps": 4}
    got = _fit(ptt, ours, ptt.optimizer.Momentum(
        0.05, parameters=ours.parameters()), _bert_loss(ptt.nn.functional),
        data, 8, ["mlm", "nsp"], **kw)
    want = _fit(paddle, ref, paddle.optimizer.Momentum(
        0.05, parameters=ref.parameters()),
        _bert_loss(paddle.nn.functional), data, 8, ["mlm", "nsp"],
        accum_steps=4)
    assert len(got) == 3
    np.testing.assert_allclose(got, want, **TOL)
    theirs = {k: _np(v) for k, v in ref.state_dict().items()}
    for k, v in ours.state_dict().items():
        np.testing.assert_allclose(_np(v), theirs[k], **TOL, err_msg=k)


def _conv_net(ns):
    return ns.Sequential(ns.Conv2D(3, 4, 3, padding=1), ns.BatchNorm2D(4),
                         ns.ReLU(), ns.Flatten(), ns.Linear(4 * 6 * 6, 5))


def test_conv_bn_accumulation_is_the_microbatch_loop():
    """Batch norm's running statistics see each microbatch in order.  The
    reference's ``fit(accum_steps=k)`` cannot run a batch-norm network (its
    scan carry takes a float32 running variance and returns a float64
    one: a ``TypeError``, ROADMAP.md §C), so the port's fit is held against
    ``microbatch_scan``'s semantics written out as an eager loop of the
    port: each microbatch's mean loss backpropagated into gradients summed
    from zero, then times 1/k and one LarsMomentum step; losses (float32
    sum of the microbatch losses times 1/k), weights and running
    statistics bitwise."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(12, 3, 6, 6).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 5, (12, 1)).astype(np.int64))
    F = ptt.nn.functional
    k, batch = 2, 4

    def fresh():
        ptt.seed(7)
        net = _conv_net(ptt.nn)
        return net, ptt.optimizer.LarsMomentum(0.1,
                                               parameters=net.parameters())

    net, opt = fresh()
    got = _fit(ptt, net, opt, lambda o, t: F.cross_entropy(o, t),
               [x.numpy(), y.numpy()], batch, accum_steps=k)
    twin, topt = fresh()
    twin.train()
    want = []
    for at in range(0, 12, batch):
        total = torch.zeros(())
        for j in range(k):
            sl = slice(at + j * batch // k, at + (j + 1) * batch // k)
            loss = F.cross_entropy(twin(x[sl]), y[sl]).mean()
            loss.backward()
            total = total + loss.detach()
        with torch.no_grad():
            for p in twin.parameters():
                p.grad.mul_(1.0 / k)
        topt.step()
        topt.clear_grad()
        want.append(float(total * (1.0 / k)))
    assert got == want
    theirs = twin.state_dict()
    for name, v in net.state_dict().items():
        assert torch.equal(v, theirs[name]), name
    paddle.seed(7)
    ref = _conv_net(paddle.nn)
    with pytest.raises(TypeError, match="carry"):
        _fit(paddle, ref, paddle.optimizer.LarsMomentum(
            0.1, parameters=ref.parameters()),
            lambda o, t: paddle.nn.functional.cross_entropy(o, t),
            [x.numpy(), y.numpy()], batch, accum_steps=k)


def _mlp():
    ptt.seed(2)
    return ptt.nn.Sequential(ptt.nn.Linear(6, 8), ptt.nn.Tanh(),
                             ptt.nn.Linear(8, 3))


def test_accum4_matches_accum1():
    rs = np.random.RandomState(5)
    data = [rs.randn(32, 6).astype(np.float32),
            rs.randn(32, 3).astype(np.float32)]

    def mse(out, label):
        return ((out - label) ** 2).mean()

    runs = []
    for k in (1, 4):
        net = _mlp()
        losses = _fit(ptt, net, ptt.optimizer.Adam(
            0.01, parameters=net.parameters()), mse, data, 8,
            accum_steps=k)
        runs.append((losses, [_np(p) for p in net.parameters()]))
    (l1, w1), (l4, w4) = runs
    np.testing.assert_allclose(l1, l4, **TOL)
    for a, b in zip(w1, w4):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_metric_sees_the_batch_in_global_order():
    """A metric's ``compute`` gets the re-merged outputs: the accuracy of
    an accumulated fit equals the eager evaluation of the same outputs."""
    rs = np.random.RandomState(6)
    x = rs.randn(16, 6).astype(np.float32)
    y = rs.randint(0, 3, (16, 1)).astype(np.int64)
    net = _mlp()
    model = ptt.Model(net).prepare(
        ptt.optimizer.SGD(0.0, parameters=net.parameters()),
        lambda out, label: ptt.nn.functional.cross_entropy(out, label),
        metrics=[ptt.metric.Accuracy()])
    model.fit(ptt.io.TensorDataset([torch.from_numpy(x),
                                    torch.from_numpy(y)]),
              batch_size=16, shuffle=False, verbose=0, accum_steps=4)
    with torch.no_grad():
        pred = net(torch.from_numpy(x)).argmax(-1).numpy()
    want = float((pred == y[:, 0]).mean())
    assert abs(model._metrics[0].accumulate() - want) < 1e-9


def test_microbatch_split_and_errors():
    x = torch.arange(12).reshape(6, 2)
    parts = microbatch_split([x, torch.tensor(3.0)], 3)
    assert len(parts) == 3
    assert torch.equal(torch.cat([p[0] for p in parts]), x)
    assert all(p[1].item() == 3.0 for p in parts)
    with pytest.raises(ValueError, match="not divisible by accum_steps=4"):
        microbatch_split([x], 4)
    net = _mlp()
    model = ptt.Model(net).prepare(
        ptt.optimizer.SGD(0.1, parameters=net.parameters()),
        lambda o, t: ((o - t) ** 2).mean())
    data = ptt.io.TensorDataset([torch.zeros(10, 6), torch.zeros(10, 3)])
    with pytest.raises(ValueError, match="not divisible"):
        model.fit(data, batch_size=10, verbose=0, accum_steps=4)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="accum_steps must be >= 1"):
            model.fit(data, batch_size=10, verbose=0, accum_steps=bad)
