"""The port's ``Model.fit`` user surface against the JAX package's, on the
CPU: metrics, callbacks, ``evaluate``/``predict``, ``save``/``load``,
``Layer.set_state_dict`` and the eval engine.

A small GPTForCausalLM (tests/test_generation_serving.py's sizes: vocab
211, hidden 48, 2 layers, 4 heads, dropout 0) is built by the JAX package
and its weights carried over by name.  Inputs come from numpy seeds.
Tolerances: metric counts exact, Auc and precision/recall at 1e-6, losses
and metric values of ``fit`` at rtol 1e-5, outputs at rtol 1e-5 / atol
1e-6 (float32), parameters carried by ``save``/``load`` exact.

- each metric against the reference's, tied scores included: the port
  ranks ties by a stable sort of ``-pred`` (lower class first); the
  reference's ``np.argsort(-pred)`` does so for up to three classes, so
  ties are held against it at 2 and 3 classes and against a stable sort
  at 10;
- ``fit``'s callback hooks in the reference's order; ``EarlyStopping``
  stopping at the reference's epoch; the ``LRScheduler`` callback's lr
  curve; the ``VisualDL`` and ``ModelCheckpoint`` files; ``fit`` with a
  metric (history and metric values); ``evaluate`` and
  ``predict(stack_outputs=)``;
- ``Layer.set_state_dict``'s ``(missing, unexpected)`` and shape error;
- ``save``/``load`` both ways, float32 and bfloat16 parameters: the
  parameters arrive exactly, the loaded model's outputs and its continued
  training follow the saving framework's;
- the eval engine's graph path through a CPU stand-in for the capture,
  bitwise the eager ``_eval``; the engines' fresh grad accumulators;
- ``setup_logger``: the same handlers, level and file lines as the
  reference's, and idempotent.
"""
import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import metric as jmetric
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.hapi import logger as jlogger
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.nn.layer_base import state_pytrees
from paddle_tpu.tensor import unwrap
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.hapi import logger as tlogger
from paddle_tpu_torch.hapi.engine import (EvalEngine, _fresh_grad_accumulators,
                                          _StepGraph, fetch)
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, load_numpy_state

CFG = dict(vocab_size=211, hidden_size=48, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0, attn_dropout=0.0)
FIT_TOL = dict(rtol=1e-5, atol=1e-7)
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
DATA = np.random.RandomState(11).randint(0, 211, (12, 16))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def state0():
    paddle.seed(0)
    return _np(state_pytrees(JGPTForCausalLM(JGPTConfig(**CFG)))[0])


def _jax_net(state, dtype=None):
    paddle.seed(0)
    net = JGPTForCausalLM(JGPTConfig(**CFG))
    net.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    if dtype is not None:
        net.astype(dtype)
    return net


def _port_net(state, dtype=torch.float32):
    net = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_numpy_state(net, state)
    return net.to(dtype)


def _jax_lm_loss(logits, labels):
    lv = logits.value if hasattr(logits, "value") else logits
    yv = labels.value if hasattr(labels, "value") else labels
    logp = jax.nn.log_softmax(lv[:, :-1].astype(jnp.float32), axis=-1)
    return -jnp.take_along_axis(logp, yv[:, 1:, None], axis=-1)[..., 0].mean()


def _torch_lm_loss(logits, labels):
    logp = torch.log_softmax(logits[:, :-1].float(), -1)
    return -logp.gather(-1, labels[:, 1:, None].long())[..., 0].mean()


def _jax_model(net, metrics=None, lr=LR, opt=None):
    model = paddle.Model(net)
    model.prepare(opt or paddle.optimizer.AdamW(
        learning_rate=lr, parameters=net.parameters()), _jax_lm_loss,
        metrics=metrics)
    return model


def _port_model(net, metrics=None, lr=LR, opt=None):
    return ptt.Model(net).prepare(opt or ptt.optimizer.AdamW(
        learning_rate=lr, parameters=net.parameters()), _torch_lm_loss,
        metrics=metrics)


def _jax_data(rows=DATA):
    t = paddle.to_tensor(rows)
    return paddle.io.TensorDataset([t, t])


def _port_data(rows=DATA):
    t = torch.from_numpy(rows)
    return ptt.io.TensorDataset([t, t])


# -- metrics -----------------------------------------------------------------
def _tied_scores(rs, n, c):
    """Scores with many ties: small integers."""
    return rs.randint(0, 3, (n, c)).astype(np.float32)


def _both_accuracies(topk, pred, label, reference=True):
    """Run the port's and the reference's Accuracy over the same batches;
    returns (port compute, update values, accumulate) and the
    reference's."""
    out = []
    for mod, wrap in ((tmetric, torch.from_numpy),
                      (jmetric, paddle.to_tensor)):
        if mod is jmetric and not reference:
            break
        m = mod.Accuracy(topk=topk)
        res = []
        for p, y in zip(pred, label):
            c = np.asarray(unwrap(m.compute(wrap(p), wrap(y))))
            res.append((c, m.update(c)))
        out.append((res, m.accumulate()))
    return out


@pytest.mark.parametrize("classes", [2, 3])
@pytest.mark.parametrize("topk", [(1,), (1, 2)])
def test_accuracy_matches_reference_on_tied_scores(classes, topk):
    rs = np.random.RandomState(classes)
    pred = [_tied_scores(rs, 16, classes) for _ in range(3)]
    label = [rs.randint(0, classes, (16, 1)) for _ in range(3)]
    (port, port_acc), (ref, ref_acc) = _both_accuracies(topk, pred, label)
    for (c, u), (rc, ru) in zip(port, ref):
        np.testing.assert_array_equal(c, rc)
        np.testing.assert_array_equal(u, ru)
    assert port_acc == ref_acc


def test_accuracy_ranks_ties_by_a_stable_sort():
    """Ten classes: ties in a stable sort's order (the lower class first),
    and without ties the reference's counts."""
    rs = np.random.RandomState(4)
    pred = [_tied_scores(rs, 32, 10) for _ in range(2)]
    label = [rs.randint(0, 10, (32,)) for _ in range(2)]
    ((port, _),) = _both_accuracies((1, 5), pred, label, reference=False)
    for (c, _), p, y in zip(port, pred, label):
        idx = np.argsort(-p, axis=-1, kind="stable")[:, :5]
        np.testing.assert_array_equal(c, idx == y[:, None])
    pred = [rs.randn(32, 10).astype(np.float32) for _ in range(2)]
    (port, port_acc), (ref, ref_acc) = _both_accuracies((1, 5), pred, label)
    for (c, _), (rc, _) in zip(port, ref):
        np.testing.assert_array_equal(c, rc)
    assert port_acc == ref_acc


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy_function_matches_reference(k):
    rs = np.random.RandomState(k)
    pred, label = _tied_scores(rs, 64, 5), rs.randint(0, 5, (64, 1))
    got = tmetric.accuracy(torch.from_numpy(pred), torch.from_numpy(label),
                           k=k)
    want = jmetric.accuracy(paddle.to_tensor(pred), paddle.to_tensor(label),
                            k=k)
    assert float(got) == float(np.asarray(unwrap(want)))


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_reference(name):
    rs = np.random.RandomState(7)
    port, ref = getattr(tmetric, name)(), getattr(jmetric, name)()
    for _ in range(3):
        p = rs.rand(50, 2).astype(np.float32) if name == "Auc" \
            else rs.rand(50).astype(np.float32)
        y = rs.randint(0, 2, (50,))
        port.update(torch.from_numpy(p), torch.from_numpy(y))
        ref.update(paddle.to_tensor(p), paddle.to_tensor(y))
    np.testing.assert_allclose(port.accumulate(), ref.accumulate(),
                               rtol=1e-6, atol=0)


def test_precision_recall_metric_matches_reference():
    rs = np.random.RandomState(8)
    port, ref = tmetric.PrecisionRecall(4), jmetric.PrecisionRecall(4)
    for _ in range(3):
        p, y = rs.randn(40, 4).astype(np.float32), rs.randint(-1, 5, (40,))
        port.update(torch.from_numpy(p), torch.from_numpy(y))
        ref.update(paddle.to_tensor(p), paddle.to_tensor(y))
    np.testing.assert_allclose(port.accumulate(), ref.accumulate(),
                               rtol=1e-6, atol=0)


def test_mean_iou_and_edit_distance_match_reference():
    rs = np.random.RandomState(9)
    p, y = rs.randint(-1, 5, (6, 7)), rs.randint(0, 5, (6, 7))
    got = tmetric.mean_iou(torch.from_numpy(p), torch.from_numpy(y), 5)
    want = jmetric.mean_iou(paddle.to_tensor(p), paddle.to_tensor(y), 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(unwrap(w)),
                                   rtol=1e-6)
    h, r = rs.randint(0, 4, (3, 6)), rs.randint(0, 4, (3, 5))
    hl, rl = np.array([6, 3, 0]), np.array([5, 5, 2])
    for norm in (True, False):
        d, n = tmetric.edit_distance(h, hl, r, rl, normalized=norm)
        wd, wn = jmetric.edit_distance(h, hl, r, rl, normalized=norm)
        np.testing.assert_array_equal(d.numpy(), np.asarray(unwrap(wd)))
        assert n == wn


def test_chunk_evaluator_and_detection_map_match_reference():
    rs = np.random.RandomState(10)
    for scheme in ("IOB", "IOBES"):
        port = tmetric.ChunkEvaluator(scheme=scheme, num_chunk_types=3)
        ref = jmetric.ChunkEvaluator(scheme=scheme, num_chunk_types=3)
        n_tags = 3 * len(tmetric.ChunkEvaluator._ROLES[scheme]) + 1
        for _ in range(2):
            inf, lab = rs.randint(0, n_tags, (2, 4, 12))
            lens = rs.randint(1, 13, (4,))
            port.update(inf, lab, lens)
            ref.update(inf, lab, lens)
        assert port.accumulate() == ref.accumulate()
    for ap in ("integral", "11point"):
        port, ref = tmetric.DetectionMAP(ap_version=ap), \
            jmetric.DetectionMAP(ap_version=ap)
        for _ in range(3):
            gt = rs.rand(4, 2) * 10
            gb = np.concatenate([gt, gt + 1 + rs.rand(4, 2) * 5], 1)
            db = gb[rs.randint(0, 4, 6)] + rs.randn(6, 4) * 0.5
            args = (db, rs.rand(6), rs.randint(0, 2, 6), gb,
                    rs.randint(0, 2, 4))
            port.update(*args)
            ref.update(*args)
        assert port.accumulate() == pytest.approx(ref.accumulate(),
                                                  rel=1e-12)


# -- callbacks ---------------------------------------------------------------
def _recorder(base):
    class Recorder(base):
        """Every hook fit calls, with its step or epoch and the keys of
        its logs."""

        def __init__(self):
            super().__init__()
            self.calls = []

        def _rec(self, name, *args):
            key = args[0] if args and not isinstance(args[0], dict) else None
            logs = args[-1] if args and isinstance(args[-1], dict) else {}
            self.calls.append((name, key, tuple(sorted(logs or {}))))

    for hook in [h for h in dir(base) if h.startswith("on_")]:
        setattr(Recorder, hook,
                lambda self, *a, _h=hook: self._rec(_h, *a))
    return Recorder()


def test_fit_calls_the_callback_hooks_in_the_reference_order(state0):
    """Two epochs of 3 steps with eval data and a metric: the same hooks,
    steps, epochs and log keys, in the same order."""
    runs = []
    for build, data, base, acc in (
            (lambda: _jax_model(_jax_net(state0),
                                [jmetric.Accuracy()]), _jax_data,
             jcb.Callback, None),
            (lambda: _port_model(_port_net(state0),
                                 [tmetric.Accuracy()]), _port_data,
             tcb.Callback, None)):
        rec = _recorder(base)
        build().fit(data(DATA[:6]), eval_data=data(DATA[6:10]),
                    batch_size=2, epochs=2, verbose=0, shuffle=False,
                    callbacks=[rec])
        runs.append(rec.calls)
    assert runs[0] == runs[1]
    assert runs[1][0][0] == "on_train_begin" and len(runs[1]) == 22


@pytest.mark.parametrize("monitor", ["loss", "eval_loss"])
def test_early_stopping_stops_at_the_reference_epoch(state0, tmp_path,
                                                     monitor):
    """EarlyStopping in "min" mode with patience 1 over 5 epochs with eval
    data.  On "loss" (the eval logs' loss at on_eval_end): at lr 1e-2 the
    held-out loss rises after the first epoch, so both stop after the
    second and save the first epoch's model as the best.  The eval logs carry no "eval_loss" and the epoch
    check is skipped once an eval ran, so on "eval_loss" neither stops nor
    saves, in the reference as in the port."""
    runs = []
    for i, (build, data, mod) in enumerate((
            (lambda: _jax_model(_jax_net(state0), lr=1e-2), _jax_data, jcb),
            (lambda: _port_model(_port_net(state0), lr=1e-2), _port_data,
             tcb))):
        stop = mod.EarlyStopping(monitor=monitor, mode="min", patience=1,
                                 verbose=0)
        save_dir = str(tmp_path / str(i))
        hist = build().fit(data(DATA[:4]), eval_data=data(DATA[4:8]),
                           batch_size=2, epochs=5, verbose=0, shuffle=False,
                           save_dir=save_dir, callbacks=[stop])
        runs.append((len(hist["loss"]), stop.stopped_epoch, os.path.exists(
            os.path.join(save_dir, "best_model.pdparams"))))
    assert runs[0] == runs[1] == ((2, 1, True) if monitor == "loss"
                                  else (5, 0, False))


@pytest.mark.parametrize("by_epoch", [False, True])
def test_lr_scheduler_callback_lr_curve_matches_reference(state0, by_epoch):
    curves = []
    for net, model_of, opt_mod, mod, data in (
            (_jax_net(state0), _jax_model, paddle.optimizer, jcb,
             _jax_data),
            (_port_net(state0), _port_model, ptt.optimizer, tcb,
             _port_data)):
        sched = opt_mod.lr.StepDecay(0.01, step_size=2, gamma=0.5)
        opt = (opt_mod.SGD(learning_rate=sched,
                           parameters=net.parameters()))
        seen = []

        class Lr(mod.Callback):
            def on_train_batch_begin(self, step, logs=None):
                seen.append(opt.get_lr())

        model_of(net, opt=opt).fit(
            data(DATA[:6]), batch_size=2, epochs=3, verbose=0,
            shuffle=False, callbacks=[Lr(), mod.LRScheduler(
                by_step=not by_epoch, by_epoch=by_epoch)])
        curves.append(seen)
    assert len(curves[1]) == 9
    np.testing.assert_allclose(curves[1], curves[0], rtol=1e-12)


def test_visualdl_and_checkpoint_files_match_reference(state0, tmp_path):
    """fit with save_dir and VisualDL: the same checkpoint files (epochs
    and final) with the same keys, and a scalars.jsonl line a step with
    the reference's steps, keys and losses."""
    outs = []
    for i, (build, data, mod) in enumerate((
            (lambda: _jax_model(_jax_net(state0), [jmetric.Accuracy()]),
             _jax_data, jcb),
            (lambda: _port_model(_port_net(state0), [tmetric.Accuracy()]),
             _port_data, tcb))):
        root = tmp_path / str(i)
        build().fit(data(DATA[:6]), batch_size=2, epochs=2, verbose=0,
                    shuffle=False, save_dir=str(root / "ckpt"),
                    callbacks=[mod.VisualDL(str(root / "vdl"))])
        lines = [json.loads(x) for x in
                 (root / "vdl" / "scalars.jsonl").read_text().splitlines()]
        files = sorted(os.listdir(root / "ckpt"))
        opt = ptt.load(str(root / "ckpt" / "final.pdopt"))
        outs.append((lines, files, sorted(ptt.load(
            str(root / "ckpt" / "final.pdparams"))), opt))
    (lines, files, keys, opt), (t_lines, t_files, t_keys, t_opt) = outs
    assert t_files == files == sorted(
        f"{n}.{e}" for n in ("0", "1", "final") for e in ("pdopt",
                                                          "pdparams"))
    assert t_keys == keys and len(t_lines) == len(lines) == 6
    for a, b in zip(t_lines, lines):
        assert sorted(a) == sorted(b) and a["step"] == b["step"]
        np.testing.assert_allclose([a["loss"], a["acc"]],
                                   [b["loss"], b["acc"]], **FIT_TOL)
    assert t_opt["step_count"] == opt["step_count"] == 6
    for name, slots in opt["opt_state"].items():
        for slot, v in slots.items():
            np.testing.assert_allclose(t_opt["opt_state"][name][slot], v,
                                       rtol=1e-4, atol=1e-6)


def test_fit_with_a_metric_matches_reference(state0):
    """History, every step's loss and the metric's epoch values (through
    a user callback, which also makes both drain every step)."""
    runs = []
    for build, data, mod in (
            (lambda: _jax_model(_jax_net(state0), [jmetric.Accuracy(
                topk=(1, 3))]), _jax_data, jcb),
            (lambda: _port_model(_port_net(state0), [tmetric.Accuracy(
                topk=(1, 3))]), _port_data, tcb)):
        logs = []

        class Logs(mod.Callback):
            def on_train_batch_end(self, step, l=None):
                logs.append((l["loss"], l["acc"]))

            def on_epoch_end(self, epoch, l=None):
                logs.append((l["loss"], l["acc"], l["eval_loss"],
                             np.mean(l["eval_acc"])))

        hist = build().fit(data(DATA[:8]), eval_data=data(DATA[8:]),
                           batch_size=4, epochs=2, verbose=0, shuffle=False,
                           callbacks=[Logs()])
        runs.append((hist, logs))
    (hist, logs), (t_hist, t_logs) = runs
    for key in ("loss", "eval_loss"):
        np.testing.assert_allclose(t_hist[key], hist[key], **FIT_TOL)
    assert len(t_logs) == len(logs) == 6
    for a, b in zip(t_logs, logs):
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   **FIT_TOL)


def test_evaluate_and_predict_match_reference(state0):
    """evaluate's loss and metric; predict's outputs batch by batch and
    stacked, on the same weights."""
    rows = DATA[:5]
    jm = _jax_model(_jax_net(state0), [jmetric.Accuracy()])
    tm = _port_model(_port_net(state0), [tmetric.Accuracy()])
    res = jm.evaluate(_jax_data(rows), batch_size=2, verbose=0)
    t_res = tm.evaluate(_port_data(rows), batch_size=2, verbose=0)
    assert sorted(t_res) == sorted(res)
    np.testing.assert_allclose(t_res["loss"], res["loss"], **FIT_TOL)
    assert t_res["acc"] == res["acc"]
    ids_j = paddle.io.TensorDataset([paddle.to_tensor(rows)])
    ids_t = ptt.io.TensorDataset([torch.from_numpy(rows)])
    for stack in (False, True):
        want = jm.predict(ids_j, batch_size=2, stack_outputs=stack)
        got = tm.predict(ids_t, batch_size=2, stack_outputs=stack)
        assert len(got) == len(want) == (1 if stack else 3)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(unwrap(w)),
                                       **OUT_TOL)


def test_fit_options(state0, tmp_path):
    """num_iters ends training after that many steps (across epochs);
    eval_freq evaluates every that many epochs; a callback's
    stop_training ends the epoch loop; accumulate_grad_batches that does
    not divide the batch raises; worker processes feed a fit that trains;
    evaluate's num_samples stops after the
    batch that reaches it, and its callbacks get the eval hooks."""
    model = _port_model(_port_net(state0))
    hist = model.fit(_port_data(DATA[:6]), eval_data=_port_data(DATA[6:8]),
                     batch_size=2, epochs=4, verbose=0, shuffle=False,
                     eval_freq=2, num_iters=5)
    assert len(hist["step_loss"]) == 5 and len(hist["loss"]) == 2
    assert len(hist["eval_loss"]) == 1

    class Stop(tcb.Callback):
        def on_epoch_end(self, epoch, logs=None):
            self.model.stop_training = True

    hist = model.fit(_port_data(DATA[:6]), batch_size=2, epochs=3,
                     verbose=0, callbacks=[Stop()])
    assert len(hist["loss"]) == 1
    # accumulation runs since it was ported (tests/test_torch_accum.py):
    # a batch of 1 that 2 microbatches cannot split raises, as in the
    # reference
    with pytest.raises(ValueError, match="not divisible"):
        model.fit(_port_data(DATA[:6]), accumulate_grad_batches=2)
    # worker processes feed fit: it trains, as without them
    hist = model.fit(_port_data(DATA[:6]), batch_size=2, num_workers=2,
                     shuffle=False, verbose=0)
    assert len(hist["step_loss"]) == 3
    assert all(np.isfinite(v) for v in hist["step_loss"])
    rec = _recorder(tcb.Callback)
    res = model.evaluate(_port_data(DATA[:6]), batch_size=2, verbose=0,
                         num_samples=3, callbacks=[rec])
    assert np.isfinite(res["loss"])
    # two batches reach 3 samples: the hooks of two batches
    assert [c[:2] for c in rec.calls] == [
        ("on_eval_begin", None), ("on_eval_batch_begin", 0),
        ("on_eval_batch_end", 0), ("on_eval_batch_begin", 1),
        ("on_eval_batch_end", 1), ("on_eval_end", None)]


# -- set_state_dict, save and load -------------------------------------------
def test_set_state_dict_reports_and_checks_like_the_reference(state0):
    net, jnet = _port_net(state0), _jax_net(state0)
    w = "gpt.ln_f.weight"
    new = {w: np.full(48, 2.0, np.float32), "extra": np.zeros(3)}
    want = jnet.set_state_dict({k: paddle.to_tensor(v)
                                for k, v in new.items()})
    ptr = net.state_dict()[w].data_ptr()
    assert net.set_state_dict(new) == want
    assert net.state_dict()[w].data_ptr() == ptr       # in place
    assert torch.equal(net.state_dict()[w], torch.full((48,), 2.0))
    assert net.load_dict is not None and net.set_dict is not None
    missing, unexpected = net.set_dict({w: torch.ones(48,
                                                      dtype=torch.float64)})
    assert unexpected == [] and w not in missing and len(missing) == len(
        state0) - 1
    with pytest.raises(ValueError):
        net.set_state_dict({w: np.zeros(47)})
    with pytest.raises(ValueError):
        jnet.set_state_dict({w: paddle.to_tensor(np.zeros(47))})


def test_save_writes_bfloat16_as_float32_and_load_names_ml_dtypes(
        tmp_path, monkeypatch):
    x = torch.randn(3, 4).to(torch.bfloat16)
    ptt.save({"a": x, "n": [torch.arange(3), 7]}, str(tmp_path / "s.pd"))
    back = ptt.load(str(tmp_path / "s.pd"))
    assert back["a"].dtype == np.float32 and back["n"][1] == 7
    assert torch.equal(torch.from_numpy(back["a"]).to(torch.bfloat16), x)
    np.testing.assert_array_equal(back["n"][0], [0, 1, 2])
    paddle.save({"a": paddle.to_tensor(np.ones(2, np.float32)).astype(
        "bfloat16")}, str(tmp_path / "ref.pd"))
    assert ptt.load(str(tmp_path / "ref.pd"))["a"].dtype.name == "bfloat16"
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError, match="ml_dtypes"):
        ptt.load(str(tmp_path / "ref.pd"))


def _params_np(named):
    return {k: np.asarray(v, np.float32) for k, v in named}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("saver", ["reference", "port"])
def test_save_and_load_between_the_packages(state0, tmp_path, dtype, saver):
    """One package trains 2 steps, saves and trains 3 more; the other
    loads the file into a fresh model and trains the same 3 steps: the
    parameters arrive exactly, the loaded model's outputs are the saver's
    (float32 at rtol 1e-5; bfloat16 within its rounding across the two
    frameworks) and its losses follow the saver's (the same tolerances).
    Within the loading package a model that loaded the file continues
    exactly as one given the same state in memory."""
    tdt = getattr(torch, dtype)
    jm = _jax_model(_jax_net(state0, dtype))
    tm = _port_model(_port_net(state0, tdt))
    path = str(tmp_path / "ckpt")
    first, rest = DATA[:4], DATA[4:10]
    src, dst = (jm, tm) if saver == "reference" else (tm, jm)
    src_data = _jax_data if saver == "reference" else _port_data
    dst_data = _port_data if saver == "reference" else _jax_data
    src.fit(src_data(first), batch_size=2, verbose=0, shuffle=False)
    src.save(path)
    want = src.fit(src_data(rest), batch_size=2, verbose=0,
                   shuffle=False)["loss"]
    dst.load(path)
    saved = {k: np.asarray(v, np.float32)
             for k, v in ptt.load(path + ".pdparams").items()}
    if saver == "reference":
        got_params = _params_np((k, v.detach().float().numpy())
                                for k, v in tm.network.state_dict().items())
    else:
        got_params = _params_np((k, np.asarray(unwrap(v), np.float32))
                                for k, v in jm.network.state_dict().items())
    assert sorted(got_params) == sorted(saved)
    for k in saved:
        # the loader casts to its parameter's dtype (the reference's
        # AdamW step leaves its bfloat16 parameters float32)
        want_k = torch.from_numpy(saved[k]).to(tdt).float().numpy()
        np.testing.assert_array_equal(got_params[k], want_k, err_msg=k)
    assert dst._optimizer._step_count == 2
    tol = OUT_TOL if dtype == "float32" else dict(rtol=2 ** -6, atol=2e-2)
    ids = DATA[10:]
    t_out = tm.predict_batch([torch.from_numpy(ids)]).float().numpy()
    j_out = np.asarray(unwrap(jm.predict_batch(
        [paddle.to_tensor(ids)])), np.float32)
    got = dst.fit(dst_data(rest), batch_size=2, verbose=0,
                  shuffle=False)["loss"]
    np.testing.assert_allclose(got, want, **(
        FIT_TOL if dtype == "float32" else tol))
    if saver == "reference":
        # the port's loaded outputs against the reference's at save time
        ref = _jax_model(_jax_net(state0, dtype))
        ref.load(path)
        np.testing.assert_allclose(t_out, np.asarray(unwrap(
            ref.predict_batch([paddle.to_tensor(ids)])), np.float32), **tol)
        twin = _port_model(_port_net(state0, tdt))
        twin.load(path)
    else:
        twin = None
        tm2 = _port_model(_port_net(state0, tdt))
        tm2.load(path)
        np.testing.assert_allclose(tm2.predict_batch(
            [torch.from_numpy(ids)]).float().numpy(), j_out, **tol)
    if twin is not None:
        # a model given the saved state in memory continues bitwise alike
        mem = _port_model(_port_net(state0, tdt))
        mem.network.set_state_dict(ptt.load(path + ".pdparams"))
        payload = ptt.load(path + ".pdopt")
        from paddle_tpu_torch.models import load_numpy_optimizer_state
        load_numpy_optimizer_state(mem._optimizer, mem.network,
                                   payload["opt_state"],
                                   payload["step_count"])
        a = twin.fit(_port_data(rest), batch_size=2, verbose=0,
                     shuffle=False)["step_loss"]
        b = mem.fit(_port_data(rest), batch_size=2, verbose=0,
                    shuffle=False)["step_loss"]
        assert a == b


def test_load_copies_in_place_and_skips_mismatches(state0, tmp_path):
    tm = _port_model(_port_net(state0))
    tm.fit(_port_data(DATA[:4]), batch_size=2, verbose=0, shuffle=False)
    path = str(tmp_path / "c")
    tm.save(path)
    ptrs = [p.data_ptr() for p in tm.network.parameters()] + [
        v.data_ptr() for s in tm._optimizer._slots.values()
        for v in s.values()]
    tm.fit(_port_data(DATA[4:8]), batch_size=2, verbose=0, shuffle=False)
    tm.load(path)
    assert ptrs == [p.data_ptr() for p in tm.network.parameters()] + [
        v.data_ptr() for s in tm._optimizer._slots.values()
        for v in s.values()]
    assert tm._optimizer._step_count == 2
    state = ptt.load(path + ".pdparams")
    state["gpt.ln_f.weight"] = np.zeros(5, np.float32)
    ptt.save(state, path + "x.pdparams")
    with pytest.raises(ValueError):
        tm.load(path + "x")
    with pytest.warns(UserWarning, match="gpt.ln_f.weight"):
        tm.load(path + "x", skip_mismatch=True, reset_optimizer=True)


# -- the engines ---------------------------------------------------------------
class _CpuEvalGraph:
    """Stands in for the CUDA capture on the CPU: the replay runs the eval
    body on the static buffers and writes the static outputs in place."""

    def __init__(self, engine):
        self.engine = engine

    def __call__(self, sig, s_in, s_lab):
        body = self.engine._body
        loss, outs = body(s_in, s_lab)

        def replay():
            l, o = body(s_in, s_lab)
            outs.copy_(o)
            if l is not None:
                loss.copy_(l)

        return _StepGraph(replay, s_in, s_lab, loss, outs, {})


def _stand_in_eval(model):
    engine = model._eval_engine = EvalEngine(model)
    engine._replaying = True
    engine._capture = _CpuEvalGraph(engine)
    return engine


def test_eval_graph_path_is_bitwise_the_eager_eval(state0):
    """evaluate, eval_batch and predict through the eval engine's graph
    path (the capture stood in by the eager body): losses and outputs
    bitwise the eager ``_eval``'s; one capture per signature (with and
    without labels, and the short last batch), the rest replays; predict
    returns copies a later replay leaves alone."""
    tm = _port_model(_port_net(state0), [tmetric.Accuracy()])
    eager = _port_model(_port_net(state0), [tmetric.Accuracy()])
    engine = _stand_in_eval(tm)
    rows = DATA[:7]
    res, ref = (m.evaluate(_port_data(rows), batch_size=2, verbose=0)
                for m in (tm, eager))
    assert res == ref and engine.captures == 2 and engine.replays == 2
    want = [eager._eval([torch.from_numpy(rows[i:i + 2])], [])[0]
            for i in range(0, 7, 2)]
    got = tm.predict(ptt.io.TensorDataset([torch.from_numpy(rows)]),
                     batch_size=2)
    assert engine.captures == 4 and engine.replays == 4
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0] is not got[1] and not torch.equal(got[0], got[1])
    outs, loss = tm.eval_batch([torch.from_numpy(rows[:2])],
                               [torch.from_numpy(rows[:2])])
    e_outs, e_loss = eager._eval([torch.from_numpy(rows[:2])],
                                 [torch.from_numpy(rows[:2])])
    assert torch.equal(outs, e_outs) and loss == float(e_loss)
    # a cast moves the parameters: the next begin() drops the graphs
    tm.network.to(torch.float64).to(torch.float32)
    tm.evaluate(_port_data(rows), batch_size=2, verbose=0)
    assert engine.captures == 6


def test_fresh_grad_accumulators_leave_the_parameter_as_it_was():
    """With an earlier step's graph alive, each parameter gets a new
    AccumulateGrad node; its address and gradient stay, and the next
    backward accumulates into the same gradient."""
    from torch.autograd.graph import get_gradient_edge

    p = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    kept = (p * 2).sum()
    kept.backward()
    old, ptr, grad = get_gradient_edge(p).node, p.data_ptr(), p.grad
    _fresh_grad_accumulators([p])
    assert p.data_ptr() == ptr and p.grad is grad
    assert p.dtype == torch.bfloat16 and p.shape == (4,)
    (p * 3).sum().backward()
    assert get_gradient_edge(p).node is not old and kept.grad_fn is not None
    assert torch.equal(p.grad, torch.full((4,), 5.0, dtype=torch.bfloat16))


def test_fetch_passes_host_values_through():
    xs = [torch.tensor(1.5), torch.tensor([True, False, True]),
          torch.arange(5, dtype=torch.int64),
          torch.tensor([0.25], dtype=torch.bfloat16), np.ones(2)]
    back = fetch(xs)
    assert all(torch.equal(a, b) for a, b in zip(back[:4], xs[:4]))
    assert back[4] is xs[4]


@pytest.mark.parametrize("output", ["dir", "run.log"])
def test_setup_logger_matches_the_reference(tmp_path, output):
    """Each package's ``setup_logger`` on a logger of its own, twice (the
    second call adds no handler): the same handler types, level and
    propagation, and the same message lines in the file (``output`` a
    directory gets ``log.txt``, a ``.log`` path is the file)."""
    got = []
    for mod in (jlogger, tlogger):
        base = tmp_path / mod.__name__
        base.mkdir()
        out = str(base) if output == "dir" else str(base / output)
        name = f"test_setup_logger.{mod.__name__}.{output}"
        for _ in range(2):
            log = mod.setup_logger(out, name=name, log_level=logging.DEBUG)
        log.debug("step %d", 3)
        log.warning("done")
        for h in log.handlers:
            h.flush()
        path = base / ("log.txt" if output == "dir" else output)
        lines = [ln.split(" - ", 1)[1] for ln in
                 path.read_text().splitlines()]
        got.append(([type(h).__name__ for h in log.handlers], log.level,
                     log.propagate, lines))
        for h in list(log.handlers):
            h.close()
            log.removeHandler(h)
    assert got[0] == got[1]
    assert got[1] == (["StreamHandler", "FileHandler"], logging.DEBUG, False,
                      ["DEBUG: step 3", "WARNING: done"])
