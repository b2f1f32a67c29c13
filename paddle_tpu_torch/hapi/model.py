"""High-level Model API (port of paddle_tpu/hapi/model.py ``Model``:
``prepare``, ``train_batch``, ``eval_batch``, ``predict_batch``, ``fit``,
``evaluate``, ``predict``, ``save`` and ``load``).

Every batch runs on the network's own parameters, on the device they live
on; the step math is shared with the engines (hapi/engine.py).  ``fit``
drives the training engine: no host sync inside a step, losses fetched in
one copy at ``log_freq`` steps and epoch ends; on a CUDA device the step
of each batch signature is captured once as a CUDA graph and replayed, as
the reference compiles its donated step (``train_batch`` and a user's own
loop stay eager, as there).  ``evaluate``, ``eval_batch``, ``predict`` and
``predict_batch`` go through the eval engine, likewise one CUDA graph per
batch signature on the card, as the reference jits its eval step.

Metrics (``prepare(metrics=)``) and callbacks are the reference's: with
metrics or user callbacks, ``fit`` fetches each step's loss and what each
metric's ``compute`` returns, in one copy a step (the reference syncs every
step then too); without them a step stays sync-free.  The callback hooks
run in the reference's order.  ``save``/``load`` write and read the
reference's ``.pdparams``/``.pdopt`` files, in place.
Not ported yet (ROADMAP.md): gradient accumulation
(``accumulate_grad_batches`` other than 1), DataLoader worker processes,
fault tolerance and resume, meshes and layouts, recompute, AMP, telemetry
and tracing, and ``serve``.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..framework.io_state import load as _load
from ..framework.io_state import save as _save
from ..io import DataLoader
from ..metric import Metric, _host
from ..models.convert import load_numpy_optimizer_state
from ..nn.layer_base import set_state_dict
from .callbacks import (CallbackList, LRScheduler, ModelCheckpoint,
                        ProgBarLogger, config_callbacks)
from .engine import (EvalEngine, TrainEngine, _map, _to_list,
                     build_eval_step, build_train_step, fetch, to_device)


def _no_workers(num_workers):
    if num_workers:
        raise NotImplementedError(
            "DataLoader worker processes are not ported yet (num_workers "
            "must be 0)")


def _copies(outs):
    return _map(torch.Tensor.clone, outs)


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step_fn = None
        self._engine = None
        self._eval_engine = None
        self._save_dir = None
        self.stop_training = False

    @property
    def device(self) -> torch.device:
        return next(self.network.parameters()).device

    # -- setup -------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """Set the optimizer, the loss and the metrics.  ``amp_configs`` is
        accepted and unused, as in the reference: mixed precision in
        ``fit`` comes from an enclosing ``amp.auto_cast`` (and
        ``amp.decorate`` for O2), whose policy the captured step is keyed
        on."""
        if optimizer is not None and optimizer._parameter_list is None:
            # the reference feeds the network's parameters to the
            # optimizer through its state pytrees; here it updates them
            optimizer._parameter_list = [
                p for p in self.network.parameters() if p.requires_grad]
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = [m for m in _to_list(metrics)
                         if isinstance(m, Metric)]
        self._train_step_fn = None
        self._engine = None
        self._eval_engine = None
        return self

    # -- metrics -----------------------------------------------------------
    def _metric_outputs(self, outs, labels):
        """What each metric's ``compute`` returns for a step's outputs
        (on the device; before the next replay overwrites them)."""
        if not self._metrics:
            return []
        labels = to_device(labels, self.device)
        return [_to_list(m.compute(*(_to_list(outs) + labels)))
                for m in self._metrics]

    def _update_metrics(self, per_metric, host):
        """``update`` of each metric with its fetched ``compute`` values,
        as numpy arrays (``host``: the flat list ``fetch`` gave for
        ``per_metric``)."""
        at = 0
        for m, vals in zip(self._metrics, per_metric):
            m.update(*(_host(v) for v in host[at:at + len(vals)]))
            at += len(vals)

    @staticmethod
    def _flat(per_metric):
        return [v for vals in per_metric for v in vals]

    # -- batch-level API ---------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        """One step on one batch; returns the loss as a float.  Its loss
        and the metrics' ``compute`` values come to the host in one
        copy."""
        if self._train_step_fn is None:
            self._train_step_fn = build_train_step(
                self.network, self._loss, self._optimizer)
        labels = to_device(_to_list(labels), self.device)
        self._optimizer.begin_step()
        loss, outs = self._train_step_fn(
            to_device(_to_list(inputs), self.device), labels)
        per_metric = self._metric_outputs(outs, labels)
        host = fetch([loss] + self._flat(per_metric))
        self._update_metrics(per_metric, host[1:])
        return float(host[0])

    def _eval(self, inputs, labels):
        """The eager eval step on one batch: (outputs, the mean loss or
        None); the eval engine's reference on the card."""
        loss, outs = build_eval_step(self.network, self._loss)(
            to_device(_to_list(inputs), self.device),
            to_device(_to_list(labels), self.device))
        return outs, loss

    def _eval_begin(self):
        if self._eval_engine is None:
            self._eval_engine = EvalEngine(self)
        return self._eval_engine.begin()

    def eval_batch(self, inputs, labels=None):
        """(copies of the outputs, the loss as a float; 0.0 without
        labels)."""
        engine = self._eval_begin()
        outs = _copies(engine.step(_to_list(inputs), _to_list(labels)))
        losses = engine.drain()
        return outs, losses[-1] if losses else 0.0

    def predict_batch(self, inputs):
        """Copies of the outputs of one batch."""
        return _copies(self._eval_begin().step(_to_list(inputs), []))

    # -- loops ---------------------------------------------------------------
    def _split_batch(self, batch):
        n_label = len(_to_list(self._labels)) or 1
        if len(batch) == 1:
            return batch, []
        return batch[:-n_label], batch[-n_label:]

    def _loader(self, data, batch_size, shuffle, drop_last=False):
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """Train for ``epochs`` over ``train_data`` (a Dataset or a
        DataLoader), with the reference's options and callback order:
        ``eval_data`` is evaluated every ``eval_freq`` epochs, a
        ``ModelCheckpoint`` saves to ``save_dir`` every ``save_freq``
        epochs and at the end, ``num_iters`` ends training after that many
        steps, a callback may set ``stop_training``.  ``drop_last`` drops
        an epoch's last, short batch (a Dataset only).  Returns the
        history: ``loss`` (each epoch's mean loss), ``eval_loss`` (with
        ``eval_data``) and ``step_loss`` (every step's loss)."""
        _no_workers(num_workers)
        if accumulate_grad_batches != 1:
            raise NotImplementedError(
                "gradient accumulation (accumulate_grad_batches != 1) is "
                "not ported yet")
        loader = self._loader(train_data, batch_size, shuffle, drop_last)
        self._save_dir = save_dir
        self.stop_training = False
        cbks = config_callbacks(
            callbacks, model=self, batch_size=batch_size, epochs=epochs,
            steps=len(loader), log_freq=log_freq, verbose=verbose,
            save_freq=save_freq, save_dir=save_dir,
            metrics=[m._name for m in self._metrics])
        # the reference drains every step when a callback of the user's or
        # a metric needs fresh values; otherwise at log steps and epoch ends
        user_cbs = any(not isinstance(c, (ProgBarLogger, LRScheduler,
                                          ModelCheckpoint)) for c in cbks)
        eager_sync = user_cbs or bool(self._metrics)
        if self._engine is None:
            self._engine = TrainEngine(self)
        engine = self._engine.begin()
        history = {"loss": [], "step_loss": []}
        it_count = 0
        try:
            cbks.on_train_begin({})
            for epoch in range(epochs):
                self.network.train()
                for m in self._metrics:
                    m.reset()
                cbks.on_epoch_begin(epoch, {})
                losses = []
                for step_i, batch in enumerate(loader):
                    cbks.on_train_batch_begin(step_i, {})
                    inputs, labels = self._split_batch(_to_list(batch))
                    if user_cbs:
                        # a callback may have replaced a parameter or a
                        # slot the graphs hold (weight clipping through
                        # p.data, a loaded optimizer state); the last step
                        # was drained, so no replay is pending
                        engine.refresh()
                    outs = engine.step(inputs, labels)
                    it_count += 1
                    log_step = bool(log_freq) and step_i % log_freq == 0
                    if eager_sync:
                        per_metric = self._metric_outputs(outs, labels)
                        new, host = engine.ring.drain_with(
                            self._flat(per_metric))
                        losses.extend(new)
                        self._update_metrics(per_metric, host)
                    elif log_step:
                        losses.extend(engine.drain())
                    logs = {"loss": losses[-1] if losses else float("nan"),
                            "batch_size": batch_size}
                    if user_cbs or log_step:
                        for m in self._metrics:
                            logs[m._name] = np.mean(
                                _to_list(m.accumulate()))
                    cbks.on_train_batch_end(step_i, logs)
                    if num_iters is not None and it_count >= num_iters:
                        break
                losses.extend(engine.drain())
                history["step_loss"].extend(losses)
                history["loss"].append(
                    float(np.mean(losses)) if losses else float("nan"))
                epoch_logs = {"loss": history["loss"][-1]}
                for m in self._metrics:
                    epoch_logs[m._name] = np.mean(_to_list(m.accumulate()))
                if eval_data is not None and (epoch + 1) % eval_freq == 0:
                    cbks.on_eval_begin({})
                    eval_res = self.evaluate(eval_data,
                                             batch_size=batch_size,
                                             verbose=0)
                    history.setdefault("eval_loss", []).append(
                        eval_res.get("loss"))
                    epoch_logs.update({f"eval_{k}": v
                                       for k, v in eval_res.items()})
                    cbks.on_eval_end(eval_res)
                cbks.on_epoch_end(epoch, epoch_logs)
                if self.stop_training:
                    break
                if num_iters is not None and it_count >= num_iters:
                    break
        finally:
            engine.finish()
            # a crash mid-fit must still flush and close callback resources
            cbks.on_train_end({})
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """The mean loss over ``eval_data`` and each metric's value.  The
        per-batch losses stay on the device and are fetched in one copy at
        the end; with metrics each batch's ``compute`` values are fetched
        (one copy a batch).  ``callbacks`` get ``on_eval_begin``, the batch
        hooks (logs: ``batch_size`` and the metrics' running values) and
        ``on_eval_end``; ``num_samples`` stops after the batch that reaches
        that many samples.  ``log_freq`` is accepted, as the reference
        does, and unused."""
        _no_workers(num_workers)
        loader = self._loader(eval_data, batch_size, shuffle=False)
        for m in self._metrics:
            m.reset()
        cbks = CallbackList(callbacks)
        cbks.set_model(self)
        engine = self._eval_begin()
        cbks.on_eval_begin({})
        seen = 0
        for step_i, batch in enumerate(loader):
            if num_samples is not None and seen >= num_samples:
                break
            cbks.on_eval_batch_begin(step_i, {})
            inputs, labels = self._split_batch(_to_list(batch))
            outs = engine.step(inputs, labels)
            n = len(inputs[0]) if inputs else 0
            seen += n
            logs = {"batch_size": n}
            if self._metrics:
                per_metric = self._metric_outputs(outs, labels)
                self._update_metrics(per_metric,
                                     fetch(self._flat(per_metric)))
                for m in self._metrics:
                    logs[m._name] = np.mean(_to_list(m.accumulate()))
            cbks.on_eval_batch_end(step_i, logs)
        losses = engine.drain()
        res = {"loss": float(np.mean(losses)) if losses else 0.0}
        for m in self._metrics:
            res[m._name] = m.accumulate()
        cbks.on_eval_end(res)
        if verbose:
            print("Eval:", res, flush=True)
        return res

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """Each batch's outputs (copies), through the eval engine; with
        ``stack_outputs`` a network of one output gives ``[all batches'
        outputs concatenated]``.  ``verbose`` and ``callbacks`` are
        accepted and unused, as in the reference."""
        _no_workers(num_workers)
        loader = self._loader(test_data, batch_size, shuffle=False)
        engine = self._eval_begin()
        outputs = []
        for batch in loader:
            inputs, _ = self._split_batch(_to_list(batch))
            outputs.append(_copies(engine.step(inputs, [])))
        if stack_outputs and outputs and isinstance(outputs[0],
                                                     torch.Tensor):
            return [torch.cat(outputs, 0)]
        return outputs

    # -- persistence -------------------------------------------------------
    def _opt_state(self):
        """The optimizer's slots as the reference's state pytree, {param
        name: {slot: tensor}} over every trainable parameter (a parameter
        the optimizer holds no slot for yet gets its initial slots), or
        None before the optimizer's first slot."""
        opt = self._optimizer
        if not opt._slots:
            return None
        return {n: opt._slots.get(id(p)) or {
                    s: opt._init_slot(s, p.detach())
                    for s in opt._slot_names()}
                for n, p in self.network.named_parameters()
                if p.requires_grad}

    def save(self, path, training=True):
        """``path.pdparams``: the network's state dict; with ``training``
        and an optimizer, ``path.pdopt``: ``{"step_count", "opt_state"}``
        (the reference's files; bfloat16 written as float32)."""
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            payload = {"step_count": self._optimizer._step_count}
            opt_state = self._opt_state()
            if opt_state is not None:
                payload["opt_state"] = opt_state
            _save(payload, path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Read ``path.pdparams`` (and, unless ``reset_optimizer``,
        ``path.pdopt``) written by either package, into the network's
        parameters and the optimizer's slots in place, so captured graphs
        stay valid (a slot the optimizer did not hold yet is made anew).
        ``skip_mismatch`` skips, with a warning, the entries whose shape
        differs from the network's; else a mismatch raises ValueError."""
        state = _load(path + ".pdparams")
        if skip_mismatch:
            own = self.network.state_dict()
            skipped = [k for k, v in state.items()
                       if k in own and tuple(np.shape(v)) != tuple(
                           own[k].shape)]
            if skipped:
                warnings.warn(f"load: skipped {skipped}, whose shapes "
                              "differ from the network's")
            state = {k: v for k, v in state.items() if k not in skipped}
        set_state_dict(self.network, state)
        opt_path = path + ".pdopt"
        if not reset_optimizer and os.path.exists(opt_path) \
                and self._optimizer is not None:
            payload = _load(opt_path)
            step = payload.get("step_count", 0)
            self._optimizer._step_count = step
            if "opt_state" in payload:
                load_numpy_optimizer_state(
                    self._optimizer, self.network, payload["opt_state"],
                    step)
        return self
