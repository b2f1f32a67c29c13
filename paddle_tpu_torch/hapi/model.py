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
``fit(accum_steps=k)`` (alias ``accumulate_grad_batches``) accumulates
gradients over k microbatches inside the one step, ``batch_size`` staying
the global batch.  ``fit(resume=, checkpoint_interval=, fault_tolerant=)``
writes durable checkpoints (distributed/checkpoint.py, the reference's
format) and resumes from the newest valid one, bit for bit.  ``fit`` and
``train_batch`` run the optimizer in the reference's ``apply_pytree`` form
(no per-parameter learning rates, AdamW decaying every parameter;
optimizer/__init__.py).  ``fit``, ``evaluate`` and ``predict`` take
``num_workers`` (io.DataLoader's worker processes); on a CUDA model they
set the loader's placement hook to ``io.pin_batch`` for the call, so the
reader's thread hands each batch over in page-locked memory, as the
reference installs its mesh placement for a fit.  :func:`summary` and
:func:`flops` are the reference's ``paddle.summary`` and ``paddle.flops``.
``serve`` and ``serve_generate`` put the network behind the HTTP front end
(serving/server.py): the adaptive batcher over one CUDA graph a bucket, or
the continuous-batching generation engine.
Not ported yet (ROADMAP.md): meshes and layouts, recompute, and telemetry.
"""
from __future__ import annotations

import logging
import os
import warnings

import numpy as np
import torch

from ..distributed.checkpoint import AsyncCheckpointer, CheckpointManager
from ..distributed.resilience import (DURABILITY_EXIT_CODE,
                                      PREEMPTED_EXIT_CODE, PreemptionGuard)
from ..framework.flags import flag
from ..framework.io_state import load as _load
from ..framework.io_state import save as _save
from ..io import DataLoader, pin_batch
from ..metric import Metric, _host
from ..models.convert import load_numpy_optimizer_state
from ..nn.layer_base import set_state_dict
from ..utils import chaos
from .callbacks import (CallbackList, LRScheduler, ModelCheckpoint,
                        ProgBarLogger, config_callbacks)
from .engine import (EvalEngine, TrainEngine, _map, _to_list,
                     build_eval_step, build_train_step, fetch, to_device)

logger = logging.getLogger("paddle_tpu_torch.hapi")


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
        return next(iter(self.network.parameters())).device

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        """Parameter summary (hapi ``Model.summary``)."""
        return summary(self.network, input_size, dtype)

    # -- setup -------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """Set the optimizer, the loss and the metrics.  ``amp_configs`` is
        accepted and unused, as in the reference: mixed precision in
        ``fit`` comes from an enclosing ``amp.auto_cast`` (and
        ``amp.decorate`` for O2), whose policy the captured step is keyed
        on."""
        if optimizer is not None and getattr(
                optimizer, "_parameter_list", ()) is None:
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
        self._optimizer.begin_step(pytree=True)
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

    def eval_batch_no_loss(self, inputs):
        """(copies of the outputs of one batch, a 0-d float32 zero): the
        reference's eval step without labels, whose loss is zero."""
        return self.predict_batch(inputs), torch.zeros((),
                                                       device=self.device)

    # -- fault tolerance ---------------------------------------------------
    def _ft_state(self, it_count):
        """The checkpointable training state (TrainEngine.ft_state: a host
        copy made on the training thread, the async writer's double
        buffer), with the scheduler's epoch under ``/meta/lr_last_epoch``
        when there is a scheduler."""
        snap = self._engine.ft_state(it_count)
        sched = self._optimizer._lr_scheduler
        if sched is not None:
            snap["meta"]["lr_last_epoch"] = torch.tensor(
                int(sched.last_epoch), dtype=torch.int32)
        return snap

    def _ft_template(self):
        """The structure of :meth:`_ft_state` with None leaves."""
        snap = self._engine.ft_template()
        if self._optimizer._lr_scheduler is not None:
            snap["meta"]["lr_last_epoch"] = None
        return snap

    def _ft_save(self, mgr, saver, it_count, force=False, sync=False):
        """One durable checkpoint of the training state.  With an
        AsyncCheckpointer the host snapshot is taken here and written in
        the background; emergency saves pass ``sync``.  The whole call is
        the training thread's stall for the checkpoint.  The manifest's
        JSON meta carries the mesh (one device), the scheduler's state and
        the random streams (``torch_rng``: TrainEngine.rng_state)."""
        meta = {"mesh": {"dp": 1, "devices": 1, "axes": {}},
                "torch_rng": self._engine.rng_state()}
        sched = self._optimizer._lr_scheduler
        if sched is not None:
            meta["lr_sched"] = sched.state_dict()
        if saver is not None and not sync:
            saver.submit(it_count, self._ft_state(it_count), force=force,
                         meta=meta)
            return
        if saver is not None and not saver.flush(timeout=30.0):
            # never race a background write; but a writer stalled on a
            # dead mount must not eat the SIGTERM grace window
            logger.error("emergency checkpoint skipped: background writer "
                         "stalled >30s; resuming from the latest durable "
                         "generation instead")
            return
        if sync and mgr.latest_step() == it_count:
            return  # this step is already durably committed
        try:
            mgr.save(it_count, self._ft_state(it_count), force=force,
                     meta=meta)
            self._ft_sync_failures = 0
        except OSError as e:
            # degrade then escalate, as the async writer does: warn, keep
            # training, and let fit exit with the durability code after K
            # consecutive failures
            if sync:
                # on the way to a preempted exit the newest durable
                # generation is the recovery point: never mask exit 75
                logger.error("emergency checkpoint failed (%s: %s) — the "
                             "latest durable generation stands as the "
                             "recovery point", type(e).__name__, e)
                return
            self._ft_sync_failures += 1
            logger.warning(
                "checkpoint generation %s failed (%s: %s) — training "
                "continues WITHOUT durability (%d/%d consecutive failures "
                "before escalation)", it_count, type(e).__name__, e,
                self._ft_sync_failures, self._ft_max_failures)

    def _ft_restore(self, mgr):
        """Resume from the newest valid generation (the corruption cascade
        is CheckpointManager.restore_latest's): the state written in place
        into the tensors the engine's graphs hold, the optimizer's step
        count, the scheduler (its full state from the manifest, else
        ``step(epoch=lr_last_epoch)``) and the random streams.  Returns the
        iteration to fast-forward to (0 for a fresh start)."""
        step0, back = mgr.restore_latest(template=self._ft_template())
        if step0 is None:
            return 0
        engine = self._engine
        engine.adopt_ft_state(back)
        meta = (mgr.last_restore_manifest or {}).get("meta") or {}
        sched = self._optimizer._lr_scheduler
        if sched is not None and meta.get("lr_sched"):
            sched.set_state_dict(meta["lr_sched"])
        elif sched is not None and "lr_last_epoch" in back["meta"]:
            sched.step(epoch=int(back["meta"]["lr_last_epoch"]))
        it = int(back["meta"]["it"])
        engine.adopt_rng_state(meta.get("torch_rng"), it)
        logger.info("fit: resumed from checkpoint at iteration %d "
                    "(restart #%s)", step0,
                    os.environ.get("PADDLE_RESTART_COUNT", "0"))
        return it

    # -- loops ---------------------------------------------------------------
    def _split_batch(self, batch):
        n_label = len(_to_list(self._labels)) or 1
        if len(batch) == 1:
            return batch, []
        return batch[:-n_label], batch[-n_label:]

    def _loader(self, data, batch_size, shuffle, drop_last=False,
                num_workers=0):
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)

    def _pin(self, loader):
        """On a CUDA model, set ``loader.placement`` to :func:`io.pin_batch`
        (the reader's thread pins each batch); returns the former hook,
        which the caller restores when it is done, as the reference
        installs and restores its placement hook."""
        prev = loader.placement
        if self.device.type == "cuda":
            loader.placement = pin_batch
        return prev

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, fault_tolerant=False,
            resume=None, checkpoint_interval=None, accum_steps=1):
        """Train for ``epochs`` over ``train_data`` (a Dataset or a
        DataLoader), with the reference's options and callback order:
        ``eval_data`` is evaluated every ``eval_freq`` epochs, a
        ``ModelCheckpoint`` saves to ``save_dir`` every ``save_freq``
        epochs and at the end, ``num_iters`` ends training after that many
        steps, a callback may set ``stop_training``.  ``drop_last`` drops
        an epoch's last, short batch (a Dataset only).  ``accum_steps=k``
        (alias: Paddle's ``accumulate_grad_batches``) splits each batch
        into k equal microbatches whose gradients are accumulated inside
        the one step (engine.py ``build_train_step``); a batch that k does
        not divide raises ``ValueError``.  Returns the history: ``loss``
        (each epoch's mean loss), ``eval_loss`` (with ``eval_data``) and
        ``step_loss`` (every step's loss).

        Fault tolerance, the reference's: ``resume=<dir>`` (or
        ``resume=True`` with ``save_dir``) resumes from the newest valid
        checkpoint under ``<dir>/resilient`` and checkpoints every
        ``checkpoint_interval`` iterations (default: each epoch's end),
        the newest two generations kept; the batches already trained are
        skipped.  ``fault_tolerant=True`` also latches SIGTERM/SIGINT,
        finishes the step in flight, writes an emergency checkpoint and
        exits with ``distributed.PREEMPTED_EXIT_CODE`` (75).  Saves run on
        a background writer (``FLAGS_ckpt_async``); after
        ``FLAGS_ckpt_max_failures`` consecutive failed generations fit
        exits with ``DURABILITY_EXIT_CODE`` (91).  The resume is bit for
        bit the unbroken run when the data order is fixed
        (``shuffle=False``) and the run seeded (``paddle_tpu_torch.seed``):
        the checkpoint carries the random streams."""
        if accumulate_grad_batches != 1 and accum_steps == 1:
            # Paddle's fleet name for the same knob, as the reference reads it
            accum_steps = accumulate_grad_batches
        loader = self._loader(train_data, batch_size, shuffle, drop_last,
                              num_workers)
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
        # the microbatches' merged outputs are kept only for the metrics
        engine = self._engine.begin(accum_steps, bool(self._metrics))
        ft_mgr = ft_saver = guard = None
        start_it = 0
        if fault_tolerant or resume:   # resume=False/None/"" is off
            ckpt_dir = resume if isinstance(resume, str) else save_dir
            if not ckpt_dir:
                raise ValueError("fault_tolerant/resume needs a checkpoint "
                                 "directory: pass resume=<dir> or save_dir=")
            ft_mgr = CheckpointManager(os.path.join(ckpt_dir, "resilient"),
                                       max_to_keep=2)
            self._ft_sync_failures = 0
            self._ft_max_failures = int(flag("FLAGS_ckpt_max_failures"))
            try:
                # after begin(): the state lands in the tensors the graphs
                # hold (or will hold)
                start_it = self._ft_restore(ft_mgr)
                if flag("FLAGS_ckpt_async"):
                    ft_saver = AsyncCheckpointer(
                        ft_mgr, max_failures=self._ft_max_failures)
                if fault_tolerant:
                    guard = PreemptionGuard().__enter__()
            except BaseException:
                if ft_saver is not None:
                    ft_saver.close()
                ft_mgr.close()
                raise
        history = {"loss": [], "step_loss": []}
        it_count = 0
        fit_ok = False
        # the hook goes on last: what raises above leaves the loader as it was
        prev_placement = self._pin(loader)
        try:
            cbks.on_train_begin({})
            for epoch in range(epochs):
                self.network.train()
                for m in self._metrics:
                    m.reset()
                cbks.on_epoch_begin(epoch, {})
                losses = []
                for step_i, batch in enumerate(loader):
                    if it_count < start_it:
                        # a batch the checkpoint already trained; a SIGTERM
                        # here exits at once (the restored generation is
                        # still the newest)
                        if guard is not None and guard.preempted:
                            raise SystemExit(PREEMPTED_EXIT_CODE)
                        it_count += 1
                        continue
                    cbks.on_train_batch_begin(step_i, {})
                    if ft_mgr is not None:
                        # fault injection: crash, preempt, slow
                        chaos.on_step(it_count + 1)
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
                    if ft_mgr is not None:
                        if (checkpoint_interval
                                and it_count % checkpoint_interval == 0):
                            self._ft_save(ft_mgr, ft_saver, it_count)
                        if ((ft_saver is not None and ft_saver.fatal)
                                or self._ft_sync_failures
                                >= max(1, self._ft_max_failures)):
                            # K consecutive failed generations: the job
                            # trained without durability; exit with the
                            # distinct code so the launcher alerts
                            raise SystemExit(DURABILITY_EXIT_CODE)
                        if guard is not None and guard.preempted:
                            # step done: the emergency checkpoint
                            # (synchronous, we are about to exit), then the
                            # distinct "preempted" exit
                            self._ft_save(ft_mgr, ft_saver, it_count,
                                          force=True, sync=True)
                            ft_mgr.wait()
                            raise SystemExit(PREEMPTED_EXIT_CODE)
                    if num_iters is not None and it_count >= num_iters:
                        break
                losses.extend(engine.drain())
                if ft_mgr is not None and not checkpoint_interval \
                        and it_count > start_it:
                    self._ft_save(ft_mgr, ft_saver, it_count, force=True)
                history["step_loss"].extend(losses)
                # empty when the resume skipped the whole epoch
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
                # a SIGTERM during the epoch-end eval or callbacks is still
                # a clean preempted exit; in the last epoch the run ends
                if guard is not None and guard.preempted \
                        and epoch + 1 < epochs:
                    if it_count > start_it:
                        self._ft_save(ft_mgr, ft_saver, it_count,
                                      force=True, sync=True)
                        ft_mgr.wait()
                    raise SystemExit(PREEMPTED_EXIT_CODE)
                if self.stop_training:
                    break
                if num_iters is not None and it_count >= num_iters:
                    break
            fit_ok = True
        finally:
            loader.placement = prev_placement
            engine.finish()
            # a crash mid-fit must still flush and close callback resources
            cbks.on_train_end({})
            if guard is not None:
                guard.__exit__(None, None, None)
            if ft_saver is not None:
                # every submitted generation durably on disk before fit
                # returns, with a budget matched to how fit exits: patient
                # on success, none on a preempted exit (the SIGTERM grace
                # window must reach the exit code), bounded on a crash
                if fit_ok:
                    drain_s = 300.0
                elif guard is not None and guard.preempted:
                    drain_s = 0.0
                else:
                    drain_s = 30.0
                ft_saver.close(timeout=drain_s)
                if ft_saver.fatal:
                    logger.error(
                        "fit: checkpoint durability was LOST during this "
                        "run (%d consecutive failed generations; last: %s)",
                        ft_saver.consecutive_failures, ft_saver.last_error)
            if ft_mgr is not None:
                ft_mgr.close()
                # the K-th failure can land in the final drain or the
                # epoch-end save, after the in-loop check; never mask an
                # exception already unwinding
                if fit_ok and ((ft_saver is not None and ft_saver.fatal)
                               or self._ft_sync_failures
                               >= max(1, self._ft_max_failures)):
                    raise SystemExit(DURABILITY_EXIT_CODE)
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
        loader = self._loader(eval_data, batch_size, shuffle=False,
                              num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        cbks = CallbackList(callbacks)
        cbks.set_model(self)
        engine = self._eval_begin()
        cbks.on_eval_begin({})
        seen = 0
        prev_placement = self._pin(loader)
        try:
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
        finally:
            loader.placement = prev_placement
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
        loader = self._loader(test_data, batch_size, shuffle=False,
                              num_workers=num_workers)
        engine = self._eval_begin()
        outputs = []
        prev_placement = self._pin(loader)
        try:
            for batch in loader:
                inputs, _ = self._split_batch(_to_list(batch))
                outputs.append(_copies(engine.step(inputs, [])))
        finally:
            loader.placement = prev_placement
        if stack_outputs and outputs and isinstance(outputs[0],
                                                     torch.Tensor):
            return [torch.cat(outputs, 0)]
        return outputs

    # -- persistence -------------------------------------------------------
    def _opt_tree(self):
        """The optimizer's slots as the reference's state pytree, {param
        name: {slot: tensor}} over every trainable parameter (a parameter
        the optimizer holds no slot for yet gets its initial slots)."""
        opt = self._optimizer
        return {n: opt._slots.get(id(p)) or {
                    s: opt._init_slot(s, p.detach())
                    for s in opt._slot_names()}
                for n, p in self.network.named_parameters()
                if p.requires_grad}

    def _opt_state(self):
        """:meth:`_opt_tree`, or None before the optimizer's first slot."""
        return self._opt_tree() if self._optimizer._slots else None

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

    def serve(self, host="127.0.0.1", port=8866, *, input_spec=None,
              max_batch_size=None, batch_timeout_ms=None, buckets=None,
              queue_depth=None, blocking=True,
              install_signal_handlers=True):
        """Serve this model over HTTP with adaptive batching
        (paddle_tpu_torch.serving): concurrent /predict requests are
        coalesced into padded shape-bucket batches, every bucket is
        captured as one CUDA graph before the port opens (on a CPU model:
        run eagerly), and SIGTERM drains gracefully.

        ``input_spec`` (or the Model's constructor ``inputs``) gives the
        per-input ``(shape, dtype)`` pairs used for warmup, batch dim
        included — dims of -1/None are serving-variable (batch, and
        sequence when ``buckets`` carries a seq grid).  With
        ``blocking=False`` returns the started ``ServingServer`` (use
        ``.url``, ``.shutdown()``); otherwise blocks until SIGTERM and
        returns the drain exit code (0 = clean)."""
        from ..serving import ServingEngine, ServingServer

        self.network.eval()
        spec = input_spec if input_spec is not None else self._inputs
        engine = ServingEngine(
            self.network, max_batch_size=max_batch_size,
            batch_timeout_ms=batch_timeout_ms, buckets=buckets,
            queue_depth=queue_depth,
            input_specs=_to_list(spec) if spec is not None else None)
        server = ServingServer(
            engine, host=host, port=port,
            install_signal_handlers=install_signal_handlers).start()
        if blocking:
            print(f"serving on {server.url} (SIGTERM drains gracefully)",
                  flush=True)
            return server.wait()
        return server

    def serve_generate(self, host="127.0.0.1", port=8866, *,
                       max_slots=None, max_seq_len=None,
                       prompt_buckets=None, queue_depth=None,
                       page_size=None, num_pages=None, prefix_cache=None,
                       mesh=None, layout=None, device=None,
                       blocking=True, install_signal_handlers=True):
        """Serve autoregressive generation over HTTP with continuous
        batching (serving/generation.py): prefill fills a device-resident
        paged KV cache, one captured decode step advances every in-flight
        request a token per iteration, and POST /generate streams tokens
        as they decode (SSE).  The network must expose the slot-batched
        decode path (``slot_prefill`` / ``slot_decode_paged``, e.g.
        models.GPTForCausalLM).  ``device`` is the engine's (None: the
        CUDA card); ``mesh``/``layout`` (tensor-parallel serving) are not
        ported yet.

        With ``blocking=False`` returns the started ``ServingServer``;
        otherwise blocks until SIGTERM and returns the drain exit code
        (0 = clean)."""
        from ..serving import GenerationEngine, ServingServer

        if mesh is not None or layout is not None:
            raise NotImplementedError(
                "serve_generate(mesh=, layout=): tensor-parallel serving "
                "comes with the port's distributed mesh (ROADMAP.md A9)")
        self.network.eval()
        engine = GenerationEngine(
            self.network, max_slots=max_slots, max_seq_len=max_seq_len,
            prompt_buckets=prompt_buckets, queue_depth=queue_depth,
            page_size=page_size, num_pages=num_pages,
            prefix_cache=prefix_cache, device=device)
        server = ServingServer(
            None, host=host, port=port,
            install_signal_handlers=install_signal_handlers,
            gen_engine=engine).start()
        if blocking:
            print(f"serving generation on {server.url} (SIGTERM drains "
                  "gracefully)", flush=True)
            return server.wait()
        return server


def summary(net, input_size=None, dtypes=None):
    """Print one line a parameter, its name, shape (as the reference
    prints it, ``[8, 4]``) and size, then ``Total params:``; returns
    ``{"total_params": n}``.  ``input_size`` and ``dtypes`` are accepted
    and unused, as in the reference."""
    lines = []
    total = 0
    for name, p in net.named_parameters():
        n = p.numel()
        total += n
        lines.append(f"{name:60s} {str(list(p.shape)):20s} {n}")
    print("\n".join(lines) + f"\nTotal params: {total}")
    return {"total_params": total}


def flops(net, input_size, custom_ops=None, print_detail=False,
          dtypes=None):
    """Forward flops of ``net`` on zeros of ``input_size`` (one shape, or
    a list of shapes for a network of several inputs), in eval mode and
    without autograd, on the network's device; each sublayer's
    ``training`` flag is restored after.  The reference reads XLA's
    compiled ``cost_analysis``; here :class:`utils.flops.FlopCounter`
    counts the ops the forward issues by XLA's convention, the fused ops
    (hand-written kernels on the card) by their own analytic counts, so
    the card and the CPU give one count.  ``dtypes``: the inputs' dtype
    (one, or one an input; a string or a torch dtype), by default the
    network's floating parameters' (float32 in the reference, whose
    ``flops`` cannot feed an integer-id network).  ``custom_ops`` is
    accepted and ignored, as in the reference."""
    from ..framework.dtype import convert_dtype
    from ..utils.flops import FlopCounter

    sizes = input_size if isinstance(input_size[0], (list, tuple)) \
        else [input_size]
    params = list(net.parameters())
    floating = [p.dtype for p in params if p.is_floating_point()]
    device = params[0].device if params else torch.device("cpu")
    if dtypes is None:
        dtypes = floating[0] if floating else torch.float32
    if not isinstance(dtypes, (list, tuple)):
        dtypes = [dtypes] * len(sizes)
    xs = [torch.zeros(tuple(s), dtype=convert_dtype(d), device=device)
          for s, d in zip(sizes, dtypes)]
    # per-sublayer modes: a blanket train() after would flip a frozen
    # sublayer back to training
    modes = [(m, m.training) for m in net.modules()]
    net.eval()
    try:
        with torch.no_grad(), FlopCounter() as counter:
            net(*xs)
    finally:
        for m, mode in modes:
            m.training = mode
    if print_detail:
        print(f"forward flops for input {input_size}: {counter.total:,}")
    return counter.total
