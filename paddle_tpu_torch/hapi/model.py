"""High-level Model API (port of paddle_tpu/hapi/model.py ``Model``:
``prepare``, ``train_batch``, ``eval_batch``, ``predict_batch``, ``fit``
and ``evaluate``).

Every batch runs eagerly on the network's own parameters, on the device
they live on; the step math is one function shared with the training
engine (hapi/engine.py).  ``fit`` drives the engine: no host sync inside
a step, losses fetched in one copy at ``log_freq`` steps and epoch ends;
on a CUDA device the step of each batch signature is captured once as a
CUDA graph and replayed, as the reference compiles its donated step
(``train_batch`` and a user's own loop stay eager, as there).
Of ``fit``'s options, ``epochs``, ``batch_size``, ``shuffle``,
``eval_data``, ``log_freq`` and ``verbose`` are ported.
Not ported yet (ROADMAP.md): callbacks and metrics, checkpointing and
``save``/``load``, fault tolerance, meshes and layouts, recompute,
gradient accumulation, telemetry and tracing, ``predict`` and ``serve``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..io import DataLoader
from .engine import TrainEngine, _to_list, build_train_step, to_device


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._train_step_fn = None
        self._engine = None

    @property
    def device(self) -> torch.device:
        return next(self.network.parameters()).device

    # -- setup -------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if metrics:
            raise NotImplementedError("metrics are not ported yet")
        if amp_configs:
            raise NotImplementedError("amp_configs are not ported yet")
        if optimizer is not None and optimizer._parameter_list is None:
            # the reference feeds the network's parameters to the
            # optimizer through its state pytrees; here it updates them
            optimizer._parameter_list = [
                p for p in self.network.parameters() if p.requires_grad]
        self._optimizer = optimizer
        self._loss = loss
        self._train_step_fn = None
        self._engine = None
        return self

    # -- batch-level API ---------------------------------------------------
    def train_batch(self, inputs, labels=None):
        """One step on one batch; returns the loss as a float (one
        sync)."""
        if self._train_step_fn is None:
            self._train_step_fn = build_train_step(
                self.network, self._loss, self._optimizer)
        self._optimizer.begin_step()
        loss, _ = self._train_step_fn(
            to_device(_to_list(inputs), self.device),
            to_device(_to_list(labels), self.device))
        return float(loss)

    @torch.no_grad()
    def _eval(self, inputs, labels):
        self.network.eval()
        outs = self.network(*to_device(_to_list(inputs), self.device))
        labels = to_device(_to_list(labels), self.device)
        loss = None
        if self._loss is not None and labels:
            loss = self._loss(*(_to_list(outs) + labels)).mean()
        return outs, loss

    def eval_batch(self, inputs, labels=None):
        outs, loss = self._eval(inputs, labels)
        return outs, float(loss) if loss is not None else 0.0

    def predict_batch(self, inputs):
        return self._eval(inputs, None)[0]

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
            log_freq=10, verbose=2, drop_last=False, shuffle=True):
        """Train for ``epochs`` over ``train_data`` (a Dataset or a
        DataLoader).  ``drop_last`` drops an epoch's last, short batch (a
        Dataset only; a DataLoader keeps its own batching), as the
        reference's does.  Returns the history: ``loss`` (the mean loss of
        each epoch), ``eval_loss`` (per epoch, with ``eval_data``) and
        ``step_loss`` (every step's loss; the reference hands these to its
        callbacks, which are not ported)."""
        loader = self._loader(train_data, batch_size, shuffle, drop_last)
        steps = len(loader)
        if self._engine is None:
            self._engine = TrainEngine(self)
        engine = self._engine.begin()
        history = {"loss": [], "step_loss": []}
        try:
            for epoch in range(epochs):
                losses = []
                for step_i, batch in enumerate(loader):
                    inputs, labels = self._split_batch(_to_list(batch))
                    engine.step(inputs, labels)
                    if log_freq and step_i % log_freq == 0:
                        losses.extend(engine.drain())
                        if verbose:
                            print(f"Epoch {epoch + 1}/{epochs} step "
                                  f"{step_i + 1}/{steps} loss "
                                  f"{losses[-1]:.6f}", flush=True)
                losses.extend(engine.drain())
                history["step_loss"].extend(losses)
                history["loss"].append(
                    float(np.mean(losses)) if losses else float("nan"))
                if eval_data is not None:
                    res = self.evaluate(eval_data, batch_size=batch_size,
                                        verbose=0)
                    history.setdefault("eval_loss", []).append(res["loss"])
        finally:
            engine.finish()
        return history

    def evaluate(self, eval_data, batch_size=1, verbose=2):
        """Mean loss over ``eval_data``; the per-batch losses stay on the
        card and are fetched in one copy at the end."""
        loader = self._loader(eval_data, batch_size, shuffle=False)
        losses = []
        for batch in loader:
            inputs, labels = self._split_batch(_to_list(batch))
            _, loss = self._eval(inputs, labels)
            if loss is not None:
                losses.append(loss.float())
        values = torch.stack(losses).cpu().tolist() if losses else []
        res = {"loss": float(np.mean(values)) if values else 0.0}
        if verbose:
            print("Eval:", res, flush=True)
        return res
