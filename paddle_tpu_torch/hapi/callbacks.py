"""hapi callbacks (port of paddle_tpu/hapi/callbacks.py, whole): the
``Callback`` base and ``CallbackList`` dispatch, ``ProgBarLogger``,
``ModelCheckpoint``, ``EarlyStopping``, ``LRScheduler``, ``VisualDL`` (a
``scalars.jsonl`` of the logged scalars, as the reference writes it) and
``config_callbacks``.  Plain Python, as in the reference; ``Model.fit``
calls the hooks in the reference's order.
"""
from __future__ import annotations

import numbers
import os
import time

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler", "VisualDL", "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    # lifecycle hooks (reference names)
    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Per-step/epoch console logging (reference ProgBarLogger)."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.steps = self.params.get("steps")

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()
        self._seen = 0

    def _fmt(self, logs):
        parts = []
        for k, v in (logs or {}).items():
            if k == "batch_size":
                continue
            if isinstance(v, numbers.Number):
                parts.append(f"{k}: {v:.4f}")
            elif isinstance(v, (list, tuple, np.ndarray)):
                parts.append(f"{k}: {np.mean(v):.4f}")
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        self._seen += 1
        if self.verbose and self.log_freq and step % self.log_freq == 0:
            total = f"/{self.steps}" if self.steps else ""
            # ProgBarLogger's stdout progress display is the verbose=1
            # API contract (keras/paddle parity), not library logging
            print(f"Epoch {self._epoch + 1}/{self.epochs} "
                  f"step {step}{total} - {self._fmt(logs)}", flush=True)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.epochs} done in "
                  f"{time.time() - self._t0:.1f}s - {self._fmt(logs)}",
                  flush=True)

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}", flush=True)


class ModelCheckpoint(Callback):
    """Save every `save_freq` epochs + final (reference ModelCheckpoint)."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir and self.model:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """Stop when `monitor` stops improving (reference EarlyStopping)."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "max" or (mode == "auto" and
                             ("acc" in monitor or "auc" in monitor)):
            self.greater = True
        else:
            self.greater = False
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0

    def _improved(self, value):
        if self.best is None:
            return True
        if self.greater:
            return value > self.best + self.min_delta
        return value < self.best - self.min_delta

    def on_train_begin(self, logs=None):
        self.best = self.baseline
        self.wait = 0
        self._epoch = 0
        self._eval_checked = False

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._eval_checked = False

    def on_eval_end(self, logs=None):
        """Reference semantics: the monitor watches EVAL metrics."""
        self._eval_checked = True
        self._check(self._epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        # fallback for fit() without eval_data: watch the train metric
        if not self._eval_checked:
            self._check(epoch, logs)

    def _check(self, epoch, logs):
        value = (logs or {}).get(self.monitor)
        if value is None:
            return
        value = float(np.mean(value))
        if self._improved(value):
            self.best = value
            self.wait = 0
            if self.save_best_model and self.model and \
                    getattr(self.model, "_save_dir", None):
                self.model.save(os.path.join(self.model._save_dir,
                                             "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
                if self.model is not None:
                    self.model.stop_training = True
                if self.verbose:
                    # same stdout display contract as ProgBarLogger
                    print(f"Epoch {epoch + 1}: early "
                          f"stopping (best "
                          f"{self.monitor}={self.best:.4f})",
                          flush=True)


class LRScheduler(Callback):
    """Step the optimizer's LRScheduler (reference LRScheduler callback)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None) if opt else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class VisualDL(Callback):
    """Scalar logging: a ``scalars.jsonl`` line (the step and every number
    of the logs) at each train batch's end, which the visualdl converter
    (or any tool) can ingest; the visualdl package is not needed."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._f = None

    def on_train_begin(self, logs=None):
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")

    def on_train_batch_end(self, step, logs=None):
        if self._f:
            import json
            rec = {"step": step}
            for k, v in (logs or {}).items():
                if isinstance(v, numbers.Number):
                    rec[k] = float(v)
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()  # crash mid-fit must not lose the tail

    def on_train_end(self, logs=None):
        if self._f:
            self._f.close()
            self._f = None


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    """Assemble the default callback list (reference config_callbacks)."""
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    clist = CallbackList(cbks)
    clist.set_model(model)
    clist.set_params({"batch_size": batch_size, "epochs": epochs,
                      "steps": steps, "verbose": verbose,
                      "metrics": metrics or []})
    return clist
