"""Optimizer wrappers: ModelAverage / ExponentialMovingAverage / Lookahead
(port of paddle_tpu/optimizer/wrappers.py).

Reference parity: python/paddle/fluid/optimizer.py — ModelAverage:3141
(three-bucket average_accumulates semantics, apply()/restore() contexts),
ExponentialMovingAverage:3450 (shadow vars, thres_steps decay ramp),
LookaheadOptimizer:5212 (slow/fast weights, k-step interpolation).

Each wrapper works eagerly over a parameter list (``update()`` /
``apply()`` / ``restore()``, ``step()``), in plain PyTorch ops on the
parameters' device: there is no ``pallas_call`` behind them.  The
reference's branches on its step counters (the spill and the window
restart of ModelAverage, the ramp of EMA, Lookahead's every-k sync) read
host counters here, which the eager reference also keeps on the host or
traces into its program; so no step reads the card.  ``apply()`` swaps the
averaged values into the parameters IN PLACE (``p.copy_``), so a model, an
optimizer or a captured graph that holds the parameter objects sees them;
``restore()`` copies the originals back.  The reference's ``fit`` takes
none of them (its engine calls ``opt.init_pytree`` and reads
``opt._step_count``, which ``LookaheadOptimizer`` lacks: an
``AttributeError``); the port's ``Model.fit`` refuses them the same way.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["ModelAverage", "ExponentialMovingAverage", "EMA",
           "LookaheadOptimizer"]

# kMaxNumAccumulates in average_accumulates_op.h — sum_1 spills into sum_2
# every this many updates so a single bucket never grows unboundedly stale
_MAX_NUM_ACCUMULATES = 16384


def _values(parameter_list):
    return [p.detach().clone() for p in parameter_list]


class _Swap:
    """``apply()``/``restore()`` of a wrapper whose ``_averaged()`` gives
    the values to swap in."""

    _backup = None

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        """Swap the averaged parameters in (reference
        ModelAverage.apply:3364), and back on exit unless
        ``need_restore`` is False."""
        if self._state is None:
            raise ValueError("call update() at least once before apply()")
        avg = self._averaged()
        self._backup = _values(self._parameter_list)
        with torch.no_grad():
            for p, v in zip(self._parameter_list, avg):
                p.copy_(v)
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        if self._backup is None:
            return
        with torch.no_grad():
            for p, v in zip(self._parameter_list, self._backup):
                p.copy_(v)
        self._backup = None


class ModelAverage(_Swap):
    """Running average of parameters over a trailing window
    (optimizer.py:3141 + operators/average_accumulates_op.h).

    average_window_rate bounds the window to rate * num_updates, clipped to
    [min_average_window, max_average_window].  apply() swaps averaged
    params in, restore() swaps back.  The three sums have the parameters'
    dtype (the reference's ``zeros_like``).
    """

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self._rate = float(average_window_rate)
        self._min_window = int(min_average_window)
        self._max_window = int(max_average_window)
        self._parameter_list = list(parameters) if parameters else None
        self._state = None

    @torch.no_grad()
    def update(self):
        """One accumulation step (the average_accumulates op)."""
        if self._parameter_list is None:
            raise ValueError("ModelAverage.update() needs parameters=")
        params = [p.detach() for p in self._parameter_list]
        if self._state is None:
            self._state = {
                "sum_1": [torch.zeros_like(p) for p in params],
                "sum_2": [torch.zeros_like(p) for p in params],
                "sum_3": [torch.zeros_like(p) for p in params],
                "num_accumulates": 0, "old_num_accumulates": 0,
                "num_updates": 0}
        st = self._state
        st["num_updates"] += 1
        st["num_accumulates"] += 1
        sum_1 = [s + p for s, p in zip(st["sum_1"], params)]
        sum_2, sum_3 = st["sum_2"], st["sum_3"]
        if st["num_updates"] % _MAX_NUM_ACCUMULATES == 0:
            sum_2 = [s2 + s1 for s2, s1 in zip(sum_2, sum_1)]
            sum_1 = [torch.zeros_like(s) for s in sum_1]
        # the window as the reference forms it: int32(float32(n) * rate)
        window = min(self._max_window, max(
            self._min_window,
            int(np.float32(st["num_updates"]) * np.float32(self._rate))))
        if st["num_accumulates"] >= window:
            sum_3 = [s1 + s2 for s1, s2 in zip(sum_1, sum_2)]
            sum_1 = [torch.zeros_like(s) for s in sum_1]
            sum_2 = [torch.zeros_like(s) for s in sum_2]
            st["old_num_accumulates"] = st["num_accumulates"]
            st["num_accumulates"] = 0
        st["sum_1"], st["sum_2"], st["sum_3"] = sum_1, sum_2, sum_3

    def _averaged(self):
        st = self._state
        total = float(max(np.float32(st["num_accumulates"]
                                     + st["old_num_accumulates"]), 1.0))
        return [((s1 + s2 + s3) / total).to(s1.dtype)
                for s1, s2, s3 in zip(st["sum_1"], st["sum_2"],
                                      st["sum_3"])]


class ExponentialMovingAverage(_Swap):
    """shadow = decay * shadow + (1 - decay) * param
    (optimizer.py:3450), with the thres_steps ramp
    decay_t = min(decay, (1 + t) / (10 + t)) when enabled, in float32 as
    the reference forms it; the shadow keeps the parameters' dtype.
    """

    def __init__(self, decay=0.999, thres_steps=None, parameters=None,
                 name=None):
        self._decay = float(decay)
        self._thres_steps = thres_steps  # None | True (use step counter)
        self._parameter_list = list(parameters) if parameters else None
        self._state = None

    def _decay_at(self, step):
        f = np.float32
        if self._thres_steps is None:
            return f(self._decay)
        t = f(step)
        return min(f(self._decay), (f(1.0) + t) / (f(10.0) + t))

    @torch.no_grad()
    def update(self):
        if self._parameter_list is None:
            raise ValueError("EMA.update() needs parameters=")
        params = [p.detach() for p in self._parameter_list]
        if self._state is None:
            self._state = {"shadow": [p.clone() for p in params], "step": 0}
        d = self._decay_at(self._state["step"])
        one_minus = float(np.float32(1.0) - d)
        d = float(d)
        # the reference's float32 decay promotes the product to float32
        self._state["shadow"] = [
            (d * s.float() + one_minus * p.float()).to(s.dtype)
            for s, p in zip(self._state["shadow"], params)]
        self._state["step"] += 1

    def _averaged(self):
        return self._state["shadow"]


EMA = ExponentialMovingAverage


class LookaheadOptimizer:
    """k-step lookahead (optimizer.py:5212): fast weights step every
    iteration; every k steps slow += alpha * (fast - slow), fast = slow."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if inner_optimizer is None:
            raise ValueError("inner optimizer cannot be None")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be in [0, 1]")
        if not (isinstance(k, int) and k > 0):
            raise ValueError("k must be a positive integer")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._slow = None
        self._t = 0

    def _slot_names(self):
        return self.inner_optimizer._slot_names()

    @torch.no_grad()
    def step(self):
        inner = self.inner_optimizer
        params = inner._parameter_list or []
        if self._slow is None:
            self._slow = _values(params)
            self._t = 0
        inner.step()
        self._t += 1
        if self._t % self.k == 0:
            for p, s in zip(params, self._slow):
                p.copy_((s + self.alpha * (p - s)).to(p.dtype))
            self._slow = _values(params)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad)
                      for p in (self.inner_optimizer._parameter_list or [])]

    def clear_grad(self, set_to_zero=False):
        return self.inner_optimizer.clear_grad(set_to_zero)

    def get_lr(self):
        return self.inner_optimizer.get_lr()
