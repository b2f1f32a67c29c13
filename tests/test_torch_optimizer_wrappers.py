"""The optimizer wrappers (ModelAverage, ExponentialMovingAverage/EMA,
LookaheadOptimizer) of the port against paddle_tpu/optimizer/wrappers.py,
on the CPU, float32 (and bf16 for EMA): parameters set to the same seeded
values on both sides before each ``update()``, then ``apply()`` and
``restore()``; Lookahead driving SGD for 7 eager steps.  Tolerance: rtol
1e-6, atol 1e-7 (the same float32 ops; a sum of k values may round in
another order); bf16 EMA within one bf16 ulp (2 ** -7 relative).  The
reference's ``Model.fit`` takes none of the wrappers (its engine reads
the optimizer's ``_step_count``): neither does the port's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt

RTOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = [(4, 3), (3,)]


def _values(step):
    rs = np.random.RandomState(80 + step)
    return [rs.randn(*s).astype(np.float32) for s in SHAPES]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(x.numpy(), dtype=np.float32)


def _drive(pkg, make, steps, dtype="float32"):
    """``steps`` updates of ``make(pkg, params)`` over parameters set to
    :func:`_values` before each; returns (the averaged values under
    ``apply()``, the values after ``restore()``, the last values)."""
    if pkg is ptt:
        ps = [torch.nn.Parameter(torch.zeros(s, dtype=getattr(torch, dtype)))
              for s in SHAPES]

        def put(vals):
            with torch.no_grad():
                for p, v in zip(ps, vals):
                    p.copy_(torch.from_numpy(v))
    else:
        ps = [paddle.to_tensor(np.zeros(s, np.float32), dtype=dtype,
                               stop_gradient=False) for s in SHAPES]

        def put(vals):
            for p, v in zip(ps, vals):
                p.set_value(paddle.to_tensor(v, dtype=dtype))
    w = make(pkg, ps)
    for i in range(steps):
        put(_values(i))
        w.update()
    with w.apply():
        averaged = [_np(p) for p in ps]
    restored = [_np(p) for p in ps]
    return averaged, restored, [_np(p) for p in ps]


WRAPPERS = {
    "ema": lambda m, ps: m.optimizer.ExponentialMovingAverage(
        0.9, parameters=ps),
    "ema_thres": lambda m, ps: m.optimizer.EMA(0.99, thres_steps=True,
                                               parameters=ps),
    # windows of 2..3 updates: the sums restart inside the 7 updates
    "model_average": lambda m, ps: m.optimizer.ModelAverage(
        0.15, parameters=ps, min_average_window=2, max_average_window=3),
    # a window wider than the updates: the plain mean of all of them
    "model_average_wide": lambda m, ps: m.optimizer.ModelAverage(
        0.15, parameters=ps, min_average_window=100,
        max_average_window=200),
}


@pytest.mark.parametrize("steps", [1, 3, 7])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_matches_the_reference(name, steps):
    got, got_back, _ = _drive(ptt, WRAPPERS[name], steps)
    want, want_back, _ = _drive(paddle, WRAPPERS[name], steps)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **RTOL)
    last = _values(steps - 1)
    for a, b in zip(got_back, last):
        np.testing.assert_array_equal(a, b)
    if name == "model_average_wide":
        mean = [np.mean([_values(i)[j] for i in range(steps)], axis=0)
                for j in range(len(SHAPES))]
        for a, b in zip(got, mean):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_model_average_spills_its_first_sum(monkeypatch):
    """Every kMaxNumAccumulates updates sum_1 spills into sum_2: with the
    constant at 2 in both packages, 7 updates spill three times."""
    import paddle_tpu.optimizer.wrappers as jw

    import paddle_tpu_torch.optimizer.wrappers as tw
    monkeypatch.setattr(jw, "_MAX_NUM_ACCUMULATES", 2)
    monkeypatch.setattr(tw, "_MAX_NUM_ACCUMULATES", 2)
    make = WRAPPERS["model_average_wide"]
    got, _, _ = _drive(ptt, make, 7)
    want, _, _ = _drive(paddle, make, 7)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **RTOL)


def test_ema_bf16_matches_the_reference():
    make = WRAPPERS["ema_thres"]
    got, _, _ = _drive(ptt, make, 5, "bfloat16")
    want, _, _ = _drive(paddle, make, 5, "bfloat16")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=1e-6)


def test_ema_shadow_maths():
    """shadow_t = d_t shadow + (1 - d_t) p, d_t = min(decay, (1 + t) /
    (10 + t)) with thres_steps, from shadow_0 = the first values."""
    got, _, _ = _drive(ptt, WRAPPERS["ema_thres"], 3)
    shadow = _values(0)
    for t in range(3):
        d = min(np.float32(0.99), np.float32((1 + t) / (10 + t)))
        shadow = [d * s + (1 - d) * v for s, v in zip(shadow, _values(t))]
    for a, b in zip(got, shadow):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_apply_without_update_raises():
    p = torch.nn.Parameter(torch.zeros(3))
    for w in (ptt.optimizer.EMA(parameters=[p]),
              ptt.optimizer.ModelAverage(0.1, parameters=[p])):
        with pytest.raises(ValueError):
            with w.apply():
                pass


def _lookahead(pkg, k, alpha, steps=7):
    w0 = _values(0)
    if pkg is ptt:
        ps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in w0]
    else:
        ps = [paddle.to_tensor(v, stop_gradient=False) for v in w0]
    opt = pkg.optimizer.LookaheadOptimizer(
        pkg.optimizer.SGD(0.1, parameters=ps), alpha=alpha, k=k)
    trace = []
    for i in range(steps):
        for p, g in zip(ps, _values(10 + i)):
            p.grad = torch.from_numpy(g) if pkg is ptt \
                else paddle.to_tensor(g)
        opt.step()
        opt.clear_grad()
        trace.append([_np(p) for p in ps])
    return trace


@pytest.mark.parametrize("k,alpha", [(1, 0.5), (3, 0.5), (2, 0.8)])
def test_lookahead_matches_the_reference(k, alpha):
    got, want = _lookahead(ptt, k, alpha), _lookahead(paddle, k, alpha)
    for step, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, **RTOL, err_msg=str(step))


def test_lookahead_syncs_every_k_steps():
    """At steps k, 2k, ... the fast weights jump to slow + alpha (fast -
    slow) of the last sync; between syncs they take plain SGD steps."""
    k, alpha = 3, 0.5
    trace = _lookahead(ptt, k, alpha)
    slow = _values(0)
    fast = [v.copy() for v in slow]
    for i in range(7):
        fast = [f - np.float32(0.1) * g for f, g in zip(fast, _values(10 + i))]
        if (i + 1) % k == 0:
            slow = [s + alpha * (f - s) for s, f in zip(slow, fast)]
            fast = [s.copy() for s in slow]
        for a, b in zip(trace[i], fast):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_lookahead_argument_checks():
    sgd = ptt.optimizer.SGD(0.1, parameters=[torch.nn.Parameter(
        torch.zeros(2))])
    for kw, err in (({"inner_optimizer": None}, ValueError),
                    ({"alpha": 1.5}, ValueError), ({"k": 0}, ValueError)):
        args = {"inner_optimizer": sgd, **kw}
        with pytest.raises(err):
            ptt.optimizer.LookaheadOptimizer(**args)


def test_fit_refuses_a_wrapper_like_the_reference():
    x = np.random.RandomState(1).randn(8, 3).astype(np.float32)
    for pkg, ns, data in (
            (ptt, ptt.nn, ptt.io.TensorDataset([torch.from_numpy(x)] * 2)),
            (paddle, paddle.nn, paddle.io.TensorDataset([x, x]))):
        net = ns.Linear(3, 3)
        opt = pkg.optimizer.LookaheadOptimizer(
            pkg.optimizer.SGD(0.1, parameters=net.parameters()))
        m = pkg.Model(net)
        m.prepare(opt, lambda o, t: ((o - t) ** 2).mean())
        with pytest.raises(AttributeError, match="_step_count"):
            m.fit(data, batch_size=4, verbose=0)
