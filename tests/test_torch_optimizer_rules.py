"""The eight optimizers this slice ports (Adagrad, Adamax, Adadelta,
RMSProp, Lamb, LarsMomentum, Ftrl, Dpsgd) against the JAX package's, on
the CPU, and the reference's quirks the port reproduces (ROADMAP.md §C).

- every option of each, 5 eager ``step()`` calls on a small float32 tree
  (a matrix, a bias, one element) from the same gradients, against the
  reference's eager ``step()``: rtol 1e-6, atol 1e-7 (float32 rounding of
  the same ops; the norms of Lamb, LARS and Dpsgd sum in another order);
- bf16 parameters: 5 steps of the rules whose reference keeps a bf16
  parameter bf16, within 2 ** -5 x max(1, |ref|) (XLA may fuse a rule's
  bf16 ops and round once where the port rounds after each op: a few bf16
  ulps after 5 steps);
- slot dtypes: the reference's ``zeros_like(p)`` (Adagrad
  ``full_like(p, initial_accumulator_value)``) for float32 and bf16
  parameters;
- the fit form: ``Model.fit`` against the reference's ``Model.fit``
  (``apply_pytree``: rtol 1e-5, the reference's lr and step are traced
  float32 scalars), showing quirks (i) per-parameter learning rates and
  AdamW's ``apply_decay_param_fun`` are ignored there and honoured by the
  eager step, (ii) Lamb's ``exclude_from_weight_decay_fn`` and
  LarsMomentum's ``exclude_from_weight_decay`` are never read, (iii)
  ``p.regularizer`` is never read, (iv) Dpsgd's noise in the fit step is
  the same every step (the reference's jitted step keeps the key it was
  traced with);
- Dpsgd: sigma = 0 is the reference's clipped SGD; the noise is
  deterministic per seed and new every eager step;
- the fluid aliases name the same classes.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.layer_base as jlayer_base
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.layer_base as tlayer_base
from paddle_tpu_torch import nn as tnn

RTOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = [(6, 4), (4,), (1,)]

RULES = {
    "adagrad": lambda m, ps: m.optimizer.Adagrad(0.1, parameters=ps),
    "adagrad_init_eps": lambda m, ps: m.optimizer.Adagrad(
        0.1, epsilon=1e-3, initial_accumulator_value=0.5, parameters=ps),
    "adagrad_wd": lambda m, ps: m.optimizer.Adagrad(
        0.1, weight_decay=0.05, parameters=ps),
    "adamax": lambda m, ps: m.optimizer.Adamax(0.05, parameters=ps),
    "adamax_betas": lambda m, ps: m.optimizer.Adamax(
        0.05, beta1=0.8, beta2=0.99, epsilon=1e-6, parameters=ps,
        weight_decay=m.regularizer.L2Decay(0.01)),
    "adadelta": lambda m, ps: m.optimizer.Adadelta(1.0, parameters=ps),
    "adadelta_rho": lambda m, ps: m.optimizer.Adadelta(
        0.5, epsilon=1e-4, rho=0.8, parameters=ps,
        weight_decay=m.regularizer.L1Decay(0.01)),
    "rmsprop": lambda m, ps: m.optimizer.RMSProp(0.01, parameters=ps),
    "rmsprop_momentum": lambda m, ps: m.optimizer.RMSProp(
        0.01, rho=0.9, epsilon=1e-4, momentum=0.9, parameters=ps),
    "rmsprop_centered": lambda m, ps: m.optimizer.RMSProp(
        0.01, momentum=0.5, centered=True, parameters=ps),
    "lamb": lambda m, ps: m.optimizer.Lamb(0.01, parameters=ps),
    "lamb_options": lambda m, ps: m.optimizer.Lamb(
        0.01, lamb_weight_decay=0.1, beta1=0.8, beta2=0.99, epsilon=1e-4,
        parameters=ps),
    "lamb_clip": lambda m, ps: m.optimizer.Lamb(
        0.01, parameters=ps, grad_clip=m.nn.ClipGradByGlobalNorm(0.5)),
    "lars": lambda m, ps: m.optimizer.LarsMomentum(0.1, parameters=ps),
    "lars_options": lambda m, ps: m.optimizer.LarsMomentum(
        0.1, momentum=0.5, lars_coeff=0.01, lars_weight_decay=0.01,
        epsilon=1e-6, parameters=ps),
    "ftrl": lambda m, ps: m.optimizer.Ftrl(0.1, parameters=ps),
    "ftrl_l1_l2": lambda m, ps: m.optimizer.Ftrl(
        0.1, l1=0.05, l2=0.1, parameters=ps),
    "ftrl_power": lambda m, ps: m.optimizer.Ftrl(
        0.1, l1=0.01, l2=0.01, lr_power=-0.25, parameters=ps),
    "dpsgd_sigma0": lambda m, ps: m.optimizer.Dpsgd(
        0.1, clip=0.5, batch_size=4, sigma=0.0, parameters=ps),
}
# the rules whose reference keeps a bf16 parameter bf16 (Adamax, Lamb,
# LarsMomentum and Dpsgd promote it to float32: a float32 step scalar or
# norm multiplies it)
BF16_RULES = ["adagrad", "adadelta", "rmsprop_centered", "ftrl_l1_l2"]


def _grads(step, dtype=np.float32):
    rs = np.random.RandomState(60 + step)
    return [rs.randn(*s).astype(np.float32) for s in SHAPES]


def _w0():
    rs = np.random.RandomState(9)
    return [rs.randn(*s).astype(np.float32) for s in SHAPES]


def _port(make, steps=5, dtype=torch.float32):
    ps = [torch.nn.Parameter(torch.from_numpy(w).to(dtype)) for w in _w0()]
    opt = make(ptt, ps)
    for i in range(steps):
        for p, g in zip(ps, _grads(i)):
            p.grad = torch.from_numpy(g).to(dtype)
        opt.step()
        opt.clear_grad()
    return ps, opt


def _ref(make, steps=5, dtype="float32"):
    ps = [paddle.to_tensor(w, dtype=dtype, stop_gradient=False)
          for w in _w0()]
    opt = make(paddle, ps)
    for i in range(steps):
        for p, g in zip(ps, _grads(i)):
            p.grad = paddle.to_tensor(g, dtype=dtype)
        opt.step()
        opt.clear_grad()
    return ps, opt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x,
                      dtype=np.float32)


@pytest.mark.parametrize("name", sorted(RULES))
def test_eager_steps_match_the_reference(name):
    ours, opt = _port(RULES[name])
    ref, ropt = _ref(RULES[name])
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(_np(a), _np(b), **RTOL)
    for p, q in zip(ours, ref):
        got, want = opt._slots.get(id(p), {}), ropt._slots.get(id(q), {})
        assert sorted(got) == sorted(want)
        for n in got:
            np.testing.assert_allclose(_np(got[n]), _np(want[n]), **RTOL,
                                       err_msg=n)


@pytest.mark.parametrize("name", BF16_RULES)
def test_bf16_steps_match_the_reference(name):
    ours, _ = _port(RULES[name], dtype=torch.bfloat16)
    ref, _ = _ref(RULES[name], dtype="bfloat16")
    for a, b in zip(ours, ref):
        assert a.dtype == torch.bfloat16
        tol = 2 ** -5 * max(1.0, float(np.abs(_np(b)).max()))
        assert np.abs(_np(a) - _np(b)).max() <= tol


@pytest.mark.parametrize("name", sorted(RULES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_dtypes_are_the_references(name, dtype):
    ours, opt = _port(RULES[name], steps=0, dtype=getattr(torch, dtype))
    ref, ropt = _ref(RULES[name], steps=0, dtype=dtype)
    for p, q in zip(ours, ref):
        got = {n: str(v.dtype).split(".")[-1]
               for n, v in opt._get_slots(p).items()}
        want = {n: str(v.dtype) for n, v in ropt._get_slots(q).items()}
        assert got == want
    if name == "adagrad_init_eps":
        assert all((v == 0.5).all() for v in opt._get_slots(ours[0]).values())


def test_fluid_aliases():
    O = ptt.optimizer
    for alias, cls in (("SGDOptimizer", "SGD"), ("MomentumOptimizer",
                       "Momentum"), ("AdagradOptimizer", "Adagrad"),
                       ("AdamOptimizer", "Adam"), ("AdamaxOptimizer",
                       "Adamax"), ("AdadeltaOptimizer", "Adadelta"),
                       ("RMSPropOptimizer", "RMSProp"), ("LambOptimizer",
                       "Lamb"), ("LarsMomentumOptimizer", "LarsMomentum"),
                       ("FtrlOptimizer", "Ftrl"), ("DpsgdOptimizer",
                       "Dpsgd")):
        assert getattr(O, alias) is getattr(O, cls)
        assert hasattr(paddle.optimizer, alias)


# -- the fit form (apply_pytree) and the quirks --------------------------
X = np.random.RandomState(3).randn(16, 5).astype(np.float32)
Y = np.random.RandomState(4).randn(16, 3).astype(np.float32)


def _mse(out, label):
    return ((out - label) ** 2).mean()


def _nets(monkeypatch, weight_attr=None, ref_weight_attr=None):
    """A Linear(5, 3) in each package, from fresh name counters, with the
    reference's weights carried over."""
    monkeypatch.setattr(jlayer_base, "_name_counters", {})
    monkeypatch.setattr(tlayer_base, "_name_counters", {})
    ref = paddle.nn.Linear(5, 3, weight_attr=ref_weight_attr)
    ours = tnn.Linear(5, 3, weight_attr=weight_attr)
    with torch.no_grad():
        ours.weight.copy_(torch.from_numpy(_np(ref.weight)))
        ours.bias.copy_(torch.from_numpy(_np(ref.bias)))
    return ours, ref


def _fit(pkg, net, opt, epochs=1, cb=None):
    m = pkg.Model(net)
    m.prepare(opt, _mse)
    data = pkg.io.TensorDataset([X, Y] if pkg is paddle else
                                [torch.from_numpy(X), torch.from_numpy(Y)])
    return m.fit(data, batch_size=4, epochs=epochs, shuffle=False,
                 verbose=0, callbacks=cb)


FIT_RULES = ["adagrad", "adamax", "rmsprop_centered", "lamb_options",
             "lars_options", "ftrl_l1_l2", "dpsgd_sigma0"]


@pytest.mark.parametrize("name", FIT_RULES)
def test_fit_matches_the_references_fit(name, monkeypatch):
    ours, ref = _nets(monkeypatch)
    _fit(ptt, ours, RULES[name](ptt, ours.parameters()))
    _fit(paddle, ref, RULES[name](paddle, ref.parameters()))
    for a, b in ((ours.weight, ref.weight), (ours.bias, ref.bias)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


def test_quirk_i_fit_ignores_lr_ratios_and_decay_filter(monkeypatch):
    """Quirk (i): the fit step reads no ``optimize_attr`` learning rate and
    decays every parameter under AdamW's ``apply_decay_param_fun``, in
    both packages; the eager step honours both."""
    def opt(m, ps):
        return m.optimizer.AdamW(0.05, parameters=ps, weight_decay=0.5,
                                 apply_decay_param_fun=lambda n: False)

    ours, ref = _nets(monkeypatch, ptt.ParamAttr(learning_rate=0.1),
                      paddle.ParamAttr(learning_rate=0.1))
    plain = tnn.Linear(5, 3)
    plain.set_state_dict(ours.state_dict())
    _fit(ptt, ours, opt(ptt, ours.parameters()))
    _fit(paddle, ref, opt(paddle, ref.parameters()))
    _fit(ptt, plain, ptt.optimizer.AdamW(0.05, parameters=plain.parameters(),
                                         weight_decay=0.5))
    for a, b, c in ((ours.weight, ref.weight, plain.weight),
                    (ours.bias, ref.bias, plain.bias)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
        assert torch.equal(a, c)
    # the eager step: the ratio and the filter change the update
    eager, _ = _nets(monkeypatch, ptt.ParamAttr(learning_rate=0.1))
    o = opt(ptt, eager.parameters())
    w0 = eager.weight.detach().clone()
    twin = tnn.Linear(5, 3)
    twin.set_state_dict(eager.state_dict())
    eager(torch.from_numpy(X)).sum().backward()
    o.step()
    t = ptt.optimizer.AdamW(0.05, parameters=twin.parameters(),
                            weight_decay=0.5)
    twin(torch.from_numpy(X)).sum().backward()
    t.step()
    assert not torch.allclose(eager.weight - w0, twin.weight - w0)


@pytest.mark.parametrize("make", [
    lambda m, ps, ex: m.optimizer.Lamb(
        0.01, lamb_weight_decay=0.3, parameters=ps,
        exclude_from_weight_decay_fn=ex),
    lambda m, ps, ex: m.optimizer.LarsMomentum(
        0.1, lars_weight_decay=0.3, parameters=ps,
        exclude_from_weight_decay=None if ex is None else ["param"])],
    ids=["lamb", "lars"])
def test_quirk_ii_exclusions_are_never_read(make):
    """Quirk (ii): excluding every parameter from the decay changes
    nothing, in both packages."""
    for pkg, run in ((ptt, _port), (paddle, _ref)):
        with_ex, _ = run(lambda m, ps: make(m, ps, lambda n: True), steps=3)
        without, _ = run(lambda m, ps: make(m, ps, None), steps=3)
        for a, b in zip(with_ex, without):
            np.testing.assert_array_equal(_np(a), _np(b))


def test_quirk_iii_parameter_regularizers_are_never_read():
    """Quirk (iii): a ``ParamAttr(regularizer=)`` changes no update, in
    both packages, eager or fit."""
    for m, ns in ((ptt, tnn), (paddle, paddle.nn)):
        out = []
        for attr in (m.ParamAttr(regularizer=m.regularizer.L2Decay(10.0)),
                     None):
            m.seed(1)
            net = ns.Linear(5, 3, weight_attr=attr)
            _fit(m, net, m.optimizer.SGD(0.1, parameters=net.parameters()))
            out.append(_np(net.weight))
        np.testing.assert_array_equal(*out)


def test_quirk_iv_dpsgd_noise_is_fixed_in_the_fit_step(monkeypatch):
    """Quirk (iv): with a loss whose gradients are zero, every fit step of
    the reference moves the parameters by the same noise (its jitted step
    holds the key it was traced with), and so does the port's; the port's
    eager steps draw new noise each step."""
    def zero_loss(out, label):
        return ((out - label) ** 2).mean() * 0.0

    def deltas(pkg, net, opt):
        seen = [_np(net.bias).copy()]

        class Record(pkg.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                seen.append(_np(net.bias).copy())

        m = pkg.Model(net)
        m.prepare(opt, zero_loss)
        data = pkg.io.TensorDataset(
            [X, Y] if pkg is paddle else
            [torch.from_numpy(X), torch.from_numpy(Y)])
        m.fit(data, batch_size=4, shuffle=False, verbose=0,
              callbacks=[Record()])
        return np.diff(np.stack(seen), axis=0)

    ours, ref = _nets(monkeypatch)
    for pkg, net in ((ptt, ours), (paddle, ref)):
        d = deltas(pkg, net, pkg.optimizer.Dpsgd(
            0.1, clip=1.0, batch_size=4, sigma=1.0,
            parameters=net.parameters()))
        assert len(d) == 4 and np.abs(d[0]).max() > 0
        for row in d[1:]:
            # the same noise: equal up to the rounding of p + noise
            np.testing.assert_allclose(row, d[0], rtol=1e-5, atol=1e-8)
    eager = []
    p = torch.nn.Parameter(torch.zeros(64))
    opt = ptt.optimizer.Dpsgd(0.1, clip=1.0, batch_size=4, sigma=1.0,
                              parameters=[p])
    for _ in range(2):
        before = p.detach().clone()
        p.grad = torch.zeros(64)
        opt.step()
        eager.append(p.detach() - before)
    assert (eager[0] - eager[1]).abs().max() > 1e-3


def test_dpsgd_noise_is_deterministic_per_seed():
    def run(s):
        ptt.seed(s)
        p = torch.nn.Parameter(torch.zeros(1000))
        opt = ptt.optimizer.Dpsgd(1.0, clip=1.0, batch_size=1, sigma=1.0,
                                  parameters=[p])
        p.grad = torch.zeros(1000)
        opt.step()
        return p.detach().clone()

    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # -lr * noise with lr 1: standard normal draws
    assert abs(a.mean().item()) < 5 / 1000 ** 0.5
    assert abs(a.std().item() - 1.0) < 5 / (2 * 1000) ** 0.5


def test_dpsgd_groups_draw_distinct_noise_as_the_loop():
    """Parameters in several (dtype, learning-rate ratio) groups, which
    ``step()`` hands to the multi-tensor wrapper one group at a time: each
    tensor draws the noise of its own index across the whole step (no two
    groups restart at 0), and ``step()`` equals ``step_plain()``, the
    per-parameter loop, bit for bit."""
    def run(plain):
        ptt.seed(7)
        ps = [torch.nn.Parameter(torch.zeros(256, dtype=dt))
              for dt in (torch.float32, torch.float32, torch.bfloat16,
                         torch.float32)]
        ps[1].optimize_attr = {"learning_rate": 0.5}
        opt = ptt.optimizer.Dpsgd(1.0, clip=1.0, batch_size=1, sigma=1.0,
                                  parameters=ps)
        for p in ps:
            p.grad = torch.zeros_like(p)
        opt.step_plain() if plain else opt.step()
        return [p.detach().clone() for p in ps]

    got, want = run(False), run(True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # -lr * ratio * noise: the standard normal draws of each tensor
    noise = [got[0], got[1] / 0.5, got[2].float(), got[3]]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.allclose(noise[i], noise[j], atol=0.1), (i, j)
