"""The port's whole-tree optimizer update (ops/kernels/optimizer.py) on the
CPU, where the multi-tensor kernel cannot run:

- ``Optimizer.step``'s per-parameter loop computes bitwise what it
  computed before the update rules moved into ``update_plain`` (a frozen
  copy of the old loop is the oracle), for SGD, Momentum, Nesterov, Adam
  with coupled decay and AdamW, float32 and bfloat16, with a parameter
  that has no gradient, a global-norm clip and a scheduled lr;
- ``multi_tensor_step``'s CPU route is that loop;
- the chunk table covers every element of every tensor exactly once, in
  one launch or split over several;
- the kernel's scalars are the float32 values the eager ops use;
- no kernel, no fallback: a device without one, or a dtype without one,
  raises; a subclass with its own rule keeps the loop;
- ``multi_tensor_step`` over a tree of tensors against the JAX package's
  ``Optimizer.apply_pytree`` over the same tree, 3 steps, at the
  tolerance of the optimizer parity tests (rtol 1e-6, atol 1e-7: XLA
  may fuse the float32 ops in another order).

The kernel itself is held bitwise against the loop on the card
(tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.ops.kernels import optimizer as K

HYPER = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
         "weight_decay": 0.05, "momentum": 0.9, "rho": 0.95, "l1": 0.01,
         "l2": 0.02, "lr_power": -0.5}
FACTORIES = {
    "sgd": lambda ps, **kw: ptt.optimizer.SGD(parameters=ps, **kw),
    "momentum": lambda ps, **kw: ptt.optimizer.Momentum(
        momentum=0.9, parameters=ps, **kw),
    "nesterov": lambda ps, **kw: ptt.optimizer.Momentum(
        momentum=0.9, use_nesterov=True, parameters=ps, **kw),
    "adam": lambda ps, **kw: ptt.optimizer.Adam(
        parameters=ps, weight_decay=0.01, **kw),
    "adamw": lambda ps, **kw: ptt.optimizer.AdamW(
        parameters=ps, weight_decay=0.05, **kw),
}


def _old_update(kind, opt, p, g, slots, lr, t):
    """The update rules as optimizer/__init__.py wrote them before they
    moved into ``update_plain``."""
    def bc(beta):
        return float(np.float32(1.0) - np.float32(beta) ** np.float32(t))

    if kind == "sgd":
        return p - lr * g, slots
    if kind in ("momentum", "nesterov"):
        v = opt._momentum * slots["velocity"] + g
        if kind == "nesterov":
            return p - lr * (g + opt._momentum * v), {"velocity": v}
        return p - lr * v, {"velocity": v}
    b1, b2 = opt._beta1, opt._beta2
    g32 = g.float()
    m = b1 * slots["moment1"] + (1 - b1) * g32
    v = b2 * slots["moment2"] + (1 - b2) * g32.square()
    upd = lr * (m / bc(b1)) / ((v / bc(b2)).sqrt() + opt._epsilon)
    new_p = p - upd.to(p.dtype)
    if kind == "adamw":
        new_p = new_p - lr * opt._wd_coeff * p
    return new_p, {"moment1": m, "moment2": v}


def _old_step(kind, opt):
    """The old ``Optimizer.step``, verbatim but for the rules."""
    opt._step_count += 1
    params_grads = [(p, p.grad) for p in opt._parameter_list
                    if p.grad is not None and p.requires_grad]
    if opt._grad_clip is not None:
        params_grads = opt._grad_clip(params_grads)
    lr = opt.get_lr()
    for p, g in params_grads:
        slots = opt._get_slots(p)
        g = g.to(p.dtype) if g.dtype != p.dtype else g
        g = opt._apply_decay(p, g)
        new_p, new_slots = _old_update(kind, opt, p, g, slots, lr,
                                       opt._step_count)
        p.copy_(new_p)
        opt._slots[id(p)] = new_slots


def _params(dtype, seed=0):
    rs = np.random.RandomState(seed)
    shapes = [(5, 3), (7,), (1,), (4, 4)]
    return [torch.nn.Parameter(torch.from_numpy(
        rs.randn(*s).astype(np.float32)).to(dtype)) for s in shapes]


def _grads(params, step):
    rs = np.random.RandomState(100 + step)
    out = [torch.from_numpy(rs.randn(*p.shape).astype(np.float32)).to(
        p.dtype) for p in params]
    out[2] = None                     # the 1-element parameter: no grad
    return out


def _run(kind, dtype, step_fn, steps=3):
    params = _params(dtype)
    sched = ptt.optimizer.lr.StepDecay(0.05, step_size=1, gamma=0.7)
    opt = FACTORIES[kind](params, learning_rate=sched,
                          grad_clip=tnn.ClipGradByGlobalNorm(1.5))
    for i in range(steps):
        for p, g in zip(params, _grads(params, i)):
            p.grad = g
        step_fn(opt)
        opt.clear_grad()
        sched.step()
    return params, opt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", sorted(FACTORIES))
def test_step_is_bitwise_the_old_loop(kind, dtype):
    """step(), step_plain() and the old loop give the same bits, and the
    parameter without a gradient stays as it was."""
    new, opt_new = _run(kind, dtype, lambda o: o.step())
    plain, _ = _run(kind, dtype, lambda o: o.step_plain())
    old, opt_old = _run(kind, dtype,
                        lambda o: torch.no_grad()(_old_step)(kind, o))
    for a, b, c, p0 in zip(new, plain, old, _params(dtype)):
        assert torch.equal(a, c) and torch.equal(b, c)
    assert torch.equal(new[2], _params(dtype)[2])
    for p_new, p_old in zip(new, old):
        for n, v in opt_old._slots.get(id(p_old), {}).items():
            assert torch.equal(opt_new._slots[id(p_new)][n], v), n
    assert ptt.optimizer.Optimizer.plain_cuda_updates == 0


@pytest.mark.parametrize("kind", K.KINDS)
def test_multi_tensor_step_cpu_route_is_the_loop(kind):
    """The wrapper's CPU route updates params and slots in place, as
    update_plain gives them, and launches nothing."""
    rs = np.random.RandomState(5)
    params = [torch.from_numpy(rs.randn(*s).astype(np.float32))
              for s in ((3, 4), (1,), (70,))]
    grads = [torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
             for p in params]
    slots = [[torch.from_numpy(np.abs(rs.randn(*p.shape)).astype(
        np.float32)) for _ in range(K.SLOTS[kind])] for p in params]
    want = [K.update_plain(kind, p, g, s, 0.01, 4, HYPER)
            for p, g, s in zip(params, grads, slots)]
    before = K.multi_tensor_step.launches
    out = K.multi_tensor_step(kind, params, grads, slots, 0.01, 4, HYPER)
    assert K.multi_tensor_step.launches == before
    assert out == tuple(params)
    # exact, NaN equal to NaN (the centered RMSProp's variance estimate
    # from these arbitrary slots goes negative, its square root NaN)
    def same(a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        return True

    for p, s, (new_p, new_s) in zip(params, slots, want):
        assert same(p, new_p)
        assert len(s) == len(new_s)
        assert all(same(a, b) for a, b in zip(s, new_s))


def test_step_takes_the_wrapper_on_every_device(monkeypatch):
    """step() of an optimizer with a kernel sends its CPU parameters
    through multi_tensor_step (whose CPU route is the plain version), not
    through the per-parameter loop."""
    params, _ = _run("adamw", torch.float32, lambda o: None, steps=0)
    opt = FACTORIES["adamw"](params, learning_rate=0.01)
    calls = []
    monkeypatch.setattr(K, "multi_tensor_step",
                        lambda *a: calls.append(a[0]))
    monkeypatch.setattr(opt, "_step_plain", lambda *a: pytest.fail("loop"))
    for p, g in zip(params, _grads(params, 0)):
        p.grad = g
    opt.step()
    assert calls == ["adamw"]


def test_parameters_that_share_memory_are_refused():
    """One parameter listed twice, or two views of one buffer that
    overlap, would be updated by racing blocks of one launch: the wrapper
    refuses them on every device; disjoint views of one buffer pass."""
    p = torch.nn.Parameter(torch.ones(4, 3))
    p.grad = torch.ones(4, 3)
    opt = ptt.optimizer.AdamW(learning_rate=0.1, parameters=[p, p])
    with pytest.raises(ValueError, match="share memory"):
        opt.step()
    buf = torch.zeros(10)
    g = [torch.ones(6), torch.ones(6)]
    with pytest.raises(ValueError, match="share memory"):
        K.multi_tensor_step("sgd", [buf[:6], buf[4:]], g, [[], []], 0.1, 1,
                            {})
    K.multi_tensor_step("sgd", [buf[:5], buf[5:]], [x[:5] for x in g],
                        [[], []], 0.1, 1, {})
    assert torch.equal(buf, torch.full((10,), -0.1))


def _block_ranges(numels, chunk0, chunk):
    """What each block of one launch updates, found as the kernel finds
    it (csrc/multi_tensor_optim.cu): [(tensor index in the launch, first
    element, end)], by block."""
    out = []
    for b in range(chunk0[-1]):
        lo, hi = 0, len(numels) - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if chunk0[mid] <= b:
                lo = mid
            else:
                hi = mid - 1
        begin = (b - chunk0[lo]) * chunk
        out.append((lo, begin, min(begin + chunk, numels[lo])))
    return out


# the parameter trees the card runs (element counts, in parameter order)
LENET = [54, 6, 2400, 16, 48000, 120, 10080, 84, 840, 10]


def _gpt2_small(vocab=50304, d=768, ffn=3072, layers=12, pos=1024):
    block = [d, d, d * 3 * d, 3 * d, d * d, d, d, d, d * ffn, ffn, ffn * d, d]
    return [vocab * d, pos * d] + block * layers + [d, d]


def _bert_base(vocab=30522, d=768, ffn=3072, layers=12, pos=512):
    emb = [vocab * d, pos * d, 2 * d, d, d]
    layer = [d * d, d] * 4 + [d, d, d * ffn, ffn, ffn * d, d, d, d]
    heads = [d * d, d, d * d, d, d, d, vocab, d * 2, 2]
    return emb + layer * layers + heads


def _many(n=600, seed=0):
    rs = np.random.RandomState(seed)
    return [int(v) for v in rs.randint(0, 90_000, n)]


@pytest.mark.parametrize("numels,chunk,max_tensors,sms", [
    ([1], 8, 512, None),
    ([1, 8, 9, 17, 0, 3], 8, 512, None),   # 1 element, a chunk, more, empty
    ([100, 1, 64, 65, 0, 0, 7], 16, 3, None),   # split into launches of 3
    ([5] * 11, 4, 2, None),
    ([38_633_472, 768, 2_359_296, 1], 1 << 16, 512, None),   # GPT-2 sizes
    # the chunk sized to each launch on a card of 132 SMs
    ([1], None, 512, 132),
    (LENET, None, 512, 132),
    (_gpt2_small(), None, 512, 132),
    (_bert_base(), None, 512, 132),
    (_many(), None, 512, 132),             # 600 tensors: two launches
])
def test_chunk_table_covers_every_element_once(numels, chunk, max_tensors,
                                               sms):
    groups = K.chunk_groups(numels, chunk, max_tensors, sm_count=sms)
    seen = [np.zeros(n, dtype=np.int64) if n < 10_000_000 else None
            for n in numels]
    covered = [0] * len(numels)
    for idx, chunk0, size in groups:
        assert 0 < len(idx) <= max_tensors and len(chunk0) == len(idx) + 1
        sizes = [numels[i] for i in idx]
        if chunk is None:
            assert size == K.tree_chunk(sum(sizes), sms)
            assert K.CHUNK_FLOOR <= size <= K.CHUNK
            assert size % K.CHUNK_FLOOR == 0
        else:
            assert size == chunk
        for t, begin, end in _block_ranges(sizes, chunk0, size):
            assert 0 <= begin < end <= sizes[t] and end - begin <= size
            covered[idx[t]] += end - begin
            if seen[idx[t]] is not None:
                seen[idx[t]][begin:end] += 1
    assert covered == numels
    for s in seen:
        assert s is None or (s == 1).all()
    assert sorted(i for idx, _, _ in groups for i in idx) == \
        [i for i, n in enumerate(numels) if n]
    assert len(groups) == -(-sum(1 for n in numels if n) // max_tensors)


def test_the_chunk_gives_a_small_tree_two_blocks_an_sm():
    """LeNet's 61,610 elements take the floor, 1,024 a block: about 60
    blocks of one round each, where 65,536 made 10 blocks and walked fc1's
    48,000 elements in one; GPT-2-small's, BERT-base's and ResNet-50's
    trees keep 65,536."""
    ((_, chunk0, size),) = K.chunk_groups(LENET, sm_count=132)
    assert size == K.CHUNK_FLOOR == 1024 and 60 <= chunk0[-1] <= 70
    ((_, chunk0, _),) = K.chunk_groups(LENET, K.CHUNK)
    assert chunk0[-1] == 10
    for tree in (_gpt2_small(), _bert_base(), [25_557_032]):
        assert K.tree_chunk(sum(tree), 132) == K.CHUNK
    assert K.tree_chunk(2 * 132 * 3000, 132) == 3072


def _kernel_sumsq(x, chunk=4096, threads=256):
    """The float32 sum of squares of ``x`` as the norm kernels take it:
    in ``norm_partials_kernel`` each thread of a chunk's block adds its 4
    elements of each round (4 * ``threads`` elements) in order, the warps'
    lanes add as a xor tree and thread 0 adds the warps in order into the
    chunk's partial; in ``norm_update_kernel`` one warp adds the tensor's
    partials, lane l those l, l + 32, ..., then a xor tree.  ``chunk`` is
    smaller than the kernel's 65,536 here, so that a small tensor spans
    several chunks."""
    x = np.asarray(x, np.float32).reshape(-1)
    rounds = chunk // (4 * threads)
    n_chunks = -(-x.size // chunk)
    sq = np.zeros(n_chunks * chunk, np.float32)
    sq[:x.size] = x * x
    sq = sq.reshape(n_chunks, rounds, threads, 4)
    xor = [np.arange(32) ^ o for o in (16, 8, 4, 2, 1)]
    lanes = np.zeros(32, np.float32)
    for c in range(n_chunks):
        acc = np.zeros(threads, np.float32)
        for k in range(rounds):
            for e in range(4):
                acc = acc + sq[c, k, :, e]
        w = acc.reshape(-1, 32)
        for idx in xor:
            w = w + w[:, idx]
        part = np.float32(0)
        for v in w[:, 0]:
            part = np.float32(part + v)
        lanes[c % 32] = np.float32(lanes[c % 32] + part)
    for idx in xor:
        lanes = lanes + lanes[idx]
    return lanes[0]


NORM_HYPER = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
              "weight_decay": 0.01, "momentum": 0.9, "lars_coeff": 0.001,
              "clip": 0.5, "sigma": 1.0, "batch_size": 4}
NORM_LRS = {"lamb": 0.05, "lars": 10.0, "dpsgd": 1.0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["lamb", "lars", "dpsgd"])
def test_norm_update_model_is_the_loop_within_tolerance(
        kind, dtype, monkeypatch):
    """A plain model of the norm kernels' two-launch update: the loop's
    arithmetic with each norm summed in the kernels' order
    (``_kernel_sumsq``: chunk partials, then their sum) against the loop
    with torch's norms, 2 steps: every parameter and slot within
    NORM_RTOL (float32) or NORM_BF16_RTOL (bf16) of the tensor's largest
    |value|."""
    tol = K.NORM_RTOL if dtype == torch.float32 else K.NORM_BF16_RTOL
    sizes = [20_000, 700, 9_000, 3, 4_100]

    def run(model):
        rs = np.random.RandomState(9)
        ps = [torch.from_numpy(rs.randn(n).astype(np.float32)).to(dtype)
              for n in sizes]
        slots = [[torch.zeros_like(p) for _ in range(K.SLOTS[kind])]
                 for p in ps]
        if model:
            monkeypatch.setattr(K, "_norm", lambda x: torch.tensor(np.sqrt(
                _kernel_sumsq(x.detach().float().numpy()))))
        for t in (1, 2):
            gs = [torch.from_numpy(0.1 * rs.randn(n).astype(np.float32))
                  .to(dtype) for n in sizes]
            K.multi_tensor_step_plain(kind, ps, gs, slots, NORM_LRS[kind],
                                      t, NORM_HYPER, seed=11)
        monkeypatch.undo()
        return ps + [s for ss in slots for s in ss]

    got, want = run(True), run(False)
    for a, b in zip(got, want):
        scale = b.float().abs().max().clamp_min(1e-30)
        assert ((a.float() - b.float()).abs().max() / scale).item() <= tol


def test_kernel_scalars_are_the_eager_float32_values():
    f = np.float32
    lr, t = 2e-4, 7
    vals = list(K.hyper_floats("adamw", lr, t, HYPER))
    bc1 = f(1) - f(0.9) ** f(t)
    bc2 = f(1) - f(0.999) ** f(t)
    want = [f(lr), f(0.9), f(1 - 0.9), f(0.999), f(1 - 0.999),
            f(1) / bc1, f(1) / bc2, f(1e-8), f(lr * 0.05)]
    # the first nine are AdamW's; the rest belong to other rules
    assert [f(v) for v in vals] == want + [f(0)] * (K.N_SCALARS - 9)
    assert list(K.hyper_floats("momentum", lr, t, HYPER))[:2] == \
        [float(f(lr)), float(f(0.9))]


def test_no_kernel_no_fallback():
    """A parameter on a device without a kernel raises in step(), as the
    wrapper does; float64 (no kernel; float16 has one since AMP) is
    refused before any launch."""
    p = torch.nn.Parameter(torch.zeros(4, 3, device="meta"))
    p.grad = torch.zeros(4, 3, device="meta")
    opt = ptt.optimizer.AdamW(learning_rate=0.1, parameters=[p])
    with pytest.raises(RuntimeError, match="no kernel"):
        opt.step()
    h = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        K._check("adam", [h], [h], [[h.float(), h.float()]])
    h = torch.zeros(3, dtype=torch.float16)
    K._check("adam", [h], [h], [[h.float(), h.float()]])
    x = torch.zeros(3)
    with pytest.raises(ValueError, match="slots"):
        K._check("adam", [x], [x], [[x.double(), x]])
    with pytest.raises(ValueError, match="no rule"):
        K._check("lion", [x], [x], [[]])


def test_a_subclass_with_its_own_rule_keeps_the_loop():
    class Halved(ptt.optimizer.SGD):
        def _update(self, p, g, slots, lr, t):
            return p - 0.5 * lr * g, slots

    class Decayed(ptt.optimizer.AdamW):
        def _apply_decay(self, p, g):
            return g + p

    ps = _params(torch.float32)
    assert Halved(parameters=ps)._kernel_spec() is None
    assert Decayed(parameters=ps)._kernel_spec() is None
    assert FACTORIES["adamw"](ps)._kernel_spec() == ("adamw", {
        "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
        "weight_decay": 0.05})
    assert FACTORIES["nesterov"](ps)._kernel_spec() == (
        "nesterov", {"momentum": 0.9})
    assert ptt.optimizer.Optimizer(parameters=ps)._kernel_spec() is None


def test_set_state_dict_leaves_slots_the_kernel_takes():
    """Restored slots are fresh contiguous tensors on the parameter's
    device, in the dtype the optimizer keeps them in: float32 moments for
    a bf16 parameter, a bf16 velocity for a bf16 parameter."""
    p = torch.nn.Parameter(torch.zeros(4, 3, dtype=torch.bfloat16))
    m1 = torch.arange(24, dtype=torch.float64).reshape(3, 8)[:, ::2].T
    sd = {"step_count": 2, "0__moment1": m1,
          "0__moment2": np.ones((4, 3), np.float32)}
    adam = ptt.optimizer.Adam(parameters=[p])
    adam.set_state_dict(sd)
    for n, v in adam._slots[id(p)].items():
        assert v.dtype == torch.float32 and v.is_contiguous(), n
    assert torch.equal(adam._slots[id(p)]["moment1"], m1.float())
    mom = ptt.optimizer.Momentum(parameters=[p])
    mom.set_state_dict({"step_count": 1,
                        "0__velocity": np.ones((4, 3), np.float32)})
    assert mom._slots[id(p)]["velocity"].dtype == torch.bfloat16


JAX_OPTIMIZERS = {
    "sgd": lambda: paddle.optimizer.SGD(learning_rate=0.1),
    "momentum": lambda: paddle.optimizer.Momentum(learning_rate=0.1,
                                                  momentum=0.9),
    "nesterov": lambda: paddle.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, use_nesterov=True),
    "adam": lambda: paddle.optimizer.Adam(learning_rate=0.1),
    "adamw": lambda: paddle.optimizer.AdamW(learning_rate=0.1,
                                            weight_decay=0.05),
    "adagrad": lambda: paddle.optimizer.Adagrad(learning_rate=0.1,
                                                epsilon=1e-8),
    "adamax": lambda: paddle.optimizer.Adamax(learning_rate=0.1),
    "adadelta": lambda: paddle.optimizer.Adadelta(learning_rate=0.1,
                                                  epsilon=1e-8),
    "rmsprop": lambda: paddle.optimizer.RMSProp(
        learning_rate=0.1, epsilon=1e-8, momentum=0.9),
    "rmsprop_centered": lambda: paddle.optimizer.RMSProp(
        learning_rate=0.1, epsilon=1e-8, momentum=0.9, centered=True),
    "ftrl": lambda: paddle.optimizer.Ftrl(learning_rate=0.1, l1=0.01,
                                          l2=0.02),
}
SLOT_NAMES = {"sgd": [], "momentum": ["velocity"], "nesterov": ["velocity"],
              "adam": ["moment1", "moment2"],
              "adamw": ["moment1", "moment2"], "adagrad": ["moment"],
              "adamax": ["moment", "inf_norm"],
              "adadelta": ["avg_squared_grad", "avg_squared_update"],
              "rmsprop": ["mean_square", "mean_grad", "momentum"],
              "rmsprop_centered": ["mean_square", "mean_grad", "momentum"],
              "ftrl": ["squared", "linear"]}


@pytest.mark.parametrize("kind", K.KINDS)
def test_multi_tensor_step_matches_apply_pytree(kind):
    """Three whole-tree updates of four tensors (one of 1 element) from
    the same seeded values: the port's wrapper (CPU route) against the
    reference's ``apply_pytree``; parameters and every slot."""
    rs = np.random.RandomState(11)
    shapes = {"w": (6, 5), "b": (5,), "s": (1,), "e": (9, 4)}
    p0 = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    ref = JAX_OPTIMIZERS[kind]()
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    jstate = ref.init_pytree(jp)
    params = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    slots = {n: [torch.zeros(s) for _ in SLOT_NAMES[kind]]
             for n, s in shapes.items()}
    names = sorted(shapes)
    for t, g in enumerate(grads, start=1):
        jp, jstate = ref.apply_pytree(
            jp, {n: jnp.asarray(v) for n, v in g.items()}, jstate, lr=0.1,
            step=t)
        K.multi_tensor_step(kind, [params[n] for n in names],
                            [torch.from_numpy(g[n]) for n in names],
                            [slots[n] for n in names], 0.1, t, HYPER)
    for n in names:
        np.testing.assert_allclose(params[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
        for slot, v in zip(SLOT_NAMES[kind], slots[n]):
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(jstate[n][slot]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{n}/{slot}")
