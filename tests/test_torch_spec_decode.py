"""The port's speculative decode on the CPU against the JAX package's
(tests/test_spec_decode.py's contract and config: vocab 211, hidden 48, a
2-layer target, a 1-layer draft seeded from the target's embeddings and
first block, an independently seeded bad draft, 3 slots, max_seq_len 40,
buckets 8 and 16, spec_tokens 3; the same weights through
``load_numpy_state``; the port runs its plain versions).

* ``slot_verify_paged``: logits and both pools against the reference's
  on the same inputs, float32, atol = rtol = 1e-5.  A candidate clamped
  onto the position of the one before it writes nothing in the port (the
  reference lets either write win: garbage no emitted query reads), so
  the clamped case is held at the candidates before the clamped position
  and the pools outside the collided entry.
* The draft pool: after a miss, a prefix hit and a chunked prefill
  (page size 4, prefill_chunk 8), ``dkp``/``dvp`` (and ``kp``/``vp``)
  equal the JAX spec engine's.
* Greedy spec tokens equal the JAX spec engine's, the port's plain
  engine's and a solo ``generate``'s, also on staggered admissions; with
  the bad draft every token is the solo run's and the accept ratio is in
  [0, 0.9).  A seeded sampled stream equals the port's plain engine's
  (port to port: JAX's threefry chain cannot be reproduced in PyTorch).
* The counters, their Prometheus names, the constructor's errors, one
  host fetch a step, and the handle's ``ttft_ms`` and the engine's
  ``draining``.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.serving import GenerationEngine as JGenerationEngine
from paddle_tpu_torch import Model
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.serving import GenerationEngine

CFG = dict(vocab_size=211, hidden_size=48, num_heads=4,
           max_position_embeddings=128, dropout=0.0, attn_dropout=0.0)
ENGINE = dict(max_slots=3, max_seq_len=40, prompt_buckets="8,16")
K = 3
TOL = dict(atol=1e-5, rtol=1e-5)
SAMPLE_KW = dict(do_sample=True, temperature=0.8, top_k=5)
PROMPTS = [list(range(3, 10)), [5, 9, 2], list(range(50, 62)),
           [7, 7, 7, 11, 2, 4]]


def _jax_gpt(layers, seed):
    paddle.seed(seed)
    m = JGPTForCausalLM(JGPTConfig(num_layers=layers, **CFG))
    m.eval()
    return m


def _port(jax_model, layers):
    m = GPTForCausalLM(GPTConfig(num_layers=layers, **CFG), device="cpu")
    load_numpy_state(m, {k: np.asarray(v.numpy())
                         for k, v in jax_model.state_dict().items()})
    return m.eval()


@pytest.fixture(scope="module")
def jax_models():
    """The reference test's three models: the target, the draft seeded from
    its embeddings and first block, and the independently seeded one."""
    target = _jax_gpt(2, 0)
    draft = _jax_gpt(1, 0)
    sd, dsd = target.state_dict(), draft.state_dict()
    draft.set_state_dict({k: (sd[k] if k in sd and tuple(sd[k].shape)
                              == tuple(v.shape) else v)
                          for k, v in dsd.items()})
    return target, draft, _jax_gpt(1, 99)


@pytest.fixture(scope="module")
def models(jax_models):
    target, draft, bad = jax_models
    return _port(target, 2), _port(draft, 1), _port(bad, 1)


@pytest.fixture(scope="module")
def eng_plain(models):
    eng = GenerationEngine(models[0], device="cpu", **ENGINE).start()
    yield eng
    eng.stop()


@pytest.fixture(scope="module")
def eng_spec(models):
    eng = GenerationEngine(models[0], device="cpu", draft_model=models[1],
                           spec_tokens=K, **ENGINE).start()
    yield eng
    eng.stop()


@pytest.fixture(scope="module")
def jax_spec_tokens(jax_models):
    target, draft, _ = jax_models
    eng = JGenerationEngine(target, draft_model=draft, spec_tokens=K,
                            **ENGINE).start()
    try:
        hs = [eng.submit(p, 12, seed=i) for i, p in enumerate(PROMPTS)]
        return [h.result(120) for h in hs]
    finally:
        eng.stop()


def solo(model, prompt, n):
    out = model.generate(torch.tensor([prompt]), max_new_tokens=n)
    return out[0, len(prompt):].tolist()


def _wait_idle(eng, timeout=30):
    t0 = time.monotonic()
    while eng._sched.occupied or eng._backlog or not eng._queue.empty():
        assert time.monotonic() - t0 < timeout
        time.sleep(0.005)


# -- slot_verify_paged ---------------------------------------------------------
def _verify_inputs(rs, clamp):
    """Pools with random contents, page tables scattered through them, lane
    0 at position 5, lane 1 at 17 (a page boundary inside its window),
    lane 2 inactive (an all -1 row); with ``clamp`` lane 1's window runs
    past its budget: its last two candidates clamp onto position 18."""
    L, pages, ps, nh, hd = 2, 24, 4, 4, 12
    kp = rs.randn(L, pages, ps, nh, hd).astype(np.float32)
    vp = rs.randn(L, pages, ps, nh, hd).astype(np.float32)
    rows = np.full((3, 10), -1, np.int32)
    perm = rs.permutation(pages).astype(np.int32)
    rows[0, :3], rows[1, :6] = perm[:3], perm[3:9]
    positions = np.stack([5 + np.arange(K + 1), 17 + np.arange(K + 1),
                          np.zeros(K + 1, np.int64)]).astype(np.int32)
    if clamp:
        positions[1] = np.minimum(positions[1], 18)
    tokens = rs.randint(0, 211, (3, K + 1)).astype(np.int32)
    active = np.array([True, True, False])
    return tokens, positions, active, kp, vp, rows


@pytest.mark.parametrize("clamp", [False, True], ids=["window", "clamped"])
def test_slot_verify_paged_matches_jax(jax_models, models, clamp):
    rs = np.random.RandomState(4 + clamp)
    tokens, positions, active, kp, vp, rows = _verify_inputs(rs, clamp)
    jl, jkp, jvp = jax_models[0].slot_verify_paged(
        jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(active),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(rows), 40)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    lg, okp, ovp = models[0].slot_verify_paged(
        torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(active), tkp, tvp, torch.from_numpy(rows), 40)
    assert okp is tkp and ovp is tvp            # written in place
    assert lg.shape == (3, K + 1, 211)
    jl, jkp, jvp = np.array(jl), np.array(jkp), np.array(jvp)
    got_kp, got_vp = tkp.numpy(), tvp.numpy()
    if clamp:
        # lane 1 before its clamp (candidate 1 sits at the clamped
        # position, whose entry either side may hold: never emitted), the
        # other lanes whole; the collided entry left out of the pools
        for lane, upto in ((0, K + 1), (1, 1), (2, K + 1)):
            np.testing.assert_allclose(lg.numpy()[lane, :upto],
                                       jl[lane, :upto], **TOL)
        page, off = rows[1, 18 // 4], 18 % 4
        for a in (got_kp, got_vp, jkp, jvp):
            a[:, page, off] = 0.0
    else:
        np.testing.assert_allclose(lg.numpy(), jl, **TOL)
    np.testing.assert_allclose(got_kp, jkp, **TOL)
    np.testing.assert_allclose(got_vp, jvp, **TOL)
    # what the window wrote: each candidate's K/V at its position
    assert not np.allclose(got_kp, kp)


def test_slot_verify_paged_is_eval_only(models):
    model = models[0]
    model.train()
    try:
        with pytest.raises(RuntimeError, match="eval-only"):
            model.slot_verify_paged(
                torch.zeros((1, 2), dtype=torch.int32),
                torch.zeros((1, 2), dtype=torch.int32),
                torch.ones(1, dtype=torch.bool),
                torch.zeros(2, 4, 4, 4, 12), torch.zeros(2, 4, 4, 4, 12),
                torch.zeros((1, 2), dtype=torch.int32), 8)
    finally:
        model.eval()


# -- the draft pool through the three admission paths -------------------------
ADMIT_ENGINE = dict(ENGINE, page_size=4, prefill_chunk=8)
ADMISSIONS = [("miss", list(range(3, 10))),                  # L = 7
              ("hit", list(range(3, 7)) + [40, 41, 42]),     # 1 shared page
              ("chunk", list(range(60, 74)))]                # 2 chunks


@pytest.fixture(scope="module")
def jax_admitted(jax_models):
    """The JAX spec engine's four pools after each admission (a request of
    one new token: admitted, then retired at once)."""
    target, draft, _ = jax_models
    eng = JGenerationEngine(target, draft_model=draft, spec_tokens=K,
                            **ADMIT_ENGINE).start()
    try:
        out = {}
        for name, prompt in ADMISSIONS:
            eng.generate(prompt, 1, timeout=120)
            out[name] = {k: np.asarray(eng._state[k])
                         for k in ("kp", "vp", "dkp", "dvp")}
        snap = eng.metrics.snapshot()
        assert snap["prefix_cache_hits"] == 1 and snap["prefill_chunks"] == 2
        return out
    finally:
        eng.stop()


def test_every_admission_path_fills_the_draft_pool_as_jax(models,
                                                          jax_admitted):
    eng = GenerationEngine(models[0], device="cpu", draft_model=models[1],
                           spec_tokens=K, **ADMIT_ENGINE).start()
    try:
        assert eng._state["dkp"].shape == eng.geometry.draft_pool_shape \
            == (1, 30, 4, 4, 12)
        for name, prompt in ADMISSIONS:
            before = eng._state["dkp"].clone()
            eng.generate(prompt, 1, timeout=120)
            _wait_idle(eng)
            # the path wrote into the draft pool
            assert not torch.equal(eng._state["dkp"], before), name
            for key, want in jax_admitted[name].items():
                np.testing.assert_allclose(eng._state[key].numpy(), want,
                                           err_msg=f"{name} {key}", **TOL)
        snap = eng.metrics.snapshot()
        assert snap["prefix_cache_hits"] == 1 and snap["prefill_chunks"] == 2
    finally:
        eng.stop()


# -- tokens --------------------------------------------------------------------
def test_greedy_tokens_equal_jax_plain_and_solo(models, eng_plain, eng_spec,
                                                jax_spec_tokens):
    hp = [eng_plain.submit(p, 12, seed=i) for i, p in enumerate(PROMPTS)]
    hs = [eng_spec.submit(p, 12, seed=i) for i, p in enumerate(PROMPTS)]
    plain = [h.result(120) for h in hp]
    spec = [h.result(120) for h in hs]
    assert spec == plain == jax_spec_tokens
    assert spec == [solo(models[0], p, 12) for p in PROMPTS]


def test_mid_decode_admission(eng_plain, eng_spec):
    def staggered(eng):
        hs = []
        for i, p in enumerate(PROMPTS):
            hs.append(eng.submit(p, 10, seed=i))
            time.sleep(0.03)       # land mid-iteration of the others
        return [h.result(120) for h in hs]

    assert staggered(eng_spec) == staggered(eng_plain)


def test_sampled_stream_equals_the_plain_engine(eng_plain, eng_spec):
    a = eng_plain.generate(PROMPTS[1], 12, timeout=120, seed=7, **SAMPLE_KW)
    b = eng_spec.generate(PROMPTS[1], 12, timeout=120, seed=7, **SAMPLE_KW)
    assert a == b and len(a) == 12


def test_rejection_heavy_draft_keeps_every_token(models):
    eng = GenerationEngine(models[0], device="cpu", draft_model=models[2],
                           spec_tokens=K, max_slots=2, max_seq_len=40,
                           prompt_buckets="8,16").start()
    try:
        for p in PROMPTS:
            assert eng.generate(p, 10, timeout=120) == solo(models[0], p, 10)
        snap = eng.metrics.snapshot()
        assert snap["spec_proposed"] > 0
        assert 0.0 <= snap["spec_accept_ratio"] < 0.9
        _wait_idle(eng)
        assert eng.free_count + eng.resident_pages == eng.geometry.num_pages
    finally:
        eng.stop()


def test_accept_ratio_counters_and_names(eng_spec):
    eng_spec.generate(PROMPTS[0], 12, timeout=120)
    snap = eng_spec.metrics.snapshot()
    assert snap["spec_proposed"] > 0
    assert 0.0 < snap["spec_accept_ratio"] <= 1.0
    text = eng_spec.metrics.prometheus_text()
    for name in ("paddle_genserve_spec_accept_ratio",
                 "paddle_genserve_spec_proposed_total",
                 "paddle_genserve_spec_accepted_total"):
        assert name in text


class _HostSyncs(TorchDispatchMode):
    """``aten._local_scalar_dense`` calls and copies to the CPU device."""

    def __init__(self):
        super().__init__()
        self.scalars = self.fetches = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket is torch.ops.aten._local_scalar_dense:
            self.scalars += 1
        elif func.overloadpacket is torch.ops.aten._to_copy \
                and kwargs.get("device") == torch.device("cpu"):
            self.fetches += 1
        return func(*args, **kwargs)


def test_spec_step_fetches_to_the_host_once(models):
    """Every ``step_spec()`` of a greedy and a sampled request makes one
    host round trip (outs, emitted and finished together) and no
    ``_local_scalar_dense``."""
    eng = GenerationEngine(models[0], device="cpu", draft_model=models[1],
                           spec_tokens=K, **ENGINE).start()
    step, seen = eng.step_spec, []

    def counted():                       # runs on the decode thread
        with _HostSyncs() as syncs:
            out = step()
        seen.append((syncs.scalars, syncs.fetches))
        return out

    eng.step_spec = counted
    try:
        hs = [eng.submit(PROMPTS[0], 10),
              eng.submit(PROMPTS[2], 10, seed=3, **SAMPLE_KW)]
        assert all(len(h.result(120)) == 10 for h in hs)
    finally:
        eng.stop()
    assert seen and all(s == (0, 1) for s in seen), seen


def test_constructor_errors(models, jax_models):
    target, draft, _ = models

    class NoDecode:
        cfg = draft.cfg
        slot_prefill = slot_prefill_prefix = None

    with pytest.raises(TypeError, match="slot_decode_paged"):
        GenerationEngine(target, device="cpu", draft_model=NoDecode(),
                         **ENGINE)
    other = GPTForCausalLM(GPTConfig(**dict(CFG, vocab_size=97),
                                     num_layers=1), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        GenerationEngine(target, device="cpu", draft_model=other, **ENGINE)
    short = GPTForCausalLM(GPTConfig(**dict(CFG, max_position_embeddings=32),
                                     num_layers=1), device="cpu")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        GenerationEngine(target, device="cpu", draft_model=short, **ENGINE)
    with pytest.raises(ValueError, match="spec_tokens"):
        GenerationEngine(target, device="cpu", draft_model=draft,
                         spec_tokens=0, **ENGINE)
    # the reference raises the same three
    jt, jd, _ = jax_models
    with pytest.raises(ValueError, match="spec_tokens"):
        JGenerationEngine(jt, draft_model=jd, spec_tokens=0, **ENGINE)
    # without a draft spec_tokens is 0; a hapi.Model is unwrapped
    assert GenerationEngine(target, device="cpu", spec_tokens=5,
                            **ENGINE).spec_tokens == 0
    eng = GenerationEngine(Model(target), device="cpu",
                           draft_model=Model(draft), **ENGINE)
    assert eng.model is target and eng.draft_model is draft
    assert eng.spec_tokens == 4          # FLAGS_genserve_spec_tokens
    assert eng.geometry.page_bytes() == 2 * 16 * (2 + 1) * 48 * 4


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_handle_ttft_and_draining_as_the_reference(models, jax_models, pkg):
    """``ttft_ms`` is None before the first token; ``draining`` turns True
    at ``drain()``, on both packages' classes."""
    from paddle_tpu.serving.generation import \
        GenerationHandle as JGenerationHandle
    from paddle_tpu_torch.serving.generation import GenerationHandle

    handle = (JGenerationHandle if pkg == "jax" else GenerationHandle)(3, 4)
    assert handle.ttft_ms is None and handle.t_first_token is None
    eng = JGenerationEngine(jax_models[0], **ENGINE) if pkg == "jax" \
        else GenerationEngine(models[0], device="cpu", **ENGINE)
    assert eng.draining is False
    assert eng.drain(timeout=10) and eng.draining is True


def test_ttft_is_positive_and_within_the_request(models):
    eng = GenerationEngine(models[0], device="cpu", draft_model=models[1],
                           spec_tokens=K, **ENGINE).start()
    try:
        t0 = time.monotonic()
        h = eng.submit(PROMPTS[0], 6)
        assert len(h.result(120)) == 6
        wall_ms = (time.monotonic() - t0) * 1e3
        assert 0.0 < h.ttft_ms <= wall_ms
        assert h.t_first_token - h.t_submit == pytest.approx(h.ttft_ms / 1e3)
    finally:
        eng.stop()
