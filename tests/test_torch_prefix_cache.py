"""The port's prefix cache and chunked prefill on the CPU, against the
JAX package's (same weights through ``load_numpy_state``).

* ``PrefixCache``: the reference's two unit tests, run against both
  classes.
* ``slot_prefill_prefix``: k_suf, v_suf and the logits against the JAX
  model's for a prefix with a garbage tail past ``prefix_len``, float32,
  atol = rtol = 1e-5 (summation order only).
* The engine with ``prefix_cache=True`` (the config of
  tests/test_generation_serving.py, page_size 4): greedy tokens of a
  miss, a hit, a partial hit and a prompt too short to share equal the
  JAX engine's in the same order of traffic; a seeded sampled hit equals
  its miss (JAX's threefry chain cannot be reproduced in PyTorch); the
  hit/miss counters; ``free_count + resident_pages == num_pages`` when
  idle; pool pressure evicts idle entries and returns their pages through
  ``reclaim_pages``.
* Chunked prefill (``prefill_chunk=8``, as tests/test_spec_decode.py):
  greedy tokens equal the JAX chunked engine's and the unchunked port
  engine's (sampled: the unchunked port engine's), also for a chunked
  prompt that starts with a prefix-cache hit; a short stream is not
  starved by a long prefill; a cancel mid-chunk leaks no page.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.serving import GenerationEngine as JGenerationEngine
from paddle_tpu.serving.prefix_cache import PrefixCache as JPrefixCache
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.serving import GenerationEngine
from paddle_tpu_torch.serving import kv_cache
from paddle_tpu_torch.serving.prefix_cache import PrefixCache

CFG = dict(vocab_size=211, hidden_size=48, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0, attn_dropout=0.0)
TOL = dict(atol=1e-5, rtol=1e-5)
PREFIX_ENGINE = dict(max_slots=3, max_seq_len=40, prompt_buckets="8,16",
                     page_size=4)
CHUNK_ENGINE = dict(max_slots=3, max_seq_len=64, prompt_buckets="16,48",
                    page_size=4)
PROMPT_B = [5, 9, 2]                   # L=3: too short to share a page
PROMPT_C = list(range(50, 62))         # L=12: 2 shareable pages
PARTIAL = PROMPT_C[:8] + [7, 3, 11, 13]
SAMPLE_KW = dict(do_sample=True, temperature=0.8, top_k=5)
_rs = np.random.RandomState(3)
LONG = [[int(t) for t in _rs.randint(1, 211, L)] for L in (40, 23, 33)]
# shares LONG[0]'s first 4 pages, then 20 tokens of its own: a hit whose
# suffix is still chunked
LONG_HIT = LONG[0][:16] + [int(t) for t in _rs.randint(1, 211, 20)]


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    m = JGPTForCausalLM(JGPTConfig(**CFG))
    m.eval()
    return m


@pytest.fixture(scope="module")
def model(jax_model):
    m = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_numpy_state(m, {k: np.asarray(v.numpy())
                         for k, v in jax_model.state_dict().items()})
    return m.eval()


def _wait_idle(eng, timeout=30):
    t0 = time.monotonic()
    while eng._sched.occupied or eng._backlog or not eng._queue.empty():
        assert time.monotonic() - t0 < timeout
        time.sleep(0.005)


def _pages_accounted(eng):
    _wait_idle(eng)
    return eng.free_count + eng.resident_pages == eng.geometry.num_pages


# -- PrefixCache -------------------------------------------------------------
@pytest.mark.parametrize("cls", [JPrefixCache, PrefixCache],
                         ids=["jax", "port"])
def test_prefix_cache_units(cls):
    pc = cls(page_size=4)
    assert pc.shareable_pages(4) == 0       # needs >= 1 suffix token
    assert pc.shareable_pages(5) == 1
    assert pc.shareable_pages(12) == 2
    prompt = np.arange(12, dtype=np.int32)
    assert pc.lookup(prompt) == (0, ())
    row = np.array([10, 11, 12], np.int32)
    pc.pin([10, 11])
    assert pc.register(prompt, row, 0, 2) == []
    j, pages = pc.lookup(prompt)
    assert j == 2 and pages == (10, 11)
    # a prompt sharing one page hits the shorter entry
    other = np.array([0, 1, 2, 3, 9, 9], np.int32)
    assert pc.lookup(other) == (1, (10,))
    assert pc.resident_pages == 2
    # unpin: entries still reference both pages -> nothing reclaimed
    assert pc.unpin([10, 11]) == []
    assert pc.resident_pages == 2


@pytest.mark.parametrize("cls", [JPrefixCache, PrefixCache],
                         ids=["jax", "port"])
def test_prefix_cache_eviction_reclaims(cls):
    pc = cls(page_size=2, capacity=2)
    a = np.array([1, 2, 3], np.int32)       # 1 shareable page
    b = np.array([4, 5, 6], np.int32)
    c = np.array([7, 8, 9], np.int32)
    assert pc.register(a, np.array([0], np.int32), 0, 1) == []
    assert pc.register(b, np.array([1], np.int32), 0, 1) == []
    # third entry LRU-evicts a's entry; page 0 is unreferenced
    assert pc.register(c, np.array([2], np.int32), 0, 1) == [0]
    assert pc.lookup(a) == (0, ()) and pc.lookup(c) == (1, (2,))
    assert pc.evict_idle(1) == [1] and len(pc) == 1


# -- the model ---------------------------------------------------------------
@pytest.mark.parametrize("prefix_len,C,suffix,bucket", [
    (4, 12, 5, 8), (8, 8, 8, 8), (12, 16, 3, 16), (0, 4, 6, 8)])
def test_slot_prefill_prefix_matches_jax(jax_model, model, prefix_len, C,
                                         suffix, bucket):
    rs = np.random.RandomState(prefix_len * 31 + C)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :suffix] = rs.randint(0, CFG["vocab_size"], suffix)
    # entries past prefix_len are garbage the mask must hide
    pk = rs.randn(2, C, 4, 12).astype(np.float32)
    pv = rs.randn(2, C, 4, 12).astype(np.float32)
    length = prefix_len + suffix
    jk, jv, jl = jax_model.slot_prefill_prefix(
        Tensor(jnp.asarray(ids)), jnp.asarray(pk), jnp.asarray(pv),
        prefix_len, length)
    k, v, lg = model.slot_prefill_prefix(
        torch.from_numpy(ids).long(), torch.from_numpy(pk),
        torch.from_numpy(pv), prefix_len, length)
    assert k.shape == (2, bucket, 4, 12) and lg.shape == (211,)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)


def test_slot_prefill_prefix_continues_slot_prefill(model):
    """A prompt prefilled whole and the same prompt prefilled as a
    page-aligned prefix plus its suffix give the same suffix K/V and
    logits."""
    prompt = np.arange(3, 16)                      # L = 13
    ids = torch.zeros((1, 16), dtype=torch.long)
    ids[0, :13] = torch.from_numpy(prompt)
    k, v, lg = model.slot_prefill(ids, 13)
    suf = torch.zeros((1, 8), dtype=torch.long)
    suf[0, :5] = torch.from_numpy(prompt[8:])
    k2, v2, lg2 = model.slot_prefill_prefix(suf, k[:, :8], v[:, :8], 8, 13)
    torch.testing.assert_close(k2[:, :5], k[:, 8:13], **TOL)
    torch.testing.assert_close(v2[:, :5], v[:, 8:13], **TOL)
    torch.testing.assert_close(lg2, lg, **TOL)


def test_write_prompt_maps_shared_pages_and_release_keeps_them():
    geom = kv_cache.CacheGeometry(
        num_layers=1, max_slots=2, max_seq_len=16, num_heads=1, head_dim=2,
        vocab_size=7, page_size=2)
    st = kv_cache.make_state(geom, "cpu")
    k = torch.arange(8, dtype=torch.float32).reshape(1, 4, 1, 2)
    # slot 0: a miss over 2 pages (popped off the top: 15, 14), which it
    # pins as the shared prefix it registers
    row0 = kv_cache.write_prompt(st, 0, k, -k, 4)
    kv_cache.admit_slot(st, 0, torch.tensor(3), 4, False, 1.0, 0, 9, 7,
                        pinned=2)
    assert row0[:3].tolist() == [15, 14, -1]
    # slot 1: a hit on those 2 pages; its suffix pops 13 and 12
    pool_before = st["kp"].clone()
    row1 = kv_cache.write_prompt(st, 1, k, -k, 7, row0, 2)
    assert row1.tolist() == [15, 14, 13, 12, -1, -1, -1, -1]
    assert int(st["free_count"]) == 12
    assert torch.equal(st["kp"][0, 13], k[0, :2])
    assert torch.equal(st["vp"][0, 12], -k[0, 2:])
    assert torch.equal(st["kp"][0, 14:], pool_before[0, 14:])  # mapped only
    kv_cache.admit_slot(st, 1, torch.tensor(3), 7, False, 1.0, 0, 9, 7,
                        pinned=2)
    kv_cache.release_slots(st, torch.tensor([True, True]))
    # private pages back on the stack, the shared ones left to the host
    assert int(st["free_count"]) == 14
    assert sorted(st["free_stack"][12:14].tolist()) == [12, 13]
    assert (st["ptab"] == -1).all() and not st["active"].any()
    kv_cache.reclaim_pages(st, torch.tensor([15, 14, -1],
                                            dtype=torch.int32))
    assert int(st["free_count"]) == 16
    assert sorted(st["free_stack"].tolist()) == list(range(16))


# -- the engine with the prefix cache ----------------------------------------
TRAFFIC = [("miss", PROMPT_C, 8, {}), ("hit", PROMPT_C, 8, {}),
           ("partial", PARTIAL, 8, {}), ("short", PROMPT_B, 6, {}),
           ("sampled_miss", list(range(20, 32)), 8, dict(seed=7,
                                                         **SAMPLE_KW)),
           ("sampled_hit", list(range(20, 32)), 8, dict(seed=7,
                                                        **SAMPLE_KW))]


def _drive(eng, traffic):
    """Each request alone, in order: its tokens and the counters after."""
    out = {}
    for name, prompt, n, kw in traffic:
        toks = eng.generate(prompt, n, timeout=60, **kw)
        snap = eng.metrics.snapshot()
        out[name] = (toks, snap["prefix_cache_hits"],
                     snap["prefix_cache_misses"])
    return out


@pytest.fixture(scope="module")
def jax_prefix(jax_model):
    eng = JGenerationEngine(jax_model, prefix_cache=True,
                            **PREFIX_ENGINE).start()
    try:
        return _drive(eng, TRAFFIC)
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def port_prefix(model):
    eng = GenerationEngine(model, device="cpu", prefix_cache=True,
                           **PREFIX_ENGINE).start()
    try:
        yield eng, _drive(eng, TRAFFIC)
    finally:
        eng.stop()


def test_engine_defaults_to_the_prefix_cache(model):
    eng = GenerationEngine(model, device="cpu", **PREFIX_ENGINE)
    assert eng._prefix is not None and eng.prefill_chunk == 0


def test_hit_tokens_equal_miss_tokens_and_jax(port_prefix, jax_prefix):
    _, got = port_prefix
    assert got["hit"][0] == got["miss"][0] == jax_prefix["miss"][0] \
        == jax_prefix["hit"][0]


@pytest.mark.parametrize("name", ["partial", "short"])
def test_partial_and_short_prompts_match_jax(port_prefix, jax_prefix, name):
    _, got = port_prefix
    assert got[name][0] == jax_prefix[name][0]


def test_sampled_hit_equals_its_miss(port_prefix):
    _, got = port_prefix
    assert got["sampled_hit"][0] == got["sampled_miss"][0]
    assert len(got["sampled_hit"][0]) == 8


def test_hit_and_miss_counters_match_jax(port_prefix, jax_prefix):
    eng, got = port_prefix
    # miss, hit, partial hit, short miss, miss, hit
    assert [got[n][1:] for n, *_ in TRAFFIC] == \
        [jax_prefix[n][1:] for n, *_ in TRAFFIC] == \
        [(0, 1), (1, 1), (2, 1), (2, 2), (2, 3), (3, 3)]
    snap = eng.metrics.snapshot()
    assert snap["prefix_cache_hit_ratio"] == pytest.approx(
        snap["prefix_cache_hits"] / (snap["prefix_cache_hits"]
                                     + snap["prefix_cache_misses"]))
    text = eng.metrics.prometheus_text()
    for name in ("paddle_genserve_prefix_cache_hits_total",
                 "paddle_genserve_prefix_cache_misses_total",
                 "paddle_genserve_prefix_cache_hit_ratio",
                 "paddle_genserve_prefill_chunks_total"):
        assert name in text


def test_pages_are_accounted_after_traffic(port_prefix):
    eng, _ = port_prefix
    assert eng.resident_pages > 0
    assert _pages_accounted(eng)


def test_concurrent_hits_match_jax(model, jax_prefix):
    """Three slots at once, two of them hits on the same shared pages,
    beside a partial hit admitted mid-decode."""
    eng = GenerationEngine(model, device="cpu", prefix_cache=True,
                           **PREFIX_ENGINE).start()
    try:
        assert eng.generate(PROMPT_C, 8, timeout=60) == \
            jax_prefix["miss"][0]
        hs = [eng.submit(PROMPT_C, 8), eng.submit(PROMPT_C, 8)]
        assert hs[0].next_token(timeout=60) is not None
        part = eng.submit(PARTIAL, 8)
        assert [h.result(60) for h in hs] == [jax_prefix["hit"][0]] * 2
        assert part.result(60) == jax_prefix["partial"][0]
        assert eng.metrics.snapshot()["prefix_cache_hits"] == 3
        assert _pages_accounted(eng)
    finally:
        eng.stop()


def test_pool_pressure_evicts_through_reclaim_pages(model, jax_prefix):
    """Distinct prompts through a 9-page pool: idle prefixes are evicted
    when the backlog head needs their pages, and the evicted pages go back
    to the device free list."""
    eng = GenerationEngine(model, device="cpu", max_slots=2, max_seq_len=24,
                           prompt_buckets="8", page_size=4, num_pages=9,
                           prefix_cache=True).start()
    reclaimed, reclaim = [], eng._reclaim

    def recording_reclaim(pages):       # runs on the decode thread
        reclaimed.extend(pages)
        reclaim(pages)

    eng._reclaim = recording_reclaim
    try:
        rs = np.random.RandomState(3)
        prompts = [rs.randint(1, 200, 8).tolist() for _ in range(10)]
        handles = [eng.submit(p, 8) for p in prompts]
        outs = [h.result(120) for h in handles]
        assert all(len(o) == 8 for o in outs)
        assert reclaimed, "no idle prefix was evicted"
        assert _pages_accounted(eng)
        # the tokens: each prompt alone on the prefix-free engine
        ref = GenerationEngine(model, device="cpu", max_slots=2,
                               max_seq_len=24, prompt_buckets="8",
                               page_size=4, prefix_cache=False).start()
        try:
            assert outs == [ref.generate(p, 8, timeout=60) for p in prompts]
        finally:
            ref.stop()
    finally:
        eng.stop()


# -- chunked prefill ---------------------------------------------------------
CHUNK_TRAFFIC = [LONG[0], LONG[1], LONG[2], LONG_HIT]


@pytest.fixture(scope="module")
def jax_chunked(jax_model):
    eng = JGenerationEngine(jax_model, prefill_chunk=8,
                            **CHUNK_ENGINE).start()
    try:
        out = [eng.generate(p, 8, timeout=60) for p in CHUNK_TRAFFIC]
        assert eng.metrics.snapshot()["prefix_cache_hits"] == 1
        return out
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def unchunked(model):
    eng = GenerationEngine(model, device="cpu", prefix_cache=False,
                           **CHUNK_ENGINE).start()
    try:
        yield {kind: [eng.generate(p, 8, timeout=60, **kw)
                      for p in CHUNK_TRAFFIC]
               for kind, kw in (("greedy", {}),
                                ("sampled", dict(seed=4, **SAMPLE_KW)))}
    finally:
        eng.stop()


def _chunk_engine(model):
    return GenerationEngine(model, device="cpu", prefill_chunk=8,
                            **CHUNK_ENGINE).start()


def test_chunked_greedy_tokens_match_jax_and_unchunked(model, jax_chunked,
                                                       unchunked):
    eng = _chunk_engine(model)
    try:
        got = [eng.generate(p, 8, timeout=60) for p in CHUNK_TRAFFIC]
        assert got == jax_chunked == unchunked["greedy"]
        snap = eng.metrics.snapshot()
        # 5 + 3 + 5 chunks, then the hit's 20-token suffix in 3
        assert snap["prefill_chunks"] == 16
        assert snap["prefix_cache_hits"] == 1
        assert _pages_accounted(eng)
    finally:
        eng.stop()


def test_chunked_sampled_tokens_match_unchunked(model, unchunked):
    eng = _chunk_engine(model)
    try:
        got = [eng.generate(p, 8, timeout=60, seed=4, **SAMPLE_KW)
               for p in CHUNK_TRAFFIC]
        assert got == unchunked["sampled"]
        assert eng.metrics.snapshot()["prefill_chunks"] == 16
    finally:
        eng.stop()


def test_chunked_prefill_does_not_starve_decode(model):
    """A short stream admitted before a long prompt keeps decoding one
    token a loop iteration while the long prompt's chunks interleave: it
    finishes (4 tokens) before the long prompt emits its first (6
    chunks)."""
    eng_chunk = _chunk_engine(model)
    short = eng_chunk.submit(list(range(2, 10)), 4)
    assert short.next_token(timeout=60) is not None      # admitted
    long_h = eng_chunk.submit([int(t) for t in np.random.RandomState(5)
                               .randint(1, 211, 48)], 4)
    t_first_long = [None]

    def watch_long():
        if long_h.next_token(timeout=60) is not None:
            t_first_long[0] = time.monotonic()
        long_h.result(60)

    w = threading.Thread(target=watch_long)
    w.start()
    short.result(60)
    t_short_done = time.monotonic()
    w.join(60)
    eng_chunk.stop()
    assert not w.is_alive() and t_first_long[0] is not None
    assert t_short_done < t_first_long[0], \
        "short stream stalled behind a long prefill"


def test_cancel_mid_chunk_leaks_no_page(model):
    """Cancel a prompt after its third of six chunks, three times; every
    privately written page returns to the free list, and the slots serve
    a whole request afterwards."""
    eng = GenerationEngine(model, device="cpu", max_slots=2, max_seq_len=64,
                           prompt_buckets="48", page_size=4,
                           prefill_chunk=8, prefix_cache=False).start()
    advance, state = eng._advance_chunk, {"n": 0, "h": None}

    def counted_advance():              # runs on the decode thread
        advance()
        if any(r.prefilling for r in eng._sched.occupied.values()):
            state["n"] += 1
            if state["n"] == 3:
                state["h"].cancel()

    eng._advance_chunk = counted_advance
    try:
        free0 = eng.free_count
        for _ in range(3):
            state["n"] = 0
            state["h"] = h = eng.submit(list(range(1, 47)), 4)
            assert h.result(60) == []
            assert len(eng.generate(list(range(3, 49)), 3,
                                    timeout=60)) == 3
        _wait_idle(eng)
        assert eng.free_count == free0 == eng.geometry.num_pages
        assert eng.metrics.counters["cancelled"] == 3
        assert eng.metrics.snapshot()["prefill_chunks"] > 0
    finally:
        eng.stop()


@pytest.mark.parametrize("chunk", [6, 64])
def test_prefill_chunk_is_checked(model, chunk):
    with pytest.raises(ValueError):
        GenerationEngine(model, device="cpu", prefill_chunk=chunk,
                         **CHUNK_ENGINE)


class _CpuReplay:
    """Stands in for the captured decode graph on the CPU: a replay runs
    the body the graph holds (the sampling form over the static noise
    buffer, written into the static output)."""

    def __init__(self, eng):
        self.eng = eng

    def replay(self):
        self.eng._graph_step()


def _mixed_wave(eng):
    """Hits, chunks, both sampling modes, a mid-decode admission and a
    cancel, in an order that makes every request's path (hit or miss,
    chunked or not) the same on every run."""
    shared = LONG[0][:16]
    a = eng.submit(shared + [7, 8, 9, 10, 11], 10)          # chunked miss
    assert a.next_token(timeout=60) is not None              # registered
    hs = {"b": eng.submit(shared + [3, 4, 5], 10),           # hit
          "c": eng.submit(shared + [6, 6], 10, seed=1, **SAMPLE_KW),
          "d": eng.submit(LONG[2], 8, seed=2, **SAMPLE_KW)}  # chunked
    doomed = eng.submit(PROMPT_C, 30)
    assert hs["b"].next_token(timeout=60) is not None
    hs["e"] = eng.submit(PROMPT_B, 12, seed=3, **SAMPLE_KW)  # mid-decode
    assert doomed.next_token(timeout=60) is not None
    doomed.cancel()
    out = {k: h.result(60) for k, h in hs.items()}
    out["a"] = a.result(60)
    assert _pages_accounted(eng)
    return out


def test_graph_form_of_the_step_matches_the_eager_step(model):
    """The step the card captures (always the sampling form, noise from
    a static buffer filled only when a lane samples, tokens through a
    static output) gives the eager step's tokens."""
    outs = {}
    for form in ("eager", "graph"):
        eng = _chunk_engine(model)
        if form == "graph":
            eng._graph = _CpuReplay(eng)
        try:
            outs[form] = _mixed_wave(eng)
            assert (eng.replays > 0) == (form == "graph")
            snap = eng.metrics.snapshot()
            assert snap["prefix_cache_hits"] >= 2
            assert snap["prefill_chunks"] > 0
        finally:
            eng.stop()
    assert outs["graph"] == outs["eager"]
