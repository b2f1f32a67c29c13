"""The port's GenerationEngine on the CPU against the JAX package's
(both with ``prefix_cache=False``, CPU, same weights: the miss path; the
prefix cache is held in tests/test_torch_prefix_cache.py).

Greedy tokens must be identical to the JAX engine's, including a request
admitted mid-decode and slot reuse after retirement.  JAX's threefry
sampling chain cannot be reproduced in PyTorch, so sampled requests are
held by determinism (same seed, same tokens, on a fresh engine and beside
batch mates) and by support (every sampled token lies in the top-k set of
its step's logits).  Pages return to the pool on retire, cancel and
deadline; drain finishes in-flight requests.
"""
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.serving import GenerationEngine as JGenerationEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.serving import (DeadlineExceededError,
                                      EngineStoppedError, GenerationEngine)

CFG = dict(vocab_size=211, hidden_size=48, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0, attn_dropout=0.0)
ENGINE = dict(max_slots=3, max_seq_len=40, prompt_buckets="8,16")
PROMPT_A = list(range(3, 10))          # L=7  -> bucket 8
PROMPT_B = [5, 9, 2]                   # L=3  -> bucket 8
PROMPT_C = list(range(50, 62))         # L=12 -> bucket 16
SAMPLE_KW = dict(do_sample=True, temperature=0.8, top_k=5)


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


@pytest.fixture(scope="module")
def jax_refs(jax_model):
    """Greedy token streams of the JAX engine, one request at a time."""
    eng = JGenerationEngine(jax_model, prefix_cache=False, **ENGINE).start()
    try:
        return {(tuple(p), n): eng.generate(p, n, timeout=120)
                for p, n in ((PROMPT_A, 12), (PROMPT_B, 12), (PROMPT_C, 25),
                             (PROMPT_C, 9), (PROMPT_A, 8))}
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def engine(model):
    eng = GenerationEngine(model, device="cpu", prefix_cache=False,
                           **ENGINE).start()
    yield eng
    eng.stop()


def _wait_idle(eng, timeout=30):
    t0 = time.monotonic()
    while eng._sched.occupied or eng._backlog or not eng._queue.empty():
        assert time.monotonic() - t0 < timeout
        time.sleep(0.005)


def test_greedy_tokens_match_jax_engine(engine, jax_refs):
    for p, n in ((PROMPT_A, 12), (PROMPT_B, 12), (PROMPT_C, 9)):
        assert engine.generate(p, n, timeout=60) == jax_refs[(tuple(p), n)]


def test_mid_decode_admission_matches_jax_engine(engine, jax_refs):
    long_h = engine.submit(PROMPT_C, 25)
    first = long_h.next_token(timeout=60)   # decode provably underway
    mid = engine.submit(PROMPT_B, 12)
    assert mid.result(60) == jax_refs[(tuple(PROMPT_B), 12)]
    assert [first] + list(long_h) == jax_refs[(tuple(PROMPT_C), 25)]


def test_slot_reuse_after_retirement_matches_jax_engine(engine, jax_refs):
    """More requests than slots: every retirement hands its slot (and its
    pages) to a new occupant without leaking the previous one's KV."""
    jobs = [((PROMPT_A, 12), engine.submit(PROMPT_A, 12)),
            ((PROMPT_C, 9), engine.submit(PROMPT_C, 9)),
            ((PROMPT_B, 12), engine.submit(PROMPT_B, 12))] * 3
    for (p, n), h in jobs:
        assert h.result(60) == jax_refs[(tuple(p), n)]
    _wait_idle(engine)
    assert engine.free_count == engine.geometry.num_pages


def test_sampling_is_deterministic_per_seed(model, engine):
    ref = engine.generate(PROMPT_B, 12, timeout=60, seed=7, **SAMPLE_KW)
    # beside batch mates, in different slots
    hs = [engine.submit(PROMPT_B, 12, seed=7, **SAMPLE_KW)
          for _ in range(3)]
    assert all(h.result(60) == ref for h in hs)
    # on a fresh engine
    fresh = GenerationEngine(model, device="cpu", prefix_cache=False,
                             **ENGINE).start()
    try:
        assert fresh.generate(PROMPT_B, 12, timeout=60, seed=7,
                              **SAMPLE_KW) == ref
    finally:
        fresh.stop()
    other = engine.generate(PROMPT_B, 12, timeout=60, seed=8, **SAMPLE_KW)
    assert other != ref


@pytest.mark.parametrize("top_k", [1, 5])
def test_sampled_tokens_lie_in_top_k(model, engine, top_k):
    """Teacher-force the sampled stream through the model: token i must
    be among the top-k of the temperature-scaled logits at its step
    (values tied with the k-th included)."""
    prompt = PROMPT_A
    toks = engine.generate(prompt, 16, timeout=60, seed=3, do_sample=True,
                           temperature=0.8, top_k=top_k)
    seq = torch.tensor([prompt + toks], dtype=torch.long)
    with torch.no_grad():
        logits = model(seq)[0] / 0.8
    for i, tok in enumerate(toks):
        row = logits[len(prompt) - 1 + i]
        kth = row.topk(top_k).values[-1]
        assert row[tok] >= kth, (i, tok)


def test_cancel_frees_slot_and_pages(engine):
    h = engine.submit(PROMPT_C, 25)
    assert h.next_token(timeout=60) is not None
    h.cancel()
    t0 = time.monotonic()
    while not h.done and time.monotonic() - t0 < 30:
        time.sleep(0.005)
    assert h.done and h.error is None
    assert 0 < len(h.tokens) < 25
    _wait_idle(engine)
    assert engine.free_count == engine.geometry.num_pages
    assert engine.metrics.counters["cancelled"] >= 1


def test_deadline_mid_decode_frees_slot(model):
    eng = GenerationEngine(model, device="cpu", max_slots=2, max_seq_len=40,
                           prompt_buckets="8", prefix_cache=False).start()
    step = eng.step

    def slow_step():                   # make the expiry land mid-decode
        time.sleep(0.02)
        return step()

    eng.step = slow_step
    try:
        h = eng.submit(PROMPT_A, 30, deadline_ms=150)
        with pytest.raises(DeadlineExceededError):
            h.result(30)
        assert 0 < len(h.tokens) < 30
        _wait_idle(eng)
        assert eng.free_count == eng.geometry.num_pages
        assert eng.metrics.counters["deadline_expired"] == 1
    finally:
        eng.stop()


def test_drain_finishes_in_flight_requests(model, jax_refs):
    eng = GenerationEngine(model, device="cpu", prefix_cache=False,
                           **ENGINE).start()
    hs = [eng.submit(PROMPT_A, 12), eng.submit(PROMPT_C, 9),
          eng.submit(PROMPT_A, 8)]
    assert eng.drain(timeout=60)
    assert hs[0].result(0) == jax_refs[(tuple(PROMPT_A), 12)]
    assert hs[1].result(0) == jax_refs[(tuple(PROMPT_C), 9)]
    assert hs[2].result(0) == jax_refs[(tuple(PROMPT_A), 8)]
    assert eng.free_count == eng.geometry.num_pages
    with pytest.raises(EngineStoppedError):
        eng.submit(PROMPT_A, 4)
    eng.stop()


@pytest.mark.parametrize("prompt,n,kw", [
    ([], 4, {}),                                   # empty prompt
    (PROMPT_A, 0, {}),                             # no new tokens
    (list(range(17)), 4, {}),                      # past the largest bucket
    (PROMPT_C, 30, {}),                            # past max_seq_len
    (PROMPT_A, 4, dict(top_k=65)),                 # past max_top_k
    ([3, 500], 4, {}),                             # token id past vocab
])
def test_submit_rejects_what_the_cache_cannot_hold(engine, prompt, n, kw):
    with pytest.raises(ValueError):
        engine.submit(prompt, n, **kw)


def test_metrics_count_and_expose_the_traffic(engine):
    before = engine.metrics.snapshot()
    engine.generate(PROMPT_A, 5, timeout=60)
    snap = engine.metrics.snapshot()
    assert snap["tokens"] == before["tokens"] + 5
    assert snap["retired"] == before["retired"] + 1
    assert snap["ttft_p50_ms"] > 0 and snap["inter_token_p50_ms"] > 0
    text = engine.metrics.prometheus_text()
    for name in ("paddle_genserve_decode_tokens_per_sec",
                 "paddle_genserve_ttft_p50_ms",
                 "paddle_genserve_inter_token_p99_ms",
                 "paddle_genserve_slot_occupancy",
                 'paddle_genserve_requests_total{result="retired"}',
                 "paddle_genserve_tokens_total"):
        assert name in text


class _HostSyncs(TorchDispatchMode):
    """The ops of a step that reach the host: ``aten._local_scalar_dense``
    (an .item(), int() or 0-d tensor index) and copies to the CPU device
    (``aten._to_copy(device=cpu)``; a CPU tensor's ``.cpu()`` is the
    tensor itself, which the dispatcher never sees)."""

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


def test_decode_step_fetches_to_the_host_once(model):
    """Every ``step()`` of a wave with a sampling lane beside greedy ones
    makes exactly one host round trip: the copy of the tokens and the
    finished mask.  No ``_local_scalar_dense`` at all (the KV scatter ran
    4 a layer), and the sampled lanes' noise needs no lane index copied
    from the host."""
    eng = GenerationEngine(model, device="cpu", prefix_cache=False,
                           **ENGINE).start()
    step, seen = eng.step, []

    def counted_step():                # runs on the decode thread
        sampling = any(r.do_sample for r in eng._sched.occupied.values())
        with _HostSyncs() as syncs:
            out = step()
        seen.append((sampling, syncs.scalars, syncs.fetches))
        return out

    eng.step = counted_step
    try:
        hs = [eng.submit(PROMPT_A, 8), eng.submit(PROMPT_B, 8, seed=2,
                                                  **SAMPLE_KW),
              eng.submit(PROMPT_C, 5)]
        for h in hs:
            h.result(60)
    finally:
        eng.stop()
    assert any(sampling for sampling, _, _ in seen)
    assert [(s, f) for _, s, f in seen] == [(0, 1)] * len(seen)
