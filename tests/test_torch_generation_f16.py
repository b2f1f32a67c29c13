"""A float16 GPT served by the port's GenerationEngine on the CPU, against
the JAX package's float16 GPT (the config of
tests/test_generation_serving.py, the reference's weights cast with
``astype("float16")`` and loaded through ``load_numpy_state``).

The port's KV pool takes the model's dtype (float16 here); the
reference's engine keeps a float32 pool for every model.  A float16
value is exact in float32, so the function is the same and only the
order and width of the sums differ (ROADMAP.md §C).  Tolerances: logits
within F16_TOL x max(1, max|ref|), F16_TOL = 2**-8 (four float16 ulps at
the top binade, as the AMP tests); greedy tokens equal the reference's
at every step whose top-2 logit margin (the reference's) exceeds that
tolerance, up to the first step whose margin does not.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.serving import GenerationEngine

CFG = dict(vocab_size=211, hidden_size=48, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0, attn_dropout=0.0)
ENGINE = dict(max_slots=3, max_seq_len=40, prompt_buckets="8,16")
PROMPTS = (list(range(3, 10)), [5, 9, 2], list(range(50, 62)))
NEW = 12
F16_TOL = 2 ** -8


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    m = JGPTForCausalLM(JGPTConfig(**CFG))
    m.astype("float16")
    m.eval()
    return m


@pytest.fixture(scope="module")
def state(jax_model):
    return {k: np.asarray(v.numpy()) for k, v in
            jax_model.state_dict().items()}


def _port(state, how):
    if how == "astype":
        m = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
        m.astype("float16")
    else:                       # AMP-O2 float16: parameters cast in place
        m = amp.decorate(GPTForCausalLM(GPTConfig(**CFG), device="cpu"),
                         level="O2", dtype="float16")
    load_numpy_state(m, state)
    assert {p.dtype for p in m.parameters()} == {torch.float16}
    return m.eval()


PAD = 32         # every reference forward at one shape (one compile)


def _ref_logits(jax_model, ids):
    """The reference's logits at each position of ``ids``: one forward
    over ``ids`` padded with zeros to PAD tokens (causal, so the padding
    after a position does not reach it)."""
    padded = np.zeros((1, PAD), np.int32)
    padded[0, :len(ids)] = ids
    return np.asarray(jax_model(paddle.to_tensor(padded)).numpy(),
                      np.float32)[0, :len(ids)]


def _close(got, ref, what):
    err = float(np.abs(got.astype(np.float32) - ref).max())
    tol = F16_TOL * max(1.0, float(np.abs(ref).max()))
    assert err <= tol, f"{what}: {err:.4e} > {tol:.4e}"


@pytest.fixture(scope="module")
def reference_streams(jax_model):
    """Each prompt's greedy continuation by the reference's float16 model,
    recomputed over the whole sequence each step, with each step's top-2
    logit margin and its last-position logits."""
    out = {}
    for p in PROMPTS:
        ids, toks, margins, logits = list(p), [], [], []
        for _ in range(NEW):
            lg = _ref_logits(jax_model, ids)[-1]
            top2 = np.sort(lg)[-2:]
            toks.append(int(np.argmax(lg)))
            margins.append(float(top2[1] - top2[0]))
            logits.append(lg)
            ids.append(toks[-1])
        out[tuple(p)] = (toks, margins, logits)
    return out


@pytest.mark.parametrize("how", ["astype", "decorate"])
def test_float16_logits_match_reference(jax_model, state, how):
    m = _port(state, how)
    for p in PROMPTS:
        with torch.no_grad():
            got = m(torch.tensor([p])).numpy()[0]
        assert got.dtype == np.float16
        _close(got, _ref_logits(jax_model, p), f"logits of {p}")


@pytest.mark.parametrize("how", ["astype", "decorate"])
def test_float16_engine_serves_the_reference_tokens(state, how,
                                                    reference_streams):
    """The engine's greedy tokens (float16 pool, paged decode's plain
    version in float32 writing float16) against the reference's stream,
    step by step while its margin exceeds the tolerance; each request's
    first token's logits within the tolerance of the reference's."""
    m = _port(state, how)
    eng = GenerationEngine(m, device="cpu", **ENGINE).start()
    try:
        assert eng._state["kp"].dtype == torch.float16
        got = [eng.generate(p, NEW, timeout=120) for p in PROMPTS]
    finally:
        eng.stop()
    held = 0
    for p, toks in zip(PROMPTS, got):
        want, margins, logits = reference_streams[tuple(p)]
        assert len(toks) == NEW
        for step, (t, w, mg) in enumerate(zip(toks, want, margins)):
            if mg <= F16_TOL * max(1.0, float(np.abs(logits[step]).max())):
                break
            assert t == w, f"prompt {p} step {step}: {t} vs {w} " \
                           f"(margin {mg:.4f})"
            held += 1
    assert held >= NEW      # most steps are held, not skipped


def test_decorated_and_cast_models_serve_the_same_tokens(state):
    outs = []
    for how in ("astype", "decorate"):
        eng = GenerationEngine(_port(state, how), device="cpu",
                               **ENGINE).start()
        try:
            outs.append([eng.generate(p, NEW, timeout=120)
                         for p in PROMPTS])
        finally:
            eng.stop()
    assert outs[0] == outs[1]
