"""``GenerationEngine.submit(resume_pos=)`` of the port on the CPU: the
router's mid-stream failover, where a stream cut after ``n`` tokens is
resubmitted as ``prompt + emitted[:n]`` with ``resume_pos=n`` and the same
seed (tests/test_generation_serving.py's config: vocab 211, hidden 48,
2 layers, 4 heads; a 1-layer draft holding the target's embeddings and
first block for the speculative engine; 3 slots, buckets 8, 16 and 32).

* Sampled (temperature 0.8, top-k 5, seed 7): the resumed tokens equal
  the uninterrupted stream's ``[n:]`` bitwise, in the plain and the
  speculative engine, at ``resume_pos`` 0, 1 and 16.  JAX's threefry
  chain cannot be reproduced in PyTorch, so the sampled stream is held
  against the port's own uninterrupted one.
* Greedy: the resumed tokens equal the uninterrupted stream's and the
  JAX engine's resumed tokens, token for token.
* ``resume_pos=0`` is today's admission: the same tokens as a submit
  without it.  A negative value raises ``ValueError`` as in the
  reference.  Over HTTP the ``resume_pos`` field reaches the engine.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.serving import GenerationEngine as JGenerationEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.serving import (GenerationEngine, ServingClient,
                                      ServingServer)

CFG = dict(vocab_size=211, hidden_size=48, num_heads=4,
           max_position_embeddings=64, dropout=0.0, attn_dropout=0.0)
ENGINE = dict(max_slots=3, max_seq_len=48, prompt_buckets="8,16,32")
SAMPLE_KW = dict(do_sample=True, temperature=0.8, top_k=5, seed=7)
PROMPT = list(range(3, 10))
NEW = 24


def _jax_gpt(layers):
    paddle.seed(0)
    m = JGPTForCausalLM(JGPTConfig(num_layers=layers, **CFG))
    m.eval()
    return m


def _port(jax_model, layers):
    m = GPTForCausalLM(GPTConfig(num_layers=layers, **CFG), device="cpu")
    load_numpy_state(m, {k: np.asarray(v.numpy())
                         for k, v in jax_model.state_dict().items()})
    return m.eval()


@pytest.fixture(scope="module")
def models():
    """(JAX target, port target, port 1-layer draft holding the target's
    embeddings, first block and ln_f)."""
    target = _jax_gpt(2)
    port = _port(target, 2)
    sd = port.state_dict()
    draft = GPTForCausalLM(GPTConfig(num_layers=1, **CFG), device="cpu")
    draft.set_state_dict({k: sd[k] for k in draft.state_dict()})
    return target, port, draft.eval()


@pytest.fixture(scope="module")
def engines(models):
    _, port, draft = models
    plain = GenerationEngine(port, device="cpu", **ENGINE).start()
    spec = GenerationEngine(port, device="cpu", draft_model=draft,
                            spec_tokens=3, **ENGINE).start()
    yield {"plain": plain, "spec": spec}
    plain.stop()
    spec.stop()


@pytest.mark.parametrize("form", ["plain", "spec"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("n", [0, 1, 16])
def test_resumed_stream_continues_the_uninterrupted_one(engines, form,
                                                        sampled, n):
    eng = engines[form]
    kw = SAMPLE_KW if sampled else {}
    full = eng.generate(PROMPT, NEW, timeout=60, **kw)
    assert len(full) == NEW
    resumed = eng.generate(PROMPT + full[:n], NEW - n, timeout=60,
                           resume_pos=n, **kw)
    assert resumed == full[n:]


@pytest.mark.parametrize("form", ["plain", "spec"])
def test_resume_pos_zero_is_todays_admission(engines, form):
    eng = engines[form]
    for kw in ({}, SAMPLE_KW):
        assert eng.generate(PROMPT, 12, timeout=60, resume_pos=0, **kw) \
            == eng.generate(PROMPT, 12, timeout=60, **kw)


def test_a_resumed_sampled_stream_skips_exactly_its_draws(engines):
    """Without resume_pos the resumed submission restarts the draws: its
    stream is not the uninterrupted one's continuation (the skip is what
    makes the equality above hold)."""
    eng = engines["plain"]
    full = eng.generate(PROMPT, NEW, timeout=60, **SAMPLE_KW)
    restarted = eng.generate(PROMPT + full[:16], NEW - 16, timeout=60,
                             **SAMPLE_KW)
    assert restarted != full[16:]


@pytest.mark.parametrize("n", [1, 16])
def test_greedy_resume_equals_the_jax_engines(models, engines, n):
    target, _, _ = models
    jeng = JGenerationEngine(target, **ENGINE).start()
    try:
        full = jeng.generate(PROMPT, NEW, timeout=120)
        want = jeng.generate(PROMPT + full[:n], NEW - n, timeout=120,
                             resume_pos=n)
    finally:
        jeng.stop()
    got = engines["plain"].generate(PROMPT + full[:n], NEW - n, timeout=60,
                                    resume_pos=n)
    assert want == full[n:]
    assert got == want


@pytest.mark.parametrize("form", ["plain", "spec"])
def test_negative_resume_pos_raises(models, engines, form):
    target, _, _ = models
    jeng = JGenerationEngine(target, **ENGINE)
    jeng._started = True          # submit validates before it enqueues
    with pytest.raises(ValueError) as want:
        jeng.submit(PROMPT, 4, resume_pos=-1)
    with pytest.raises(ValueError) as got:
        engines[form].submit(PROMPT, 4, resume_pos=-1)
    assert str(got.value) == str(want.value)


def test_resume_pos_passes_through_http(models):
    eng = GenerationEngine(models[1], device="cpu", **ENGINE)
    seen = []
    real = eng.submit

    def spy(prompt, *a, **kw):
        seen.append(kw.get("resume_pos"))
        return real(prompt, *a, **kw)

    eng.submit = spy
    srv = ServingServer(None, gen_engine=eng, port=0,
                        install_signal_handlers=False).start()
    try:
        full = eng.generate(PROMPT, NEW, timeout=60, **SAMPLE_KW)
        client = ServingClient(srv.url)
        seen.clear()
        got = client.generate(PROMPT + full[:16], NEW - 16, resume_pos=16,
                              **SAMPLE_KW)["tokens"]
        streamed = [e["token"] for e in client.generate_stream(
            PROMPT + full[:16], NEW - 16, resume_pos=16, **SAMPLE_KW)
            if "token" in e]
        status, _ = client._request("/generate", {
            "prompt": PROMPT, "resume_pos": -1})
    finally:
        srv.shutdown()
    assert seen == [16, 16, -1]
    assert got == streamed == full[16:]
    assert status == 400
