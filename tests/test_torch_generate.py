"""The port's solo decoding (``GPTForCausalLM.generate`` and the dense-cache
decode layers) against the JAX package's, on the CPU.

The config is tests/test_generate.py's (vocab 211, hidden 48, 2 layers, 4
heads, 64 positions, dropout 0); the JAX model's weights are carried over
with ``load_numpy_state``.  Greedy and beam-4 tokens are held token for
token against the reference's ``generate`` (with and without an eos) and
greedy also against the port's full-forward loop; ``prefill``'s caches,
``decode_step``'s hidden state and caches, ``decode_slots`` with an
inactive lane and ``slot_decode``'s logits at atol = rtol = 1e-5 (float32
both sides: summation order only).  Sampled tokens are not JAX's stream
(ROADMAP §C): held by determinism per seed and the top-k support.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_numpy_state)

CFG = dict(vocab_size=211, hidden_size=48, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0, attn_dropout=0.0)
TOL = dict(atol=1e-5, rtol=1e-5)
V = CFG["vocab_size"]


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    m = JGPTForCausalLM(JGPTConfig(**CFG))
    m.eval()
    return m


@pytest.fixture(scope="module")
def model(jax_model):
    m = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_numpy_state(m, {k: np.asarray(v.numpy()) for k, v in
                         jax_model.state_dict().items()})
    return m.eval()


def _prompt(seed, B, S):
    return np.random.RandomState(seed).randint(0, V, (B, S)).astype(np.int32)


def _ref(jax_model, prompt, **kw):
    return np.asarray(jax_model.generate(paddle.to_tensor(prompt),
                                         **kw).numpy())


def _gen(model, prompt, **kw):
    out = model.generate(torch.from_numpy(prompt), **kw)
    assert out.dtype == torch.int32 and out.device == model.device
    return out.numpy()


def _full_forward_greedy(model, prompt, n):
    ids = torch.from_numpy(prompt).long()
    with torch.no_grad():
        for _ in range(n):
            nxt = model(ids)[:, -1].argmax(-1)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
    return ids.numpy()


@pytest.mark.parametrize("S", [3, 5, 7])
def test_greedy_matches_reference_and_full_forward(jax_model, model, S):
    prompt = _prompt(S, 2, S)
    got = _gen(model, prompt, max_new_tokens=6)
    assert got.shape == (2, S + 6) and (got[:, :S] == prompt).all()
    np.testing.assert_array_equal(got, _ref(jax_model, prompt,
                                            max_new_tokens=6))
    np.testing.assert_array_equal(got, _full_forward_greedy(model, prompt,
                                                            6))


def test_single_token_edge(jax_model, model):
    prompt = _prompt(11, 1, 3)
    got = _gen(model, prompt, max_new_tokens=1)
    assert got.shape == (1, 4)
    np.testing.assert_array_equal(got, _ref(jax_model, prompt,
                                            max_new_tokens=1))
    np.testing.assert_array_equal(got, _full_forward_greedy(model, prompt,
                                                            1))


def test_eos_pads_its_row_and_leaves_the_other(jax_model, model):
    """eos = row 0's first new token: row 0 emits only eos after it, row 1
    (which never meets it) is the run without an eos."""
    prompt = _prompt(12, 2, 6)
    base = _gen(model, prompt, max_new_tokens=5)
    eos = int(base[0, 6])
    assert eos not in base[1, 6:]
    got = _gen(model, prompt, max_new_tokens=5, eos_token_id=eos)
    assert (got[0, 6:] == eos).all()
    np.testing.assert_array_equal(got[1], base[1])
    np.testing.assert_array_equal(got, _ref(jax_model, prompt,
                                            max_new_tokens=5,
                                            eos_token_id=eos))


@pytest.mark.parametrize("with_eos", [False, True])
def test_beam_matches_reference(jax_model, model, with_eos):
    prompt = _prompt(13, 2, 5)
    kw = dict(max_new_tokens=6, num_beams=4)
    if with_eos:
        # a token the eos-free beams emit mid-way, so beams finish early
        kw["eos_token_id"] = int(_gen(model, prompt, **kw)[0, 7])
    got = _gen(model, prompt, **kw)
    assert got.shape == (2, 11) and (got[:, :5] == prompt).all()
    np.testing.assert_array_equal(got, _ref(jax_model, prompt, **kw))


def test_beam_width_one_is_greedy(model):
    from paddle_tpu_torch.models.gpt import _DecodeRun

    prompt = _prompt(14, 2, 5)
    # the beam body at width 1 (generate routes num_beams=1 to greedy)
    run = _DecodeRun(model, 2, 5, 5, False, 1.0, 0, 1, V, beam=True)
    beam1 = run(torch.from_numpy(prompt), 0).numpy()
    np.testing.assert_array_equal(beam1, _gen(model, prompt,
                                              max_new_tokens=5))


def test_value_errors(model):
    prompt = torch.from_numpy(_prompt(15, 1, 3))
    with pytest.raises(ValueError, match="max_new_tokens"):
        model.generate(prompt, max_new_tokens=0)
    with pytest.raises(ValueError, match="exclusive"):
        model.generate(prompt, num_beams=2, do_sample=True)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model.generate(torch.from_numpy(_prompt(15, 1, 60)),
                       max_new_tokens=10)


def test_training_mode_prefill_raises(model):
    model.train()
    try:
        with pytest.raises(RuntimeError, match="eval-only"):
            model.gpt.prefill(torch.from_numpy(_prompt(16, 1, 4)),
                              cache_len=8)
    finally:
        model.eval()


def test_train_mode_is_restored(model):
    model.train()
    try:
        out = _gen(model, _prompt(17, 1, 4), max_new_tokens=3)
        assert model.training and out.shape == (1, 7)
    finally:
        model.eval()
    _gen(model, _prompt(17, 1, 4), max_new_tokens=3)
    assert not model.training


def test_one_cache_entry_per_key(jax_model):
    m = GPTForCausalLM(GPTConfig(**CFG), device="cpu").eval()
    load_numpy_state(m, {k: np.asarray(v.numpy()) for k, v in
                         jax_model.state_dict().items()})
    a, b = _prompt(18, 2, 4), _prompt(19, 2, 4)
    _gen(m, a, max_new_tokens=3)
    run = m._gen_cache[(2, 4, 3, False, 1, None, None)]
    _gen(m, b, max_new_tokens=3)
    assert len(m._gen_cache) == 1 and next(iter(
        m._gen_cache.values())) is run
    _gen(m, a, max_new_tokens=4)
    _gen(m, a, max_new_tokens=3, num_beams=2)
    _gen(m, a, max_new_tokens=3, do_sample=True, top_k=4, seed=1)
    _gen(m, a, max_new_tokens=3, do_sample=True, top_k=4, seed=2)
    _gen(m, a, max_new_tokens=3, do_sample=True, top_k=5, seed=1)
    assert len(m._gen_cache) == 5
    # parameters replaced by a cast: the key's state is rebuilt
    m.to(dtype=torch.float64)
    _gen(m, a, max_new_tokens=3)
    assert len(m._gen_cache) == 5
    assert m._gen_cache[(2, 4, 3, False, 1, None, None)].caches[0][0].dtype \
        == torch.float64


def test_sampling_is_deterministic_per_seed_and_in_top_k(model):
    prompt = _prompt(20, 2, 5)
    kw = dict(max_new_tokens=5, do_sample=True, top_k=5, temperature=0.8)
    a = _gen(model, prompt, seed=3, **kw)
    b = _gen(model, prompt, seed=3, **kw)
    c = _gen(model, prompt, seed=4, **kw)
    np.testing.assert_array_equal(a, b)
    assert (a[:, :5] == prompt).all() and a.shape == (2, 10)
    assert not (a == c).all()
    # every sampled token lies in its step's top-5 (full forward logits)
    with torch.no_grad():
        logits = model(torch.from_numpy(a).long())
    for t in range(5, 10):
        top = logits[:, t - 1].topk(5).indices.numpy()
        assert all(a[b, t] in top[b] for b in range(2)), t
    # top_k = 1 is greedy whatever the seed
    np.testing.assert_array_equal(
        _gen(model, prompt, max_new_tokens=4, do_sample=True, top_k=1,
             seed=9),
        _gen(model, prompt, max_new_tokens=4))


def test_prefill_caches_match_reference(jax_model, model):
    prompt = _prompt(21, 2, 7)
    jh, jc = jax_model.gpt.prefill(Tensor(jnp.asarray(prompt)), 12)
    h, caches = model.gpt.prefill(torch.from_numpy(prompt), 12)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh.numpy()), **TOL)
    for (k, v), (jk, jv) in zip(caches, jc):
        assert k.shape == (2, 12, 4, 12)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


def test_decode_step_matches_reference(jax_model, model):
    prompt = _prompt(22, 2, 5)
    _, jc = jax_model.gpt.prefill(Tensor(jnp.asarray(prompt)), 9)
    _, caches = model.gpt.prefill(torch.from_numpy(prompt), 9)
    rs = np.random.RandomState(22)
    for pos in range(5, 9):
        tok = rs.randint(0, V, (2, 1)).astype(np.int32)
        jh, jc = jax_model.gpt.decode_step(Tensor(jnp.asarray(tok)),
                                           jnp.int32(pos), jc)
        h, caches = model.gpt.decode_step(
            torch.from_numpy(tok), torch.tensor(pos, dtype=torch.int32),
            caches)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh.numpy()), **TOL)
        for (k, v), (jk, jv) in zip(caches, jc):
            np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


def _slot_caches(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(2, 3, 10, 4, 12).astype(np.float32),
            rs.randn(2, 3, 10, 4, 12).astype(np.float32))


def test_decode_slots_leaves_an_inactive_lane_untouched(jax_model, model):
    kc, vc = _slot_caches(23)
    pos = np.array([4, 9, 2], np.int32)
    active = np.array([True, True, False])
    tok = np.array([[5], [17], [200]], np.int32)
    jh, jcaches = jax_model.gpt.decode_slots(
        Tensor(jnp.asarray(tok)), jnp.asarray(pos),
        tuple((jnp.asarray(kc[i]), jnp.asarray(vc[i])) for i in range(2)),
        jnp.asarray(active))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    h, caches = model.gpt.decode_slots(
        torch.from_numpy(tok), torch.from_numpy(pos),
        tuple((tk[i], tv[i]) for i in range(2)), torch.from_numpy(active))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh.numpy()), **TOL)
    for i, ((k, v), (jk, jv)) in enumerate(zip(caches, jcaches)):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
        # the inactive lane's rows are bitwise what they were
        assert np.array_equal(k[2].numpy(), kc[i, 2])
        assert np.array_equal(v[2].numpy(), vc[i, 2])


def test_slot_decode_logits_match_reference(jax_model, model):
    kc, vc = _slot_caches(24)
    rs = np.random.RandomState(24)
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    pos = np.array([3, 6, 0], np.int32)
    active = np.array([True, False, True])
    for _ in range(3):
        tok = rs.randint(0, V, 3).astype(np.int32)
        jl, jk, jv = jax_model.slot_decode(jnp.asarray(tok),
                                           jnp.asarray(pos),
                                           jnp.asarray(active), jk, jv)
        lg, tk, tv = model.slot_decode(torch.from_numpy(tok),
                                       torch.from_numpy(pos),
                                       torch.from_numpy(active), tk, tv)
        assert lg.shape == (3, V)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
        pos = pos + active


def test_a_dropped_model_frees_its_runs_at_once():
    """The model holds its runs and a run holds its model weakly: no
    reference cycle, so dropping the model frees its runs (their caches
    and, on the card, their graphs) at once, never later in the cyclic
    collector, which could run in the middle of another capture."""
    import gc
    import weakref

    m = GPTForCausalLM(GPTConfig(**CFG), device="cpu").eval()
    _gen(m, _prompt(25, 2, 4), max_new_tokens=3)
    _gen(m, _prompt(25, 2, 4), max_new_tokens=3, num_beams=2)
    runs = [weakref.ref(r) for r in m._gen_cache.values()]
    collecting = gc.isenabled()
    gc.disable()
    try:
        del m
        assert all(r() is None for r in runs)
    finally:
        if collecting:
            gc.enable()
