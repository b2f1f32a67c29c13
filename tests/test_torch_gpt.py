"""The port's GPT serving path against the JAX package's, on the CPU.

JAX weights are carried over with ``load_numpy_state``; ``slot_prefill``
(k, v, logits) and ``slot_decode_paged`` (logits and the updated page
pools, over 4 steps on a hand-built page table) are held against the JAX
model's at the config of tests/test_generation_serving.py.  Tolerance:
float32 both sides, atol = rtol = 1e-5 (summation order only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_numpy_state)

CFG = dict(vocab_size=211, hidden_size=48, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0, attn_dropout=0.0)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    m = JGPTForCausalLM(JGPTConfig(**CFG))
    m.eval()
    return m


@pytest.fixture(scope="module")
def state(jax_model):
    return {k: np.asarray(v.numpy()) for k, v in
            jax_model.state_dict().items()}


@pytest.fixture(scope="module")
def model(state):
    m = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_numpy_state(m, state)
    return m.eval()


def test_state_dict_names_shapes_and_round_trip(model, state):
    own = model.state_dict()
    assert list(own) == list(state)
    assert all(tuple(own[k].shape) == state[k].shape for k in state)
    fresh = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_numpy_state(fresh, {k: v.numpy() for k, v in own.items()})
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, own[k]), k


def test_load_numpy_state_is_strict(state):
    m = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    missing = dict(state)
    missing.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError):
        load_numpy_state(m, missing)
    with pytest.raises(KeyError):
        load_numpy_state(m, dict(state, extra=np.zeros(3, np.float32)))
    with pytest.raises(ValueError):
        load_numpy_state(m, dict(state, **{
            "gpt.ln_f.bias": np.zeros(47, np.float32)}))


def test_load_numpy_state_casts_dtype(state):
    m = GPTForCausalLM(GPTConfig(**CFG), device="cpu", dtype=torch.bfloat16)
    load_numpy_state(m, {k: v.astype(np.float64) for k, v in state.items()})
    w = m.state_dict()["gpt.wte.weight"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_allclose(w.float().numpy(), state["gpt.wte.weight"],
                               rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("bucket,L", [(8, 5), (16, 11)])
def test_slot_prefill_matches_jax(jax_model, model, bucket, L):
    rs = np.random.RandomState(bucket)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :L] = rs.randint(0, CFG["vocab_size"], L)
    jk, jv, jl = jax_model.slot_prefill(Tensor(jnp.asarray(ids)), L)
    k, v, lg = model.slot_prefill(torch.from_numpy(ids).long(), L)
    assert k.shape == (2, bucket, 4, 12) and lg.shape == (211,)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)


def test_forward_logits_match_jax(jax_model, model):
    ids = np.random.RandomState(3).randint(0, 211, (2, 9)).astype(np.int32)
    ref = jax_model(Tensor(jnp.asarray(ids)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.numpy()), **TOL)


def test_slot_decode_paged_matches_jax(jax_model, model):
    """Four steps on a hand-built table: lane 0 crosses into its third
    page, lane 1 into its fourth, lane 2 is inactive with an all -1 row.
    Logits of the active lanes and the whole pools must match (the JAX
    composite gathers clipped garbage for the inactive lane's logits,
    which the engine never reads)."""
    rs = np.random.RandomState(4)
    ps, num_pages, seq_cap = 4, 12, 16
    shape = (2, num_pages, ps, 4, 12)
    kp = rs.randn(*shape).astype(np.float32)
    vp = rs.randn(*shape).astype(np.float32)
    rows = np.array([[2, 5, 8, -1], [7, 1, 3, 9], [-1, -1, -1, -1]],
                    np.int32)
    pos = np.array([5, 9, 0], np.int32)
    active = np.array([True, True, False])
    jkp, jvp = jnp.asarray(kp), jnp.asarray(vp)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    for step in range(4):
        toks = rs.randint(0, 211, 3).astype(np.int32)
        jl, jkp, jvp = jax_model.slot_decode_paged(
            jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(active), jkp,
            jvp, jnp.asarray(rows), seq_cap)
        tl, tkp2, tvp2 = model.slot_decode_paged(
            torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(active), tkp, tvp, torch.from_numpy(rows),
            seq_cap)
        assert tkp2 is tkp and tvp2 is tvp      # written in place
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   **TOL)
        np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), **TOL)
        np.testing.assert_allclose(tvp.numpy(), np.asarray(jvp), **TOL)
        pos = np.where(active, pos + 1, pos).astype(np.int32)


class _CountOps(TorchDispatchMode):
    """How often each aten op ran under the mode."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("active", [(True, True, False),
                                    (False, False, False)])
def test_slot_decode_paged_makes_no_host_sync(model, active):
    """``aten._local_scalar_dense`` (an .item(), an int() or an index by a
    0-d tensor: on the card a device-to-host copy and a stream sync) runs
    0 times in a decode step, with writing lanes and with none (it ran 4
    times a layer when the KV scatter indexed by the 0-d argmax)."""
    rs = np.random.RandomState(5)
    shape = (2, 12, 4, 4, 12)
    kp = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    vp = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    rows = torch.tensor([[2, 5, 8, -1], [7, 1, 3, 9], [-1, -1, -1, -1]],
                        dtype=torch.int32)
    with _CountOps() as ops:
        logits, _, _ = model.slot_decode_paged(
            torch.tensor([3, 4, 5]), torch.tensor([5, 9, 0],
                                                  dtype=torch.int32),
            torch.tensor(active), kp, vp, rows, 16)
    assert logits.shape == (3, 211)
    assert ops.counts.get("aten._local_scalar_dense", 0) == 0
    assert ops.counts["aten.index_copy_"] == 2 * CFG["num_layers"]


def test_serving_paths_are_eval_only(model):
    model.train()
    try:
        with pytest.raises(RuntimeError):
            model.slot_prefill(torch.zeros(1, 8, dtype=torch.long), 3)
    finally:
        model.eval()


def test_untied_head_matches_jax():
    """``tie_word_embeddings=False`` adds ``lm_head.weight`` [H, V]."""
    paddle.seed(1)
    jm = JGPTForCausalLM(JGPTConfig(tie_word_embeddings=False, **CFG))
    jm.eval()
    m = GPTForCausalLM(GPTConfig(tie_word_embeddings=False, **CFG),
                       device="cpu")
    load_numpy_state(m, {k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    assert "lm_head.weight" in m.state_dict()
    ids = np.random.RandomState(5).randint(0, 211, (1, 6)).astype(np.int32)
    ref = jm(Tensor(jnp.asarray(ids)))
    with torch.no_grad():
        got = m(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.numpy()), **TOL)
