"""The port's HuggingFace interop (``paddle_tpu_torch.models.interop``)
against transformers models with random weights built offline, and against
the JAX package's loader (tests/test_hf_interop.py, mirrored).

BERT loaded by ``load_hf_bert`` reproduces HF's outputs (atol 2e-5, rtol
1e-4), from a module and from a state dict; a GPT-2 loaded by
``load_hf_gpt2`` generates HF's greedy tokens exactly; the export round
trip loads into HF with no unexpected key and reproduces the port's
forward; an untied GPT without ``lm_head.weight`` raises ``KeyError`` and a
wrong shape ``ValueError``; the port's and the reference's
``load_hf_gpt2`` give the same parameters by name.
"""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from paddle_tpu_torch.models import (BertConfig, BertModel,  # noqa: E402
                                     GPTConfig, GPTForCausalLM)
from paddle_tpu_torch.models.interop import (load_hf_bert,  # noqa: E402
                                             load_hf_gpt2, to_hf_bert_state,
                                             to_hf_gpt2_state)

TOL = dict(atol=2e-5, rtol=1e-4)


def _hf_bert(vocab=90, hidden=32, layers=2, heads=4, ffn=64, positions=20):
    torch.manual_seed(43)
    hf = transformers.BertModel(transformers.BertConfig(
        vocab_size=vocab, hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, intermediate_size=ffn,
        max_position_embeddings=positions, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        hidden_act="gelu"))
    return hf.eval()


def _bert(vocab=90, hidden=32, layers=2, heads=4, ffn=64, positions=20):
    return BertModel(BertConfig(
        vocab_size=vocab, hidden_size=hidden, num_layers=layers,
        num_heads=heads, intermediate_size=ffn,
        max_position_embeddings=positions, dropout=0.0),
        device="cpu").eval()


def _hf_gpt2(n_layer=2, lm_head=True):
    torch.manual_seed(44)
    cfg = transformers.GPT2Config(
        vocab_size=80, n_embd=24, n_layer=n_layer, n_head=4, n_positions=18,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
        activation_function="gelu")
    cls = transformers.GPT2LMHeadModel if lm_head else transformers.GPT2Model
    return cls(cfg).eval()


def _gpt(n_layer=2, tie=True):
    return GPTForCausalLM(GPTConfig(
        vocab_size=80, hidden_size=24, num_layers=n_layer, num_heads=4,
        max_position_embeddings=18, dropout=0.0, attn_dropout=0.0,
        tie_word_embeddings=tie), device="cpu").eval()


@pytest.mark.parametrize("form", ["module", "state_dict"])
def test_load_hf_bert_reproduces_hf(form):
    hf = _hf_bert()
    pm = load_hf_bert(_bert(), hf if form == "module" else hf.state_dict())
    ids = np.random.RandomState(43).randint(0, 90, (2, 12))
    with torch.no_grad():
        seq, pooled = pm(torch.from_numpy(ids))
        out = hf(input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(seq.numpy(), out.last_hidden_state.numpy(),
                               **TOL)
    np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(),
                               **TOL)


@pytest.mark.parametrize("form", ["module", "state_dict", "numpy"])
def test_load_hf_gpt2_generates_hfs_greedy_tokens(form):
    hf = _hf_gpt2()
    src = {"module": hf, "state_dict": hf.state_dict(),
           "numpy": {k: v.numpy() for k, v in hf.state_dict().items()}}[form]
    pm = load_hf_gpt2(_gpt(), src)
    prompt = np.random.RandomState(45).randint(0, 80, (2, 5))
    got = pm.generate(torch.from_numpy(prompt), max_new_tokens=6).numpy()
    with torch.no_grad():
        want = hf.generate(torch.from_numpy(prompt), max_new_tokens=6,
                           do_sample=False, pad_token_id=0).numpy()
    np.testing.assert_array_equal(got, want)


def test_bert_export_round_trip_reproduces_the_port():
    from paddle_tpu_torch.framework.random import seed

    seed(51)
    pm = _bert(vocab=70, hidden=16, layers=1, heads=2, ffn=32, positions=12)
    hf = _hf_bert(vocab=70, hidden=16, layers=1, heads=2, ffn=32,
                  positions=12)
    sd = {k: torch.tensor(v) for k, v in to_hf_bert_state(pm).items()}
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    ids = np.random.RandomState(46).randint(0, 70, (2, 8))
    with torch.no_grad():
        seq, _ = pm(torch.from_numpy(ids))
        out = hf(input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(seq.numpy(), out.last_hidden_state.numpy(),
                               **TOL)


def test_gpt2_export_round_trip_reproduces_the_port():
    from paddle_tpu_torch.framework.random import seed

    seed(52)
    pm = _gpt()
    hf = _hf_gpt2(lm_head=False)
    sd = {k: torch.tensor(v) for k, v in to_hf_gpt2_state(pm).items()}
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    ids = np.random.RandomState(47).randint(0, 80, (2, 9))
    with torch.no_grad():
        hidden = pm.gpt(torch.from_numpy(ids))
        out = hf(input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(hidden.numpy(), out.last_hidden_state.numpy(),
                               **TOL)
    # and back: the exported state loads into a fresh port model bitwise
    fresh = load_hf_gpt2(_gpt(), to_hf_gpt2_state(pm))
    for (n, a), (_, b) in zip(pm.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(a, b), n


def test_export_keeps_bf16_as_float32():
    pm = _gpt().to(dtype=torch.bfloat16)
    sd = to_hf_gpt2_state(pm)
    assert all(v.dtype == np.float32 for v in sd.values())
    fresh = load_hf_gpt2(_gpt().to(dtype=torch.bfloat16), sd)
    for (n, a), (_, b) in zip(pm.named_parameters(),
                              fresh.named_parameters()):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), n


def test_untied_model_without_lm_head_raises():
    hf = _hf_gpt2(n_layer=1, lm_head=False)
    pm = _gpt(n_layer=1, tie=False)
    with pytest.raises(KeyError, match="lm_head"):
        load_hf_gpt2(pm, hf)
    load_hf_gpt2(pm, hf, strict=False)       # the explicit opt-in works


def test_untied_model_loads_a_checkpoints_lm_head():
    hf = _hf_gpt2(n_layer=1)
    pm = load_hf_gpt2(_gpt(n_layer=1, tie=False), hf.state_dict())
    np.testing.assert_array_equal(pm.lm_head.weight.detach().numpy(),
                                  hf.lm_head.weight.detach().numpy().T)


def test_shape_mismatch_raises():
    hf = _hf_bert()
    with pytest.raises(ValueError, match="shape mismatch"):
        load_hf_bert(_bert(vocab=91), hf)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_hf_gpt2(_gpt(), {**_hf_gpt2().state_dict(),
                              "transformer.wpe.weight": torch.zeros(19, 24)})


def test_missing_pooler_raises_under_strict():
    sd = {k: v for k, v in _hf_bert().state_dict().items()
          if not k.startswith("pooler.")}
    with pytest.raises(KeyError, match="pooler"):
        load_hf_bert(_bert(), sd)
    load_hf_bert(_bert(), sd, strict=False)


def test_same_parameters_as_the_references_loader():
    import paddle_tpu.models as jm
    from paddle_tpu.models.interop import load_hf_gpt2 as jload_hf_gpt2

    hf = _hf_gpt2()
    ref = jm.GPTForCausalLM(jm.GPTConfig(
        vocab_size=80, hidden_size=24, num_layers=2, num_heads=4,
        max_position_embeddings=18, dropout=0.0, attn_dropout=0.0))
    jload_hf_gpt2(ref, hf.state_dict())
    pm = load_hf_gpt2(_gpt(), hf.state_dict())
    want = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    got = {k: v.numpy() for k, v in pm.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
