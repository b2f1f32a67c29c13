"""HuggingFace checkpoint interop (port of paddle_tpu/models/interop.py).

Load a transformers ``BertModel`` / ``GPT2LMHeadModel`` (a live module or
its state dict, or any mapping of torch tensors or numpy arrays) into the
port's models, and export the port's weights under HF's names.  The
mapping is the reference's: the port's ``Linear`` stores [in, out], so
HF's [out, in] ``Linear`` weights transpose on the way in, while GPT-2's
``Conv1D`` already stores [in, out]; GPT-2's fused ``c_attn`` is the
port's ``qkv``.  Weights are copied in place into the model's parameters,
on their device and in their dtype.  Nothing here imports transformers
or reaches a hub: pass a model or a state dict loaded locally.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_hf_bert", "load_hf_gpt2", "to_hf_bert_state",
           "to_hf_gpt2_state"]


def _state(src):
    return src.state_dict() if hasattr(src, "state_dict") else src


def _set(param, value, transpose=False):
    value = torch.as_tensor(value)
    value = value.t() if transpose else value
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"shape mismatch: model {tuple(param.shape)} vs "
                         f"checkpoint {tuple(value.shape)}")
    with torch.no_grad():
        param.copy_(value.to(device=param.device, dtype=param.dtype))


def load_hf_bert(model, hf_source, strict=True):
    """Load a transformers BertModel (or its state dict) into a port
    ``BertModel``.  Returns the model."""
    sd = _state(hf_source)
    pre = "bert." if any(k.startswith("bert.") for k in sd) else ""

    def g(name):
        return sd[pre + name]

    emb = model.embeddings
    _set(emb.word.weight, g("embeddings.word_embeddings.weight"))
    _set(emb.position.weight, g("embeddings.position_embeddings.weight"))
    _set(emb.token_type.weight,
         g("embeddings.token_type_embeddings.weight"))
    _set(emb.layer_norm.weight, g("embeddings.LayerNorm.weight"))
    _set(emb.layer_norm.bias, g("embeddings.LayerNorm.bias"))
    for i, pl in enumerate(model.encoder.layers):
        p = f"encoder.layer.{i}."
        for hf_name, lin in _bert_linears(pl):
            _set(lin.weight, g(p + hf_name + ".weight"), transpose=True)
            _set(lin.bias, g(p + hf_name + ".bias"))
        _set(pl.norm1.weight, g(p + "attention.output.LayerNorm.weight"))
        _set(pl.norm1.bias, g(p + "attention.output.LayerNorm.bias"))
        _set(pl.norm2.weight, g(p + "output.LayerNorm.weight"))
        _set(pl.norm2.bias, g(p + "output.LayerNorm.bias"))
    if pre + "pooler.dense.weight" in sd:
        _set(model.pooler.weight, g("pooler.dense.weight"), transpose=True)
        _set(model.pooler.bias, g("pooler.dense.bias"))
    elif strict:
        raise KeyError("checkpoint has no pooler weights "
                       "(pass strict=False to skip)")
    return model


def _bert_linears(pl):
    """(HF name, the port's Linear) of one encoder layer."""
    return [("attention.self.query", pl.self_attn.q_proj),
            ("attention.self.key", pl.self_attn.k_proj),
            ("attention.self.value", pl.self_attn.v_proj),
            ("attention.output.dense", pl.self_attn.out_proj),
            ("intermediate.dense", pl.linear1),
            ("output.dense", pl.linear2)]


def _gpt2_params(gpt):
    """(HF GPT2Model name, the port's parameter) of a ``GPTModel``, every
    one stored [in, out] on both sides."""
    out = [("wte.weight", gpt.wte.weight), ("wpe.weight", gpt.wpe.weight),
           ("ln_f.weight", gpt.ln_f.weight), ("ln_f.bias", gpt.ln_f.bias)]
    for i, pb in enumerate(gpt.h):
        p = f"h.{i}."
        for hf, layer in (("ln_1", pb.ln_1), ("ln_2", pb.ln_2),
                          ("attn.c_attn", pb.attn.qkv),
                          ("attn.c_proj", pb.attn.out),
                          ("mlp.c_fc", pb.mlp.fc1),
                          ("mlp.c_proj", pb.mlp.fc2)):
            out += [(p + hf + ".weight", layer.weight),
                    (p + hf + ".bias", layer.bias)]
    return out


def load_hf_gpt2(model, hf_source, strict=True):
    """Load a transformers GPT2LMHeadModel / GPT2Model (or its state
    dict) into a port ``GPTForCausalLM``.  Returns the model.

    HF GPT-2 ties lm_head to wte, so the tied configuration is exact; an
    untied model needs a checkpoint carrying ``lm_head.weight`` and raises
    ``KeyError`` under ``strict`` when it is absent (a random LM head
    would generate garbage with no sign of it)."""
    sd = _state(hf_source)
    pre = "transformer." if any(k.startswith("transformer.")
                                for k in sd) else ""
    for name, param in _gpt2_params(model.gpt):
        _set(param, sd[pre + name])
    if not model.cfg.tie_word_embeddings:
        if "lm_head.weight" in sd:
            _set(model.lm_head.weight, sd["lm_head.weight"],
                 transpose=True)
        elif strict:
            raise KeyError(
                "checkpoint has no lm_head.weight but the model is "
                "untied (tie_word_embeddings=False) — the LM head would "
                "stay randomly initialized; pass strict=False to accept")
    return model


# --- export direction: the port -> an HF state dict -----------------------


def _arr(p, transpose=False):
    """A parameter as a numpy array (bfloat16, which numpy lacks, as
    float32)."""
    t = p.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    a = t.cpu().numpy()
    return np.ascontiguousarray(a.T) if transpose else a.copy()


def to_hf_bert_state(model):
    """numpy state dict in transformers BertModel naming; load it with
    ``hf.load_state_dict({k: torch.tensor(v) for k, v in out.items()})``."""
    emb = model.embeddings
    sd = {"embeddings.word_embeddings.weight": _arr(emb.word.weight),
          "embeddings.position_embeddings.weight":
              _arr(emb.position.weight),
          "embeddings.token_type_embeddings.weight":
              _arr(emb.token_type.weight),
          "embeddings.LayerNorm.weight": _arr(emb.layer_norm.weight),
          "embeddings.LayerNorm.bias": _arr(emb.layer_norm.bias)}
    for i, pl in enumerate(model.encoder.layers):
        p = f"encoder.layer.{i}."
        for hf_name, lin in _bert_linears(pl):
            sd[p + hf_name + ".weight"] = _arr(lin.weight, transpose=True)
            sd[p + hf_name + ".bias"] = _arr(lin.bias)
        sd[p + "attention.output.LayerNorm.weight"] = _arr(pl.norm1.weight)
        sd[p + "attention.output.LayerNorm.bias"] = _arr(pl.norm1.bias)
        sd[p + "output.LayerNorm.weight"] = _arr(pl.norm2.weight)
        sd[p + "output.LayerNorm.bias"] = _arr(pl.norm2.bias)
    sd["pooler.dense.weight"] = _arr(model.pooler.weight, transpose=True)
    sd["pooler.dense.bias"] = _arr(model.pooler.bias)
    return sd


def to_hf_gpt2_state(model):
    """numpy state dict in transformers GPT2Model naming (add the
    ``transformer.`` prefix and the tied ``lm_head.weight`` yourself for
    GPT2LMHeadModel)."""
    sd = {name: _arr(p) for name, p in _gpt2_params(model.gpt)}
    if not model.cfg.tie_word_embeddings:
        sd["lm_head.weight"] = _arr(model.lm_head.weight, transpose=True)
    return sd
