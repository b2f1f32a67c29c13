"""Seq2seq beam-search decoding (port of paddle_tpu/nn/__init__.py
``Decoder``, ``BeamSearchDecoder`` and ``dynamic_decode``, the
paddle.nn.decode API, on text.beam_search_step).

``dynamic_decode`` is the reference's host loop, with its early stop once
every beam has finished: one host read a step.  Kept difference: a state
that is a namedtuple (a ``MultiHeadAttention`` cache, say) is reordered
along the parents and rebuilt as that namedtuple; the reference rebuilds
it as ``type(s)(generator)``, which raises ``TypeError``.
"""
from __future__ import annotations

import torch

from ..text import beam_search_decode, beam_search_step

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]


class Decoder:
    """Seq2seq decoder contract (paddle.nn.decode.Decoder):
    initialize() -> (inputs, states, finished); step() -> (outputs,
    states, next_inputs, finished)."""

    def initialize(self, inits):
        raise NotImplementedError("subclass Decoder and implement "
                                  "initialize()")

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError("subclass Decoder and implement step()")

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states


class BeamSearchDecoder(Decoder):
    """Beam-search decoding over an RNN cell: ``cell(inputs, states)`` ->
    (outputs, states); ``embedding_fn`` maps token ids to the cell's
    inputs, ``output_fn`` its outputs to vocabulary logits."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start, self.end = int(start_token), int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn or (lambda ids: ids)
        self.output_fn = output_fn or (lambda x: x)


def _map_state(fn, s):
    """``fn`` over every tensor of a state: a tensor, or a tuple, list or
    namedtuple of states (rebuilt as its own type)."""
    if isinstance(s, tuple) and hasattr(s, "_fields"):
        return type(s)(*(_map_state(fn, x) for x in s))
    if isinstance(s, (tuple, list)):
        return type(s)(_map_state(fn, x) for x in s)
    return fn(s)


def _first_tensor(s):
    while isinstance(s, (tuple, list)):
        s = s[0]
    return torch.as_tensor(s)


def dynamic_decode(decoder, inits=None, max_step_num=32, **kwargs):
    """Run a BeamSearchDecoder to completion: returns (token ids [B,
    beam, T], final scores [B, beam]), T the steps taken (at most
    ``max_step_num``; fewer once every beam has finished).  ``inits``: the
    cell's initial state, batch first."""
    cell, W = decoder.cell, decoder.beam_size
    if inits is None:
        raise ValueError("dynamic_decode needs the encoder final state "
                         "as `inits`")
    first = _first_tensor(inits)
    B, dev = first.shape[0], first.device
    states = _map_state(
        lambda t: torch.as_tensor(t).repeat_interleave(W, dim=0), inits)
    ids = torch.full((B * W,), decoder.start, dtype=torch.int32, device=dev)
    scores = torch.where(torch.arange(W, device=dev)[None, :] == 0, 0.0,
                         -1e9).expand(B, W).to(torch.float32)
    fin = torch.zeros(B, W, dtype=torch.bool, device=dev)
    step_ids, step_parents = [], []
    base = torch.arange(B, device=dev)[:, None] * W
    for _ in range(max_step_num):
        out, states = cell(decoder.embedding_fn(ids), states)
        logits = torch.as_tensor(decoder.output_fn(out))
        logp = torch.log_softmax(logits, -1)
        sel_ids, parents, scores = beam_search_step(
            logp.reshape(B, W, logp.shape[-1]), scores, W,
            end_token=decoder.end, finished=fin)
        step_ids.append(sel_ids)
        step_parents.append(parents)
        flat_parent = (base + parents).reshape(-1)
        states = _map_state(lambda t: t[flat_parent], states)
        ids = sel_ids.reshape(-1).to(torch.int32)
        fin = fin.gather(1, parents) | (sel_ids == decoder.end)
        if bool(fin.all()):
            break
    return beam_search_decode(torch.stack(step_ids),
                              torch.stack(step_parents), scores)
