"""Beam-search helpers of paddle.text (port of the decoding ops of
paddle_tpu/text/__init__.py: ``gather_tree``, ``beam_search_step`` and
``beam_search_decode``, the dense [B, ...] redesigns of the reference's
gather_tree_op.cc, beam_search_op.cc and beam_search_decode_op.cc).

Each is plain PyTorch over the caller's tensors, with no host sync, so
``GPTForCausalLM.generate`` runs them inside its captured beam step.  Not
ported yet (ROADMAP.md): the text datasets, ``ViterbiDecoder``,
``linear_chain_crf`` and ``text/sequence.py``.
"""
from __future__ import annotations

import torch

__all__ = ["gather_tree", "beam_search_step", "beam_search_decode"]


def gather_tree(ids, parents):
    """Backtrack beam parent pointers into full sequences: ids/parents
    [T, B, W] -> [T, B, W], step t holding the token on the surviving path
    through the beams' parents (walked back from the last step, where beam
    w is path w)."""
    T, B, W = ids.shape
    beam = torch.arange(W, device=ids.device).expand(B, W)
    out = [None] * T
    for t in range(T - 1, -1, -1):
        out[t] = ids[t].gather(1, beam)
        beam = parents[t].long().gather(1, beam)
    return torch.stack(out)


def beam_search_step(log_probs, pre_scores, beam_size, end_token=None,
                     finished=None):
    """One beam expansion: log_probs [B, W, V] of the current step and the
    running scores pre_scores [B, W] -> (ids [B, beam_size], parents [B,
    beam_size], scores [B, beam_size]), the top ``beam_size`` of the W·V
    joint candidates ``pre_scores + log_probs``.  Beams marked in
    ``finished`` [B, W] keep their score and propose only ``end_token``.

    Ties go to the lowest flat index ``parent·V + token``, as the
    reference's ``lax.top_k`` orders them (``torch.topk`` makes no promise
    among equal values): a stable descending sort."""
    B, W, V = log_probs.shape
    lp = log_probs
    if finished is not None:
        keep = torch.full((V,), float("-inf"), dtype=lp.dtype,
                          device=lp.device)
        if end_token is not None and 0 <= end_token < V:
            keep[end_token] = 0.0
        lp = torch.where(finished[..., None], keep, lp)
    flat = (pre_scores[..., None] + lp).reshape(B, W * V)
    idx = torch.sort(flat, dim=1, descending=True,
                     stable=True).indices[:, :beam_size]
    return idx % V, idx // V, flat.gather(1, idx)


def beam_search_decode(step_ids, step_parents, final_scores):
    """Assemble beam outputs into ranked sequences: step_ids/step_parents
    [T, B, W] and final scores [B, W] -> (sequences [B, W, T], scores
    [B, W])."""
    return gather_tree(step_ids, step_parents).permute(1, 2, 0), \
        final_scores
