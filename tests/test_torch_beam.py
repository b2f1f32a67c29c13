"""The port's beam-search helpers (``paddle_tpu_torch.text``) and
``nn.dynamic_decode`` against the JAX package's, on the CPU.

``gather_tree``, ``beam_search_step`` (with a finished mask, and with
planted ties: the reference's ``lax.top_k`` puts the lower flat index
first, and so must the port) and ``beam_search_decode`` on seeded random
inputs: ids and parents exactly, scores at 1e-6.  ``dynamic_decode`` on the
reference's ToyCell (tests/test_api_surface.py) and on a seeded linear
cell mirrored on the JAX side: sequences exactly, scores at 1e-5 (float32
cell arithmetic in two frameworks).  A namedtuple state, which the
reference cannot reorder (it raises ``TypeError``; ROADMAP §C), is held
against the beam loop written out over its fields.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.tensor import Tensor, unwrap
from paddle_tpu.text import beam_search_decode as jdecode
from paddle_tpu.text import beam_search_step as jstep
from paddle_tpu.text import gather_tree as jgather
from paddle_tpu_torch import nn
from paddle_tpu_torch.text import (beam_search_decode, beam_search_step,
                                   gather_tree)


def _np(x):
    return np.asarray(unwrap(x))


@pytest.mark.parametrize("T,B,W", [(1, 1, 1), (5, 2, 3), (9, 3, 4)])
def test_gather_tree_matches_reference(T, B, W):
    rs = np.random.RandomState(T * 10 + W)
    ids = rs.randint(0, 50, (T, B, W)).astype(np.int32)
    parents = rs.randint(0, W, (T, B, W)).astype(np.int32)
    got = gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    want = _np(jgather(Tensor(jnp.asarray(ids)), Tensor(jnp.asarray(parents))))
    assert got.shape == (T, B, W)
    np.testing.assert_array_equal(got.numpy(), want)


def _step_both(lp, scores, beam, end=None, fin=None):
    got = beam_search_step(
        torch.from_numpy(lp), torch.from_numpy(scores), beam, end_token=end,
        finished=None if fin is None else torch.from_numpy(fin))
    want = jstep(Tensor(jnp.asarray(lp)), Tensor(jnp.asarray(scores)), beam,
                 end_token=end,
                 finished=None if fin is None else Tensor(jnp.asarray(fin)))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    np.testing.assert_allclose(got[2].numpy(), _np(want[2]), atol=1e-6,
                               rtol=1e-6)
    return got


@pytest.mark.parametrize("B,W,V,beam", [(1, 1, 7, 1), (2, 3, 11, 3),
                                        (3, 4, 50, 2)])
def test_beam_search_step_matches_reference(B, W, V, beam):
    rs = np.random.RandomState(V)
    lp = np.log(rs.dirichlet(np.ones(V), (B, W))).astype(np.float32)
    scores = rs.randn(B, W).astype(np.float32)
    _step_both(lp, scores, beam)


def test_beam_search_step_with_finished_beams():
    rs = np.random.RandomState(5)
    B, W, V = 3, 4, 13
    lp = np.log(rs.dirichlet(np.ones(V), (B, W))).astype(np.float32)
    scores = rs.randn(B, W).astype(np.float32)
    fin = rs.rand(B, W) < 0.5
    fin[0] = True                      # a row whose beams have all finished
    ids, parents, new = _step_both(lp, scores, W, end=V - 1, fin=fin)
    # a finished beam's candidate is end_token at its own score
    for b in range(B):
        for j in range(W):
            p = int(parents[b, j])
            if fin[b, p]:
                assert int(ids[b, j]) == V - 1
                assert float(new[b, j]) == scores[b, p]


def test_beam_search_step_breaks_ties_by_the_lowest_flat_index():
    """Planted ties: many equal joint scores across beams and tokens
    (quantised log-probabilities, equal running scores, beams with the
    same row); the reference's picks, lowest parent·V + token first."""
    rs = np.random.RandomState(6)
    B, W, V = 2, 4, 30
    lp = -rs.randint(1, 4, (B, W, V)).astype(np.float32)
    lp[:, 2] = lp[:, 0]
    scores = np.zeros((B, W), np.float32)
    scores[1, 3] = -1.0
    ids, parents, _ = _step_both(lp, scores, 4)
    flat = (parents * V + ids).numpy()
    assert (np.diff(flat[0]) > 0).all()   # row 0: one tied value, in order
    # the initial state of generate: every beam but 0 at finfo.min
    init = np.full((B, W), np.finfo(np.float32).min, np.float32)
    init[:, 0] = 0.0
    _step_both(lp, init, 4)
    # and a finished mask with end_token tied against live candidates
    fin = np.zeros((B, W), bool)
    fin[:, 1] = True
    _step_both(np.full((B, W, V), -1.0, np.float32), scores, 4, end=5,
               fin=fin)


def test_beam_search_decode_matches_reference():
    rs = np.random.RandomState(7)
    T, B, W = 6, 2, 3
    ids = rs.randint(0, 40, (T, B, W)).astype(np.int32)
    parents = rs.randint(0, W, (T, B, W)).astype(np.int32)
    scores = rs.randn(B, W).astype(np.float32)
    seqs, sc = beam_search_decode(torch.from_numpy(ids),
                                  torch.from_numpy(parents),
                                  torch.from_numpy(scores))
    js, jsc = jdecode(Tensor(jnp.asarray(ids)), Tensor(jnp.asarray(parents)),
                      Tensor(jnp.asarray(scores)))
    assert seqs.shape == (B, W, T)
    np.testing.assert_array_equal(seqs.numpy(), _np(js))
    np.testing.assert_allclose(sc.numpy(), _np(jsc), atol=1e-6, rtol=1e-6)


TOY_V = 5


class ToyCell:
    """The reference test's cell: it prefers token (state + 1) mod V."""

    def __call__(self, ids, state):
        logits = torch.eye(TOY_V)[(state + 1) % TOY_V] * 10.0
        return logits, (state + 1) % TOY_V


class JaxToyCell:
    def __call__(self, ids, state):
        s = unwrap(state)
        return (Tensor(jnp.eye(TOY_V)[(s + 1) % TOY_V] * 10.0),
                Tensor((s + 1) % TOY_V))


def test_dynamic_decode_toy_cell_matches_reference():
    dec = nn.BeamSearchDecoder(ToyCell(), start_token=0,
                               end_token=TOY_V - 1, beam_size=2)
    seqs, scores = nn.dynamic_decode(dec, inits=torch.zeros(2,
                                                            dtype=torch.int64),
                                     max_step_num=8)
    jdec = jnn.BeamSearchDecoder(JaxToyCell(), start_token=0,
                                 end_token=TOY_V - 1, beam_size=2)
    jseqs, jscores = jnn.dynamic_decode(
        jdec, inits=paddle.to_tensor(np.zeros(2, np.int64)), max_step_num=8)
    assert list(seqs[0, 0, :4].numpy()) == [1, 2, 3, 4]
    np.testing.assert_array_equal(seqs.numpy(), _np(jseqs))
    np.testing.assert_allclose(scores.numpy(), _np(jscores), atol=1e-5,
                               rtol=1e-5)


D, LV = 8, 17     # the linear cell's width and vocabulary


def _linear_weights():
    rs = np.random.RandomState(8)
    return [rs.randn(*s).astype(np.float32) * 0.8
            for s in ((LV, D), (D, D), (D, D), (D, LV))]


def test_dynamic_decode_linear_cell_matches_reference():
    emb, wx, wh, wo = _linear_weights()
    temb, twx, twh, two = map(torch.from_numpy, (emb, wx, wh, wo))

    def cell(x, h):
        h = torch.tanh(x @ twx + h @ twh)
        return h, h

    def jcell(x, h):
        h = jnp.tanh(unwrap(x) @ wx + unwrap(h) @ wh)
        return Tensor(h), Tensor(h)

    h0 = np.random.RandomState(9).randn(3, D).astype(np.float32)
    dec = nn.BeamSearchDecoder(cell, 0, 3, 4,
                               embedding_fn=lambda i: temb[i.long()],
                               output_fn=lambda o: o @ two)
    seqs, scores = nn.dynamic_decode(dec, inits=torch.from_numpy(h0),
                                     max_step_num=7)
    jdec = jnn.BeamSearchDecoder(
        jcell, 0, 3, 4, embedding_fn=lambda i: Tensor(emb[_np(i)]),
        output_fn=lambda o: Tensor(unwrap(o) @ wo))
    jseqs, jscores = jnn.dynamic_decode(jdec, inits=Tensor(jnp.asarray(h0)),
                                        max_step_num=7)
    assert seqs.shape == (3, 4, 7)
    np.testing.assert_array_equal(seqs.numpy(), _np(jseqs))
    np.testing.assert_allclose(scores.numpy(), _np(jscores), atol=1e-5,
                               rtol=1e-5)


State = collections.namedtuple("State", ["h", "c"])


def test_dynamic_decode_reorders_a_namedtuple_state():
    """A cell whose state is a namedtuple (h, c), against the same beam
    search written out as a loop over the two fields."""
    emb, wx, wh, wo = map(torch.from_numpy, _linear_weights())
    B, W, end, steps = 2, 3, 3, 6

    def core(x, h, c):
        c = 0.5 * c + x @ wx
        h = torch.tanh(c + h @ wh)
        return h, c

    def cell(x, state):
        assert isinstance(state, State)
        h, c = core(x, state.h, state.c)
        return h, State(h, c)

    rs = np.random.RandomState(10)
    h0 = torch.from_numpy(rs.randn(B, D).astype(np.float32))
    c0 = torch.from_numpy(rs.randn(B, D).astype(np.float32))
    dec = nn.BeamSearchDecoder(cell, 0, end, W,
                               embedding_fn=lambda i: emb[i.long()],
                               output_fn=lambda o: o @ wo)
    seqs, scores = nn.dynamic_decode(dec, inits=State(h0, c0),
                                     max_step_num=steps)

    # the loop written out
    h, c = h0.repeat_interleave(W, 0), c0.repeat_interleave(W, 0)
    ids = torch.zeros(B * W, dtype=torch.long)
    sc = torch.full((B, W), -1e9)
    sc[:, 0] = 0.0
    fin = torch.zeros(B, W, dtype=torch.bool)
    hist_ids, hist_par = [], []
    for _ in range(steps):
        h, c = core(emb[ids], h, c)
        lp = torch.log_softmax(h @ wo, -1).reshape(B, W, LV)
        lp = torch.where(fin[..., None],
                         torch.where(torch.arange(LV) == end, 0.0,
                                     float("-inf")), lp)
        total = (sc[..., None] + lp).reshape(B, W * LV)
        # the W best candidates of each row, the lower flat index first
        idx = torch.tensor([sorted(range(W * LV),
                                   key=lambda j, b=b: (-total[b, j].item(),
                                                       j))[:W]
                            for b in range(B)])
        tok, par = idx % LV, idx // LV
        sc = total.gather(1, idx)
        rows = (torch.arange(B)[:, None] * W + par).reshape(-1)
        h, c = h[rows], c[rows]
        fin = fin.gather(1, par) | (tok == end)
        ids = tok.reshape(-1)
        hist_ids.append(tok)
        hist_par.append(par)
        if bool(fin.all()):
            break
    # backtrack each final beam through its parents
    want = np.zeros((B, W, len(hist_ids)), np.int64)
    for b in range(B):
        for w in range(W):
            beam = w
            for t in range(len(hist_ids) - 1, -1, -1):
                want[b, w, t] = hist_ids[t][b, beam]
                beam = int(hist_par[t][b, beam])
    np.testing.assert_array_equal(seqs.numpy(), want)
    np.testing.assert_array_equal(scores.numpy(), sc.numpy())
