"""The float32 flash-attention forward's split-TF32 arithmetic, on the CPU.

``flash_fwd_tf32x3_kernel`` (paddle_tpu_torch/csrc/flash_attention.cu)
computes both products of the online softmax, S = Q K^T and O += P V, on
the TF32 tensor cores: each float32 operand x is split into big = tf32(x)
and small = tf32(x - big), and a . b = a_small . b_big + a_big . b_small +
a_big . b_big with a float32 accumulator, per k-step of 8.  The card is not
here, so this file writes that arithmetic in plain PyTorch float32 (TF32
rounding to nearest, ties away from zero, by bit masks on the int32 view;
the three-term split; the kernel's key tiles of 64, 32 at D = 128, its
online softmax in ``softmax_tile``'s order; P . V with the permuted
contraction index, each k-step from a zero accumulator) and holds this
model of the kernel against two oracles:
the port's ``flash_attention_plain`` (what the card tests hold the kernel
against) and the JAX package's Pallas ``_fwd_call`` in interpret mode.
It shows why P . V starts each k-step from zero: the tensor cores
truncate when they accumulate, and chained over the key loop that drifts
O toward zero.  It also checks the fragment bookkeeping the kernel rests
on: the permuted
contraction index (a lane's score accumulators are its A operand of P V as
they stand) and the shared-memory reads of K and V falling in 32 distinct
banks (no profiler counts bank conflicts on the card's machine).

Tolerance 2e-5 x max(1, max|ref|), the card's float32 limit (``F32_TOL``
of chip_smoke.py).  One TF32 product (11 bits of each operand) misses it
by far at D = 64: the test asserts that too, as the reason for the split.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import _fold_mask, _fwd_call
from paddle_tpu_torch.ops.kernels import flash_attention as KF

F32_TOL = 2e-5
B, H = 2, 3
LOG2E = 1.4426950408889634


def tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: the 13 low
    mantissa bits rounded to nearest, ties away from zero (half their
    range added to the magnitude, then cleared), as a float32."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    """(big, small): big = tf32(x), small = tf32(x - big)."""
    big = tf32(x)
    return big, tf32(x - big)


def rz(x):
    """float64 x rounded to float32 toward zero: how the tensor cores round
    when they add to an accumulator."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mma(acc, a, b, three=True, fresh=False, truncate=False):
    """acc + a @ b ([..., M, K] @ [..., K, N]) a k-step of 8 at a time, as
    ``mma_tf32x3`` adds it: the two small terms, then big . big, each
    added to the accumulator rounded to nearest (with ``truncate``, the
    products of a k-step summed exactly and added in one rounding toward
    zero, as the tensor cores round).  ``fresh``: each k-step from a zero accumulator, added
    to acc rounded to nearest on the CUDA cores (``mma_tf32x3_zero``, as
    P V does).  ``three=False``: one TF32 product a k-step, what a plain
    TF32 kernel computes."""
    if three:
        a_hi, a_lo = split(a)
        b_hi, b_lo = split(b)
        terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))
    else:
        terms = ((tf32(a), tf32(b)),)
    for k0 in range(0, a.shape[-1], 8):
        sl = slice(k0, k0 + 8)
        t = torch.zeros_like(acc) if fresh else acc
        for x, y in terms:
            if truncate:
                t = rz(t.double() + x[..., sl].double()
                       @ y[..., sl, :].double())
            else:
                t = t + x[..., sl] @ y[..., sl, :]
        acc = acc + t if fresh else t
    return acc


def p_operand_order():
    """For each lane (g, t) of m16n8k8: the (row, key) of the score tile
    that each A slot of P . V reads, when k-slot t is key 2t and k-slot
    t + 4 is key 2t + 1, beside the (row, key) of the lane's own C
    accumulators; and the V rows its two B slots read."""
    lanes = {}
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        key = {t: 2 * t, t + 4: 2 * t + 1}        # k-slot -> key
        # A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
        # a3 (g + 8, t + 4)
        a = [(g, key[t]), (g + 8, key[t]), (g, key[t + 4]),
             (g + 8, key[t + 4])]
        # C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
        # c3 (g + 8, 2t + 1)
        c = [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]
        # B (8 x 8): b0 (k = t, n = g), b1 (k = t + 4, n = g)
        b_rows = [key[t], key[t + 4]]
        lanes[lane] = (a, c, b_rows)
    return lanes


def tf32x3_attention(q, k, v, causal=True, bias=None, sm_scale=None,
                     dropout_p=0.0, seed=0, three=True, truncate=False,
                     fresh_pv=True):
    """The kernel's arithmetic: q [B, S_q, H, D], k, v [B, S_k, H, D]
    float32, an optional float32 [B, H, S_q, S_k] bias.  Key tiles of 64
    (32 at D = 128); per tile S = Q K^T by ``mma`` (raw dots), the
    softmax of ``softmax_tile`` (without a bias: the max over raw dots and
    p = 2^(s c - m c), c = scale log2(e); with one: x = s scale + bias and
    p = 2^((x - m) log2(e)); keys past the diagonal -inf), then O += P V by
    ``mma`` over the permuted key order of each 8-key step, each k-step
    from a zero accumulator (``fresh_pv``).  ``three`` and ``truncate``:
    :func:`mma`'s.  Returns (out [B, S_q, H, D], lse [B*H, S_q])."""
    Bq, S_q, Hq, D = q.shape
    S_k = k.shape[1]
    scale = 1.0 / math.sqrt(D) if sm_scale is None else sm_scale
    n_tile = 32 if D == 128 else 64
    qt, kt, vt = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    keep = None
    if dropout_p > 0:
        keep = KF.dropout_keep_plain(seed, Bq, Hq, S_q, dropout_p, S_k=S_k)
    fast = bias is None and scale > 0
    c = torch.tensor(scale * LOG2E if fast else LOG2E, dtype=torch.float32)
    o = torch.zeros(Bq, Hq, S_q, D)
    m = torch.full((Bq, Hq, S_q, 1), float("-inf"))
    l = torch.zeros(Bq, Hq, S_q, 1)
    rows = torch.arange(S_q)[:, None]
    # the kernel's order of each 8-key step: k-slots t and t + 4 read keys
    # 2t and 2t + 1 of the lane's accumulators, V's rows to match
    perm = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    for k0 in range(0, S_k, n_tile):
        n = min(n_tile, S_k - k0)
        kk = kt[:, :, k0:k0 + n]
        s = mma(torch.zeros(Bq, Hq, S_q, n), qt, kk.transpose(-1, -2),
                three, truncate=truncate)
        keys = torch.arange(k0, k0 + n)[None, :]
        if not fast:
            s = s * scale
            if bias is not None:
                s = s + bias[..., k0:k0 + n]
        if causal:
            s = s.masked_fill(keys > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp2((m - m_use) * c)
        p = torch.exp2(s * c - m_use * c) if fast \
            else torch.exp2((s - m_use) * c)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha
        m = m_new
        if keep is not None:
            p = torch.where(keep[..., k0:k0 + n], p * KF.dropout_scale(
                dropout_p), 0.0)
        pad = -n % 8                  # the staged tile's zero keys
        p = torch.nn.functional.pad(p, (0, pad))
        vv = torch.nn.functional.pad(vt[:, :, k0:k0 + n], (0, 0, 0, pad))
        order = torch.cat([perm + j for j in range(0, n + pad, 8)])
        o = mma(o, p[..., order], vv[..., order, :], three, fresh_pv,
                truncate)
    l_safe = torch.where(l == 0, 1.0, l)
    m_out = torch.where(m == float("-inf"), 0.0, m * (scale if fast else 1))
    out = (o / l_safe).permute(0, 2, 1, 3)
    return out, (m_out + torch.log(l_safe))[..., 0].reshape(Bq * Hq, S_q)


def _inputs(S_q, S_k, D, form, seed):
    """q, k, v float32 from a numpy seed, and (causal, the port's bias,
    the numpy mask it came from)."""
    rs = np.random.RandomState(seed)
    q = rs.randn(B, S_q, H, D).astype(np.float32)
    k, v = (rs.randn(B, S_k, H, D).astype(np.float32) for _ in range(2))
    mask = None
    if form == "bool":
        mask = rs.rand(B, 1, 1, S_k) > 0.3
        mask[..., 0] = True
    elif form == "additive":
        mask = rs.randn(B, 1, S_q, S_k).astype(np.float32)
    elif form == "masked-row":
        mask = rs.randn(B, 1, S_q, S_k).astype(np.float32)
        mask[0, 0, S_q // 2] = -1e30   # a uniform average of V
    bias = None if mask is None else KF.fold_mask(
        torch.from_numpy(mask), B, H, S_q, S_k)
    return (*(torch.from_numpy(a) for a in (q, k, v)), form == "causal",
            bias, mask)


def _tol(ref):
    return F32_TOL * max(1.0, ref.abs().max().item())


SELF = [(1, 1), (17, 17), (64, 64), (77, 77)]
CROSS = [(1, 77), (17, 64), (64, 17)]
FORMS = ["causal", "non-causal", "bool", "additive", "masked-row"]


@pytest.mark.parametrize("S_q,S_k", SELF + CROSS)
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("form", FORMS)
def test_model_matches_plain(S_q, S_k, D, form):
    """The split-TF32 model against the port's plain version: output and
    LSE, every form, S_q = S_k and not."""
    q, k, v, causal, bias, _ = _inputs(S_q, S_k, D, form, S_q * 97 + S_k + D)
    out, lse = tf32x3_attention(q, k, v, causal, bias)
    ref, ref_lse = KF.flash_attention_plain(q, k, v, causal, bias)
    assert (out - ref).abs().max().item() <= _tol(ref)
    assert (lse - ref_lse).abs().max().item() <= _tol(ref_lse)


@pytest.mark.parametrize("S_q,S_k", [(17, 17), (64, 64), (77, 77), (1, 77),
                                     (17, 64)])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("form", FORMS)
def test_model_matches_pallas_interpret(S_q, S_k, D, form):
    """The split-TF32 model against the JAX package's ``_fwd_call`` in
    interpret mode (tiles of 8 where S is a multiple, else the whole
    sequence), on the same numpy inputs: the output."""
    q, k, v, causal, bias, mask = _inputs(S_q, S_k, D, form,
                                          S_q * 89 + S_k + D)
    out, _ = tf32x3_attention(q, k, v, causal, bias)

    def fold(x):
        return jnp.asarray(x.numpy().transpose(0, 2, 1, 3).reshape(
            B * H, -1, D))

    jbias = None if mask is None else _fold_mask(jnp.asarray(mask), B, H,
                                                 S_q, S_k)
    ref, _ = _fwd_call(fold(q), fold(k), fold(v), jbias, causal,
                       1.0 / math.sqrt(D), 8 if S_q % 8 == 0 else S_q,
                       8 if S_k % 8 == 0 else S_k, True)
    ref = torch.from_numpy(np.array(ref).reshape(B, H, S_q, D)
                           ).permute(0, 2, 1, 3)
    assert (out - ref).abs().max().item() <= _tol(ref)


@pytest.mark.parametrize("S_q,S_k", [(17, 17), (77, 77), (1, 77), (64, 17)])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_model_with_dropout_matches_plain(S_q, S_k, D, causal):
    """Dropout p = 0.1: the kernel's Philox mask on the split P (the LSE
    of the weights before dropout) against the plain version's."""
    q, k, v, _, bias, _ = _inputs(S_q, S_k, D, "bool", S_q + 3 * S_k + D)
    form = dict(causal=causal, bias=bias, dropout_p=0.1, seed=S_q * 7 + D)
    out, lse = tf32x3_attention(q, k, v, **form)
    ref, ref_lse = KF.flash_attention_plain(q, k, v, **form)
    assert (out - ref).abs().max().item() <= _tol(ref)
    assert (lse - ref_lse).abs().max().item() <= _tol(ref_lse)


@pytest.mark.parametrize("fill", [-1e30, float("-inf")])
def test_model_row_masked_everywhere(fill):
    """A row masked everywhere by -1e30 stays the uniform average of V
    (the bias is added to the float32 scores, never split); by -inf it
    gives O = 0 and LSE = 0, the reference's ``l_safe``."""
    q, k, v, _, _, _ = _inputs(40, 40, 64, "non-causal", 5)
    mask = torch.zeros(B, 1, 40, 40)
    mask[0, 0, 3] = fill
    bias = KF.fold_mask(mask, B, H, 40, 40)
    out, lse = tf32x3_attention(q, k, v, False, bias)
    ref, _ = KF.flash_attention_plain(q, k, v, False, bias)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= _tol(ref)
    if fill == float("-inf"):
        assert torch.all(out[0, 3] == 0) and torch.all(lse[:H, 3] == 0)
    else:
        mean = v[0].mean(0)
        assert (out[0, 3] - mean).abs().max().item() <= _tol(mean)


@pytest.mark.parametrize("form", ["causal", "non-causal", "bool"])
def test_one_tf32_product_misses_the_tolerance(form):
    """Why the kernel splits: at D = 64 one TF32 product a k-step (what a
    plain TF32 kernel computes) misses 2e-5 x max(1, max|ref|) against the
    plain version, where the three-term split holds it on the same
    inputs."""
    q, k, v, causal, bias, _ = _inputs(64, 64, 64, form, 11)
    ref, _ = KF.flash_attention_plain(q, k, v, causal, bias)
    one, _ = tf32x3_attention(q, k, v, causal, bias, three=False)
    three, _ = tf32x3_attention(q, k, v, causal, bias)
    assert (one - ref).abs().max().item() > _tol(ref)
    assert (three - ref).abs().max().item() <= _tol(ref)


@pytest.mark.parametrize("S", [256, 1024])
def test_fresh_pv_steps_keep_truncation_from_drifting(S):
    """The tensor cores round toward zero when they add to an
    accumulator.  Chained over the key loop, O drifts toward zero: its
    mean signed error is below -1e-6 of its mean size at S = 256 and grows
    with S (the backward's rowsum(dO * O) turns that into a systematic
    gradient error).  With each k-step of P V from a zero accumulator,
    added to O rounded to nearest (``mma_tf32x3_zero``, the kernel's way),
    it stays within 1e-7."""
    rs = np.random.RandomState(3)
    q, k = (torch.from_numpy(0.3 * rs.randn(1, S, 2, 64).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rs.randn(1, S, 2, 64).astype(np.float32) + 0.5)
    ref = KF.flash_attention_plain(q.double(), k.double(), v.double(),
                                   False)[0].float()

    def drift(fresh_pv):
        out, _ = tf32x3_attention(q, k, v, False, truncate=True,
                                  fresh_pv=fresh_pv)
        return (((out - ref) * ref.sign()).mean()
                / ref.abs().mean()).item()

    chained, fresh = drift(False), drift(True)
    assert chained < -1e-6 * S / 256
    assert abs(fresh) < 1e-7


def test_tf32_rounds_to_nearest_ties_away():
    """``tf32`` keeps 10 stored mantissa bits: below half an ulp (2^-11 of
    1) rounds down, at half and above rounds away from zero, both signs;
    the split recovers x to 2^-22 of its size."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp * 0.49, 1 + ulp * 0.5, 1 + ulp * 0.51,
                      -(1 + ulp * 0.5), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + ulp, 1 + ulp, -(1 + ulp), 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    assert torch.all(tf32(x).view(torch.int32) & 0x1FFF == 0)
    y = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(
        np.float32))
    big, small = split(y)
    assert torch.all((big + small - y).abs() <= y.abs() * 2.0 ** -22)
    assert torch.all((tf32(y) - y).abs() <= y.abs() * 2.0 ** -11)


def test_p_is_its_own_a_operand():
    """With k-slot t read as key 2t and t + 4 as 2t + 1, each lane's four
    A entries of P V are exactly its four C accumulators of the score tile
    (no shuffle), every (row, key) of the 16 x 8 tile is some lane's, and
    the lane's B slots read V's rows 2t and 2t + 1 to match."""
    lanes = p_operand_order()
    seen = set()
    for lane, (a, c, b_rows) in lanes.items():
        assert sorted(a) == sorted(c), lane
        t = lane & 3
        assert b_rows == [2 * t, 2 * t + 1]
        seen.update(a)
    assert seen == {(r, key) for r in range(16) for key in range(8)}


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_fragment_reads_fall_in_distinct_banks(D):
    """The kernel's shared-memory reads of a fragment: K rows padded to
    D + 8 floats, read as a float2 (columns 2t, 2t + 1 of key g) by each
    half-warp, and V rows padded to D + 4, read one float a lane (rows 2t
    and 2t + 1, column g): no two lanes of one wavefront share a bank."""
    ld_k, ld_v = D + 8, D + 4
    for half in (range(16), range(16, 32)):
        banks = [(((l >> 2) * ld_k + 2 * (l & 3)) + e) % 32
                 for l in half for e in (0, 1)]
        assert len(set(banks)) == 32, (D, banks)
    for row in (0, 1):
        banks = [((2 * (l & 3) + row) * ld_v + (l >> 2)) % 32
                 for l in range(32)]
        assert len(set(banks)) == 32, (D, row, banks)
