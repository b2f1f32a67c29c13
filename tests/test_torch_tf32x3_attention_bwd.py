"""The float32 flash-attention backward's split-TF32 arithmetic, on the CPU.

``flash_dq_tf32x3_kernel`` and ``flash_dkv_tf32x3_kernel``
(paddle_tpu_torch/csrc/flash_attention_bwd.cu) compute every product of
the backward on the TF32 tensor cores: each float32 operand x is split
into big = tf32(x) and small = tf32(x - big), and a . b = a_small . b_big +
a_big . b_small + a_big . b_big with a float32 accumulator, per k-step of 8.
The card is not here, so this file writes that arithmetic in plain
PyTorch float32 (TF32 rounding to nearest, ties away from zero, by bit
masks on the int32 view; the three-term split; dq's key tiles of 32, 16 at
D = 128, and dk/dv's query tiles of 16; S and S^T with their D / 8
k-steps chained, dP and dP^T a k-step at a time from a zero accumulator;
p and dS in float32; the second products over the permuted contraction
index, each streamed tile's part from a zero accumulator added to the
running sum rounded to nearest) and holds this
model of the kernels against two oracles: the port's
``flash_attention_dq_plain`` / ``flash_attention_dkv_plain`` (what the card
tests hold the kernels against) and the JAX package's Pallas ``_bwd_call``
in interpret mode.

It shows why the sums over the loop start each tile from zero: the tensor
cores truncate when they add to an accumulator, and dq, dk and dv chained
in one accumulator over S = 1024 drift toward zero.  It also counts the
shared-memory bank conflicts of every fragment read of the kernels'
swizzled tiles (no profiler counts them on the card's machine).

Tolerance 2e-5 x max(1, max|ref|), the card's float32 limit (``F32_TOL``
of chip_smoke.py).  One TF32 product (11 bits of each operand) misses it
at D = 64: the test asserts that too, as the reason for the split.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import _bwd_call, _fold_mask
from paddle_tpu_torch.ops.kernels import flash_attention as KF

F32_TOL = 2e-5
B, H = 2, 3
LOG2E = 1.4426950408889634
DQ_KEYS = {16: 32, 32: 32, 64: 32, 128: 16}   # dq's keys a streamed tile
DKV_QUERIES = 16                              # dk/dv's queries a tile
# the kernels' order of an 8-row k-step of the second products: k-slots t
# and t + 4 read rows 2t and 2t + 1 (a lane's accumulator columns)
PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


@pytest.fixture(autouse=True)
def _one_thread():
    """The model's many small products run fastest on one thread, and the
    suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: the 13 low
    mantissa bits rounded to nearest, ties away from zero, as a float32."""
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


def mma(acc, a, b, three=True, truncate=False, scheme="chain"):
    """acc + a @ b ([..., M, K] @ [..., K, N]) a k-step of 8 at a time, as
    ``mma_tf32x3`` adds it: the two small terms, then big . big, each
    added to the accumulator rounded to nearest (with ``truncate``, the
    products of a k-step summed exactly and added in one rounding toward
    zero, as the tensor cores round).  ``scheme``: "chain" adds every
    k-step to acc itself; "tile" sums the k-steps from a zero accumulator
    and adds the part to acc rounded to nearest (the kernels' way, once a
    streamed tile); "step" does that for each k-step (the forward's P V).
    ``three=False``: one TF32 product a k-step."""
    if three:
        a_hi, a_lo = split(a)
        b_hi, b_lo = split(b)
        terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))
    else:
        terms = ((tf32(a), tf32(b)),)
    part = acc if scheme == "chain" else torch.zeros_like(acc)
    for k0 in range(0, a.shape[-1], 8):
        sl = slice(k0, k0 + 8)
        for x, y in terms:
            if truncate:
                part = rz(part.double() + x[..., sl].double()
                          @ y[..., sl, :].double())
            else:
                part = part + x[..., sl] @ y[..., sl, :]
        if scheme == "step":
            acc, part = acc + part, torch.zeros_like(acc)
    return {"chain": part, "tile": acc + part, "step": acc}[scheme]


def _padded(x, n, dim):
    """x zero-padded along ``dim`` to n rows (a staged tile's rows past
    the sequence are zeros)."""
    pad = n - x.shape[dim]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim)


def _order(n):
    """The permuted row order of n rows (a multiple of 8)."""
    return torch.cat([PERM + j for j in range(0, n, 8)])


def _weights(s, q_idx, k_idx, lse, causal, bias, scale, S_k):
    """p = exp(s - lse) as the kernels form it from the raw dots ``s``,
    whose entries have the query and key indices ``q_idx`` and ``k_idx``
    (broadcast): without a bias 2^(s c - lse log2 e), c = scale log2 e;
    with one 2^((s scale + bias - lse) log2 e); keys past S_k and pairs
    above the diagonal 0."""
    if bias is None:
        c = torch.tensor(scale * LOG2E, dtype=torch.float32)
        p = torch.exp2(s * c - lse * torch.tensor(LOG2E))
    else:
        p = torch.exp2((s * scale + bias - lse) * torch.tensor(LOG2E))
    dead = k_idx >= S_k
    if causal:
        dead = dead | (k_idx > q_idx)
    return p.masked_fill(dead, 0.0)


def tf32x3_dq(q, k, v, do, lse, delta, causal=True, bias=None,
              sm_scale=None, keep=None, dropout_p=0.0, three=True,
              truncate=False, scheme="tile"):
    """dq as ``flash_dq_tf32x3_kernel`` computes it: q, do [B, S_q, H, D],
    k, v [B, S_k, H, D], lse and delta [B*H, S_q], bias [B, H, S_q, S_k]
    or None, keep the dropout mask [B, H, S_q, S_k] or None.  Per key tile:
    S = Q K^T (D / 8 chained k-steps), dP = dO V^T (a k-step at a time),
    p, dropout on dP, dS = p (dP - delta) scale, then dq += dS K over the
    permuted key order with ``scheme``."""
    Bq, S_q, Hq, D = q.shape
    S_k = k.shape[1]
    scale = 1.0 / math.sqrt(D) if sm_scale is None else sm_scale
    n_tile = DQ_KEYS[D]
    qt, kt, vt, dot = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    lse = lse.reshape(Bq, Hq, S_q, 1)
    delta = delta.reshape(Bq, Hq, S_q, 1)
    dq = torch.zeros(Bq, Hq, S_q, D)
    rows = torch.arange(S_q)[:, None]
    for k0 in range(0, S_k, n_tile):
        kk = _padded(kt[:, :, k0:k0 + n_tile], n_tile, 2)
        vv = _padded(vt[:, :, k0:k0 + n_tile], n_tile, 2)
        keys = torch.arange(k0, k0 + n_tile)[None, :]
        zero = torch.zeros(Bq, Hq, S_q, n_tile)
        s = mma(zero, qt, kk.transpose(-1, -2), three, truncate)
        dp = mma(zero, dot, vv.transpose(-1, -2), three, truncate, "step")
        tb = None if bias is None else _padded(
            bias[..., k0:k0 + n_tile], n_tile, 3)
        p = _weights(s, rows, keys, lse, causal, tb, scale, S_k)
        if keep is not None:
            z = _padded(keep[..., k0:k0 + n_tile], n_tile, 3)
            dp = torch.where(z, dp * KF.dropout_scale(dropout_p), 0.0)
        ds = p * (dp - delta) * scale
        order = _order(n_tile)
        dq = mma(dq, ds[..., order], kk[..., order, :], three, truncate,
                 scheme)
    return dq.permute(0, 2, 1, 3)


def tf32x3_dkv(q, k, v, do, lse, delta, causal=True, bias=None,
               sm_scale=None, keep=None, dropout_p=0.0, three=True,
               truncate=False, scheme="tile"):
    """(dk, dv) as ``flash_dkv_tf32x3_kernel`` computes them: per query
    tile of 16, S^T = K Q^T (D / 8 chained k-steps), dP^T = V dO^T (a
    k-step at a time), p, dropout (dv takes p z / (1 - p), dP^T is masked
    likewise), dS^T, then dv += P^T dO and dk += dS^T Q over the permuted
    query order with ``scheme``."""
    Bq, S_q, Hq, D = q.shape
    S_k = k.shape[1]
    scale = 1.0 / math.sqrt(D) if sm_scale is None else sm_scale
    n_tile = DKV_QUERIES
    qt, kt, vt, dot = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    lse_t = lse.reshape(Bq, Hq, 1, S_q)
    delta_t = delta.reshape(Bq, Hq, 1, S_q)
    dk = torch.zeros(Bq, Hq, S_k, D)
    dv = torch.zeros(Bq, Hq, S_k, D)
    keys = torch.arange(S_k)[:, None]
    for q0 in range(0, S_q, n_tile):
        qq = _padded(qt[:, :, q0:q0 + n_tile], n_tile, 2)
        oo = _padded(dot[:, :, q0:q0 + n_tile], n_tile, 2)
        lq = _padded(lse_t[..., q0:q0 + n_tile], n_tile, 3)
        dq_ = _padded(delta_t[..., q0:q0 + n_tile], n_tile, 3)
        queries = torch.arange(q0, q0 + n_tile)[None, :]
        zero = torch.zeros(Bq, Hq, S_k, n_tile)
        s = mma(zero, kt, qq.transpose(-1, -2), three, truncate)
        dp = mma(zero, vt, oo.transpose(-1, -2), three, truncate, "step")
        tb = None if bias is None else _padded(
            bias[..., q0:q0 + n_tile, :], n_tile, 2).transpose(-1, -2)
        p = _weights(s, queries, keys, lq, causal, tb, scale, S_k)
        p = p.masked_fill(queries >= S_q, 0.0)
        pd = p
        if keep is not None:
            z = _padded(keep[..., q0:q0 + n_tile, :], n_tile, 2).transpose(
                -1, -2)
            dp = torch.where(z, dp * KF.dropout_scale(dropout_p), 0.0)
            pd = torch.where(z, p * KF.dropout_scale(dropout_p), 0.0)
        ds = p * (dp - dq_) * scale
        order = _order(n_tile)
        dv = mma(dv, pd[..., order], oo[..., order, :], three, truncate,
                 scheme)
        dk = mma(dk, ds[..., order], qq[..., order, :], three, truncate,
                 scheme)
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def _inputs(S_q, S_k, D, form, seed):
    """q, k, v, dO float32 from a numpy seed, the forward's LSE and delta
    (the port's plain forward), and (causal, the port's bias, the numpy
    mask it came from)."""
    rs = np.random.RandomState(seed)
    q, do = (rs.randn(B, S_q, H, D).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(B, S_k, H, D).astype(np.float32) for _ in range(2))
    mask = None
    if form == "bool":
        mask = rs.rand(B, 1, 1, S_k) > 0.3
        mask[..., 0] = True
    elif form in ("additive", "causal+additive"):
        mask = rs.randn(B, 1, S_q, S_k).astype(np.float32)
    elif form == "masked-row":
        mask = rs.randn(B, 1, S_q, S_k).astype(np.float32)
        mask[0, 0, S_q // 2] = -1e30   # every key of one row masked
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    bias = None if mask is None else KF.fold_mask(
        torch.from_numpy(mask), B, H, S_q, S_k)
    causal = form.startswith("causal")
    o, lse = KF.flash_attention_plain(q, k, v, causal, bias)
    delta = KF.flash_attention_delta(o, do)
    return q, k, v, do, o, lse, delta, causal, bias, mask


def _tol(ref):
    return F32_TOL * max(1.0, ref.abs().max().item())


def _close(got, ref):
    return (got - ref).abs().max().item() <= _tol(ref)


SELF = [(1, 1), (17, 17), (64, 64), (77, 77)]
CROSS = [(1, 77), (17, 64), (64, 17)]
FORMS = ["causal", "non-causal", "bool", "additive", "causal+additive",
         "masked-row"]


@pytest.mark.parametrize("S_q,S_k", SELF + CROSS)
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("form", FORMS)
def test_model_matches_plain(S_q, S_k, D, form):
    """The split-TF32 model of dq and of dk/dv against the port's plain
    versions, every form, S_q = S_k and not."""
    q, k, v, do, _, lse, delta, causal, bias, _ = _inputs(
        S_q, S_k, D, form, S_q * 97 + S_k + D)
    args = (q, k, v, do, lse, delta, causal, bias)
    assert _close(tf32x3_dq(*args), KF.flash_attention_dq_plain(*args))
    dk, dv = tf32x3_dkv(*args)
    ref_k, ref_v = KF.flash_attention_dkv_plain(*args)
    assert _close(dk, ref_k) and _close(dv, ref_v)


@pytest.mark.parametrize("S_q,S_k", [(17, 17), (64, 64), (77, 77), (1, 77),
                                     (17, 64), (64, 17)])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("form", ["causal", "non-causal", "bool",
                                  "additive"])
def test_model_matches_pallas_interpret(S_q, S_k, D, form):
    """The split-TF32 model against the JAX package's ``_bwd_call`` in
    interpret mode (tiles of 16 where S is a multiple, else the whole
    sequence), on the same numpy inputs, O and LSE: dq, dk and dv."""
    q, k, v, do, o, lse, delta, causal, bias, mask = _inputs(
        S_q, S_k, D, form, S_q * 89 + S_k + D)
    args = (q, k, v, do, lse, delta, causal, bias)
    got = (tf32x3_dq(*args), *tf32x3_dkv(*args))

    def fold(x):
        return jnp.asarray(x.numpy().transpose(0, 2, 1, 3).reshape(
            B * H, -1, D))

    jbias = None if mask is None else _fold_mask(jnp.asarray(mask), B, H,
                                                 S_q, S_k)
    refs = _bwd_call(fold(q), fold(k), fold(v), fold(o),
                     jnp.asarray(lse.numpy()), fold(do), jbias, causal,
                     1.0 / math.sqrt(D), 16 if S_q % 16 == 0 else S_q,
                     16 if S_k % 16 == 0 else S_k, True)
    for x, ref in zip(got, refs):
        ref = torch.from_numpy(np.array(ref).reshape(B, H, -1, D)
                               ).permute(0, 2, 1, 3)
        assert _close(x, ref)


@pytest.mark.parametrize("S_q,S_k", [(17, 17), (77, 77), (1, 77), (64, 17)])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_model_with_dropout_matches_plain(S_q, S_k, D, causal):
    """Dropout p = 0.1 with the mask handed in (the kernels' Philox mask,
    ``dropout_keep_plain``): dq takes dP z / (1 - p), dv the weights
    p z / (1 - p), against the plain versions with the same seed."""
    q, k, v, do, _, _, _, _, bias, _ = _inputs(S_q, S_k, D, "bool",
                                               S_q + 3 * S_k + D)
    p, seed = 0.1, S_q * 7 + D
    o, lse = KF.flash_attention_plain(q, k, v, causal, bias, dropout_p=p,
                                      seed=seed)
    delta = KF.flash_attention_delta(o, do)
    keep = KF.dropout_keep_plain(seed, B, H, S_q, p, S_k=S_k)
    args = (q, k, v, do, lse, delta, causal, bias)
    form = dict(dropout_p=p, seed=seed)
    assert _close(tf32x3_dq(*args, keep=keep, dropout_p=p),
                  KF.flash_attention_dq_plain(*args, **form))
    dk, dv = tf32x3_dkv(*args, keep=keep, dropout_p=p)
    ref_k, ref_v = KF.flash_attention_dkv_plain(*args, **form)
    assert _close(dk, ref_k) and _close(dv, ref_v)


@pytest.mark.parametrize("fill", [-1e30, float("-inf")])
def test_model_row_masked_everywhere(fill):
    """A query row masked everywhere: by -1e30 each p is exp(0) = 1 in
    both the model and the plain version (the bias is added to the float32
    scores, never split, and s - lse is formed first), by -inf each p is 0
    and the row's dq is 0; dk and dv agree either way."""
    q, k, v, do, _, _, _, _, _, _ = _inputs(40, 40, 64, "non-causal", 5)
    mask = torch.zeros(B, 1, 40, 40)
    mask[0, 0, 3] = fill
    bias = KF.fold_mask(mask, B, H, 40, 40)
    o, lse = KF.flash_attention_plain(q, k, v, False, bias)
    delta = KF.flash_attention_delta(o, do)
    args = (q, k, v, do, lse, delta, False, bias)
    dq = tf32x3_dq(*args)
    assert torch.isfinite(dq).all()
    assert _close(dq, KF.flash_attention_dq_plain(*args))
    if fill == float("-inf"):
        assert torch.all(dq[0, 3] == 0)
    dk, dv = tf32x3_dkv(*args)
    ref_k, ref_v = KF.flash_attention_dkv_plain(*args)
    assert _close(dk, ref_k) and _close(dv, ref_v)


def test_keys_no_query_sees_get_zero():
    """Causal with S_q < S_k: keys past the last query see no query, and
    the model's dk and dv there are exactly 0, as the kernel writes
    them."""
    q, k, v, do, _, lse, delta, _, _, _ = _inputs(17, 64, 64, "causal", 8)
    dk, dv = tf32x3_dkv(q, k, v, do, lse, delta, True)
    assert torch.all(dk[:, 17:] == 0) and torch.all(dv[:, 17:] == 0)


@pytest.mark.parametrize("form", ["causal", "non-causal", "bool"])
def test_one_tf32_product_misses_the_tolerance(form):
    """Why the kernels split: at D = 64 one TF32 product a k-step misses
    2e-5 x max(1, max|ref|) against the plain version in dq and in dk,
    where the three-term split holds it on the same inputs."""
    q, k, v, do, _, lse, delta, causal, bias, _ = _inputs(64, 64, 64, form,
                                                          11)
    args = (q, k, v, do, lse, delta, causal, bias)
    ref_q = KF.flash_attention_dq_plain(*args)
    ref_k, _ = KF.flash_attention_dkv_plain(*args)
    assert not _close(tf32x3_dq(*args, three=False), ref_q)
    assert not _close(tf32x3_dkv(*args, three=False)[0], ref_k)
    assert _close(tf32x3_dq(*args), ref_q)
    assert _close(tf32x3_dkv(*args)[0], ref_k)


def _drift(got, ref):
    """Mean signed error toward ref's sign, over ref's mean size: < 0 when
    the result drifts toward zero."""
    return (((got - ref) * ref.sign()).mean() / ref.abs().mean()).item()


def test_tile_parts_keep_truncation_from_drifting():
    """The tensor cores round toward zero when they add to an accumulator.
    dq sums over S_k keys, dk and dv over S_q queries: chained in one
    accumulator over S = 1024 (128 k-steps of 8), each drifts toward zero
    by more than 4e-6 of its mean size.  With each streamed tile's part
    from a zero accumulator, added rounded to nearest (the kernels' way:
    4 k-steps a part in dq, 2 in dk/dv), the drift stays within 1e-6, an
    eighth of the chained one or less."""
    rs = np.random.RandomState(3)
    S, D = 1024, 64
    q, k = (torch.from_numpy(0.3 * rs.randn(1, S, 1, D).astype(np.float32))
            for _ in range(2))
    v, do = (torch.from_numpy(rs.randn(1, S, 1, D).astype(np.float32) + 0.5)
             for _ in range(2))
    o, lse = KF.flash_attention_plain(q, k, v, False)
    delta = KF.flash_attention_delta(o, do)
    args = (q, k, v, do, lse, delta, False)
    # the exact gradients of these float32 inputs, in float64
    qd, kd, vd, dod = (x.double().permute(0, 2, 1, 3) for x in args[:4])
    p = torch.exp(qd @ kd.transpose(-1, -2) / math.sqrt(D)
                  - lse.double().reshape(1, 1, S, 1))
    ds = p * (dod @ vd.transpose(-1, -2)
              - delta.double().reshape(1, 1, S, 1)) / math.sqrt(D)
    refs = [x.float().permute(0, 2, 1, 3) for x in (
        ds @ kd, ds.transpose(-1, -2) @ qd, p.transpose(-1, -2) @ dod)]
    drift = {}
    for scheme in ("chain", "tile"):
        got = (tf32x3_dq(*args, truncate=True, scheme=scheme),
               *tf32x3_dkv(*args, truncate=True, scheme=scheme))
        drift[scheme] = [_drift(x, ref) for x, ref in zip(got, refs)]
    for chained, tiled in zip(*drift.values()):
        assert chained < -4e-6, drift
        assert abs(tiled) < 1e-6 and abs(tiled) < -chained / 8, drift


def test_tf32_rounds_to_nearest_ties_away():
    """``tf32`` keeps 10 stored mantissa bits, ties away from zero; the
    split recovers x to 2^-22 of its size."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp * 0.49, 1 + ulp * 0.5, 1 + ulp * 0.51,
                      -(1 + ulp * 0.5), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + ulp, 1 + ulp, -(1 + ulp), 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(
        np.float32))
    big, small = split(y)
    assert torch.all((big + small - y).abs() <= y.abs() * 2.0 ** -22)


# -- the kernels' fragment bookkeeping: the permuted contraction index and
# the swizzled shared tiles
def row_of_slot(t, slot):
    """The row of an 8-row k-step that k-slot ``slot`` of lane (g, t)
    reads: slot t is row 2t, slot t + 4 row 2t + 1."""
    return 2 * t + (slot >= 4)


def test_accumulators_are_the_second_products_a_operand():
    """A lane's A entries of the second products (dS K, P^T dO, dS^T Q:
    a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)) read,
    with k-slot t as row 2t and t + 4 as 2t + 1, exactly its own C
    accumulators of the score-shaped tile (c0, c1 row g at columns 2t,
    2t + 1; c2, c3 row g + 8), in the order ``split_acc`` takes them
    (c0, c2, c1, c3); its B slots read rows 2t and 2t + 1; every entry of
    the 16 x 8 tile is some lane's."""
    seen = set()
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        a = [(g, row_of_slot(t, t)), (g + 8, row_of_slot(t, t)),
             (g, row_of_slot(t, t + 4)), (g + 8, row_of_slot(t, t + 4))]
        c = [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]
        assert a == [c[0], c[2], c[1], c[3]]
        assert [row_of_slot(t, t), row_of_slot(t, t + 4)] == [2 * t,
                                                              2 * t + 1]
        seen.update(a)
    assert seen == {(r, col) for r in range(16) for col in range(8)}


def row_floats(D):
    """Floats a shared row of the split-TF32 kernels' tiles (kRowF)."""
    return max(D, 32)


def swz(r):
    """The column swizzle of row r (``swz``): an XOR of 8 x ((r & 3) ^
    ((r >> 2) & 1)) on the column."""
    return ((r & 3) ^ ((r >> 2) & 1)) << 3


def at(D, r, c):
    """Element (r, c) of a swizzled tile (``at``)."""
    return r * row_floats(D) + (c ^ swz(r))


def conflicts(words):
    """Bank conflicts of one shared-memory request: the words each bank
    serves beyond the first (0 when every word of the request lies in its
    own bank)."""
    per_bank = {}
    for w in words:
        per_bank.setdefault(w % 32, set()).add(w)
    return sum(len(ws) - 1 for ws in per_bank.values())


def fragment_reads(D, kind, r0=0):
    """The shared-memory requests of one fragment read, each a list of
    word addresses: ``rows`` (d contracted: lane (g, t) reads the float2 at
    row r0 + g, columns 8kk + 2t, + 1; a 64-bit read is served a half-warp
    at a time) and ``cols`` (rows contracted: lane (g, t) reads row
    r0 + 2t + e at column 8dp + g, one float)."""
    reqs = []
    if kind == "rows":
        for kk in range(D // 8):
            for half in (range(16), range(16, 32)):
                reqs.append([at(D, r0 + (l >> 2), 8 * kk + 2 * (l & 3)) + e
                             for l in half for e in (0, 1)])
    else:
        for dp in range(D // 8):
            for e in (0, 1):
                reqs.append([at(D, r0 + 2 * (l & 3) + e, 8 * dp + (l >> 2))
                             for l in range(32)])
    return reqs


# the conflicts PERF.md states for each fragment read of the kernels
STATED_CONFLICTS = {"rows": 0, "cols": 0}


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["rows", "cols"])
def test_fragment_reads_are_free_of_bank_conflicts(D, kind):
    """Every fragment read of the kernels' swizzled tiles, at every k-step
    or column tile and from every 8-row group of a tile (r0 = 0, 8, ...,
    as dq's K tile, dk/dv's Q and dO tiles and the warps' bands of Q, dO,
    K and V are read): the conflicts PERF.md states (none).  A padded
    layout with one stride cannot do both: 8 mod 32 makes the column reads
    2-way, 4 mod 32 the row reads."""
    for r0 in range(0, 64, 8):
        for req in fragment_reads(D, kind, r0):
            assert conflicts(req) == STATED_CONFLICTS[kind], (D, r0, req)
    # a whole chunk of a cp.async copy stays contiguous and 16-byte aligned
    for r in range(8):
        for c in range(0, D, 4):
            assert [at(D, r, c + i) for i in range(4)] == [
                at(D, r, c) + i for i in range(4)]
            assert at(D, r, c) % 4 == 0

    def padded(ld):
        def at_pad(r, c):
            return r * ld + c
        rows = [[at_pad(l >> 2, 8 * kk + 2 * (l & 3)) + e for l in half
                 for e in (0, 1)] for kk in range(D // 8)
                for half in (range(16), range(16, 32))]
        cols = [[at_pad(2 * (l & 3) + e, 8 * dp + (l >> 2))
                 for l in range(32)] for dp in range(D // 8) for e in (0, 1)]
        return (max(map(conflicts, rows)), max(map(conflicts, cols)))

    assert padded(D + 8)[1] > 0 and padded(D + 4)[0] > 0
