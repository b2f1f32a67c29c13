"""The port's kernel modules on the CPU: each plain PyTorch version (what
a CPU tensor takes, and the reference the CUDA kernel is held against on
the card) against the JAX package's Pallas kernel in interpret mode, and
against the ops/fused.py composite where the Pallas kernel refuses the
shape.

Tolerance: float32 on both sides, atol = rtol = 1e-5 — the two sides sum
in different orders (and the paged kernel scales q before the dot where
the composite scales the scores), nothing else differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import fused as jfused
from paddle_tpu.ops.pallas.bias_gelu import bias_gelu as pallas_bias_gelu
from paddle_tpu.ops.pallas.flash_attention import \
    flash_attention as pallas_flash
from paddle_tpu.ops.pallas.layer_norm import layer_norm as pallas_layer_norm
from paddle_tpu.ops.pallas.paged_attention import \
    paged_decode_attention as pallas_paged
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.ops.kernels import (bias_gelu, flash_attention,
                                          layer_norm, paged_attention)

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# widths on both sides of the CUDA kernel's split (16-byte vectors: N a
# multiple of 8 bf16 or 4 float32, at most 2048 or 1024; lanes filled or
# partly filled) and the serving path's R = 8
@pytest.mark.parametrize("rows,n", [(8, 48), (16, 768), (8, 768), (8, 7),
                                    (8, 100), (16, 776), (8, 1024),
                                    (8, 1028), (8, 2048), (8, 2056)])
def test_layer_norm_plain_vs_pallas(rows, n):
    rs = np.random.RandomState(rows)
    x = rs.randn(rows, n).astype(np.float32) * 3 + 1
    w = (1 + 0.1 * rs.randn(n)).astype(np.float32)
    b = (0.1 * rs.randn(n)).astype(np.float32)
    ref = pallas_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            1e-5, interpret=True)
    got = layer_norm.layer_norm_plain(_t(x), _t(w), _t(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", [(3, 48), (1, 5, 48), (3, 7), (5, 776),
                                   (1, 7, 2056)])
def test_layer_norm_plain_vs_composite_untileable_rows(shape):
    """Row counts the Pallas kernel refuses (not a multiple of 8): the
    port takes any R — held against the XLA composite."""
    rs = np.random.RandomState(1)
    x = rs.randn(*shape).astype(np.float32)
    w = (1 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rs.randn(shape[-1])).astype(np.float32)
    ref = jfused.layer_norm(Tensor(jnp.asarray(x)), Tensor(jnp.asarray(w)),
                            Tensor(jnp.asarray(b)), 1e-5)
    got = fused.layer_norm(_t(x), _t(w), _t(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.numpy()), **TOL)


@pytest.mark.parametrize("rows,n", [(8, 192), (16, 3072)])
def test_bias_gelu_plain_vs_pallas(rows, n):
    rs = np.random.RandomState(rows)
    x = rs.randn(rows, n).astype(np.float32) * 2
    b = (0.5 * rs.randn(n)).astype(np.float32)
    ref = pallas_bias_gelu(jnp.asarray(x), jnp.asarray(b), interpret=True)
    got = bias_gelu.bias_gelu_plain(_t(x), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", [(3, 192), (1, 7, 192)])
def test_bias_gelu_plain_vs_composite_untileable_rows(shape):
    rs = np.random.RandomState(2)
    x = rs.randn(*shape).astype(np.float32) * 2
    b = (0.5 * rs.randn(shape[-1])).astype(np.float32)
    ref = jfused.bias_gelu(Tensor(jnp.asarray(x)), Tensor(jnp.asarray(b)),
                           training=False)
    got = fused.bias_gelu(_t(x), _t(b), training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.numpy()), **TOL)


@pytest.mark.parametrize("S", [16, 64])
def test_flash_attention_plain_vs_pallas_causal(S):
    """Causal, unmasked — the prefill form.  The port reads q/k/v as the
    strided slices of one fused [B, S, 3, H, D] projection, as the model
    hands them over."""
    rs = np.random.RandomState(S)
    B, H, D = 2, 3, 16
    qkv = rs.randn(B, S, 3, H, D).astype(np.float32)
    q, k, v = (qkv[:, :, i] for i in range(3))
    ref = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True, interpret=True)
    tq = _t(qkv)
    out, lse = flash_attention.flash_attention_plain(
        tq[:, :, 0], tq[:, :, 1], tq[:, :, 2])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert lse.shape == (B * H, S)
    # the wrapper takes the plain version for a CPU tensor
    via_fused = fused.scaled_dot_product_attention(
        tq[:, :, 0], tq[:, :, 1], tq[:, :, 2], is_causal=True,
        training=False)
    np.testing.assert_array_equal(via_fused.numpy(), out.numpy())


def test_flash_attention_plain_vs_composite_short_sequence():
    """S = 5 is below the Pallas kernel's 8-row minimum; the port takes
    any S >= 1 — held against the XLA composite."""
    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(1, 5, 2, 16).astype(np.float32) for _ in range(3))
    ref = jfused.scaled_dot_product_attention(
        Tensor(jnp.asarray(q)), Tensor(jnp.asarray(k)),
        Tensor(jnp.asarray(v)), is_causal=True, training=False)
    out, _ = flash_attention.flash_attention_plain(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.numpy()), **TOL)


def test_fused_attention_refuses_unported_forms():
    """Dropout in training is the one form left unported (ROADMAP B7);
    cross-attention (S_q != S_k) waits for the decoder slice."""
    x = torch.zeros(1, 4, 2, 16)
    for causal in (False, True):
        with pytest.raises(NotImplementedError):
            fused.scaled_dot_product_attention(x, x, x, dropout_p=0.1,
                                               is_causal=causal,
                                               training=True)
    with pytest.raises(NotImplementedError):
        fused.scaled_dot_product_attention(x, torch.zeros(1, 6, 2, 16),
                                           torch.zeros(1, 6, 2, 16))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", [None, "bool", "additive"])
def test_fused_attention_forms_match_composite(causal, mask):
    """Every form but dropout-in-training now runs: non-causal, causal,
    bool and additive masks, and dropout outside training — held against
    the reference's XLA composite, which adds an additive mask and (for
    rows with a visible key) gives a bool mask's -1e30 replace the same
    softmax."""
    rs = np.random.RandomState(11)
    B, S, H, D = 2, 9, 2, 16
    q, k, v = (rs.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    m = None
    if mask == "bool":
        m = rs.rand(B, 1, S, S) > 0.3
        m[..., 0] = True                       # every row sees key 0
    elif mask == "additive":
        m = rs.randn(B, H, S, S).astype(np.float32)
    jm = None if m is None else Tensor(jnp.asarray(m))
    ref = jfused.scaled_dot_product_attention(
        Tensor(jnp.asarray(q)), Tensor(jnp.asarray(k)),
        Tensor(jnp.asarray(v)), attn_mask=jm, dropout_p=0.1,
        is_causal=causal, training=False)
    got = fused.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), attn_mask=None if m is None else _t(m),
        dropout_p=0.1, is_causal=causal, training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.numpy()), **TOL)


def _paged_case(ps, seed=8):
    """Ragged rows: two pages with pos mid-page, a full table, a single
    page, pos exactly at a page boundary, and an inactive lane whose row
    is all -1."""
    rs = np.random.RandomState(seed)
    slots, pps, nh, hd, num_pages = 5, 4, 2, 16, 14
    q = rs.randn(slots, nh, hd).astype(np.float32)
    kp = rs.randn(num_pages, ps, nh, hd).astype(np.float32)
    vp = rs.randn(num_pages, ps, nh, hd).astype(np.float32)
    rows = np.array([[2, 5, -1, -1],
                     [7, 1, 3, 9],
                     [4, -1, -1, -1],
                     [6, 8, -1, -1],
                     [-1, -1, -1, -1]], np.int32)
    pos = np.array([ps + ps // 2 - 1, 4 * ps - 3, ps // 2, 2 * ps - 1, 0],
                   np.int32)
    return q, kp, vp, rows, pos, pps * ps


def _dense_composite(q, kp, vp, rows, pos, seq_cap):
    """gpt.decode_pages' dense-gather composite (the JAX CPU path)."""
    slots, nh, hd = q.shape
    num_pages, ps = kp.shape[0], kp.shape[1]
    gidx = jnp.clip(rows, 0, num_pages - 1)
    kg = jnp.asarray(kp)[gidx].reshape(slots, -1, nh, hd)[:, :seq_cap]
    vg = jnp.asarray(vp)[gidx].reshape(slots, -1, nh, hd)[:, :seq_cap]
    s = jnp.einsum("bnd,bsnd->bns", q, kg) * (1.0 / float(hd) ** 0.5)
    valid = jnp.arange(seq_cap)[None, :] <= pos[:, None]
    s = jnp.where(valid[:, None, :], s, jnp.finfo(s.dtype).min)
    p = jnp.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.asarray(jnp.einsum("bns,bsnd->bnd", p, vg))


def test_paged_decode_plain_vs_pallas():
    q, kp, vp, rows, pos, seq_cap = _paged_case(ps=8)
    ref = pallas_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(rows), jnp.asarray(pos), seq_cap,
                       interpret=True)
    got = paged_attention.paged_decode_attention_plain(
        _t(q), _t(kp), _t(vp), _t(rows), _t(pos), seq_cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the inactive lane reads nothing: 0, never NaN (as the Pallas kernel)
    assert np.all(got.numpy()[-1] == 0.0)


def test_paged_decode_plain_vs_pallas_ragged_lengths():
    """Lanes of very different lengths, as the serving table has them: one
    lane near the full 256-token extent, one of 4 tokens, one inactive
    (row all -1), one mid-length ending mid-page, one at a page boundary;
    page tables scattered over the pool."""
    rs = np.random.RandomState(11)
    ps, pps, nh, hd, num_pages = 8, 32, 2, 16, 80
    pos = np.array([250, 3, 0, 100, 127], np.int32)
    slots = len(pos)
    perm = rs.permutation(num_pages).astype(np.int32)
    rows = np.full((slots, pps), -1, np.int32)
    used = 0
    for lane in (0, 1, 3, 4):
        n = pos[lane] // ps + 1
        rows[lane, :n] = perm[used:used + n]
        used += n
    q = rs.randn(slots, nh, hd).astype(np.float32)
    kp = rs.randn(num_pages, ps, nh, hd).astype(np.float32)
    vp = rs.randn(num_pages, ps, nh, hd).astype(np.float32)
    ref = pallas_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(rows), jnp.asarray(pos), pps * ps,
                       interpret=True)
    got = paged_attention.paged_decode_attention_plain(
        _t(q), _t(kp), _t(vp), _t(rows), _t(pos), pps * ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert np.all(got.numpy()[2] == 0.0)


@pytest.mark.parametrize("ps", [8, 4])
def test_paged_decode_plain_vs_dense_composite(ps):
    """Lanes with mapped pages match the dense-gather composite; page size
    4 is below the Pallas kernel's minimum of 8 and is taken too.  The
    all -1 lane is left out: the composite gathers clipped garbage for
    it, which the engine never reads."""
    q, kp, vp, rows, pos, seq_cap = _paged_case(ps)
    ref = _dense_composite(q, kp, vp, rows, pos, seq_cap)
    got = fused.paged_decode_attention(
        _t(q)[:, None], _t(kp), _t(vp), _t(rows), _t(pos), seq_cap)[:, 0]
    np.testing.assert_allclose(got.numpy()[:-1], ref[:-1], **TOL)
