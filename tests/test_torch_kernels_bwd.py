"""The backward half of the port's kernel modules on the CPU: each
autograd Function (forward and backward plain versions, as a CPU tensor
takes them) against ``jax.vjp`` of the JAX package's Pallas kernel in
interpret mode, and against the vjp of the ops/fused.py composite where
the Pallas kernel refuses the shape.  The chunked fused LM-head cross
entropy is held against the JAX package's, forward and backward, with a
chunk smaller than the vocab and a ragged last chunk.

Tolerance: float32 on both sides, atol = rtol = 1e-5 — the two sides sum
in different orders, nothing else differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import fused as jfused
from paddle_tpu.ops.pallas.bias_gelu import _bg_bwd
from paddle_tpu.ops.pallas.bias_gelu import bias_gelu as pallas_bias_gelu
from paddle_tpu.ops.pallas.flash_attention import \
    flash_attention as pallas_flash
from paddle_tpu.ops.pallas.layer_norm import layer_norm as pallas_layer_norm
from paddle_tpu.tensor import Tensor, unwrap
from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.ops.kernels import (bias_gelu, flash_attention,
                                          layer_norm)

TOL = dict(atol=1e-5, rtol=1e-5)


def _grads(fn, arrays, cotangent):
    """Outputs and input gradients of the port's ``fn`` under autograd,
    from numpy inputs and a numpy cotangent."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
          for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(cotangent))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_vjp(fn, arrays, cotangent):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(g) for g in
                             vjp(jnp.asarray(cotangent))]


def _assert_all_close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **TOL)


def _composite(fn):
    """A JAX-package op on Tensors, as a function of raw arrays."""
    return lambda *xs: unwrap(fn(*[Tensor(x) for x in xs]))


@pytest.mark.parametrize("rows,n", [(8, 192), (16, 3072)])
def test_bias_gelu_bwd_vs_pallas_vjp(rows, n):
    rs = np.random.RandomState(rows + 1)
    x = rs.randn(rows, n).astype(np.float32) * 2
    b = (0.5 * rs.randn(n)).astype(np.float32)
    dy = rs.randn(rows, n).astype(np.float32)
    ref_out, ref = _jax_vjp(
        lambda x_, b_: pallas_bias_gelu(x_, b_, interpret=True), (x, b), dy)
    out, got = _grads(bias_gelu.bias_gelu, (x, b), dy)
    np.testing.assert_allclose(out, ref_out, **TOL)
    _assert_all_close(got, ref)
    # the plain backward alone is the Function's dx
    dx = bias_gelu.bias_gelu_bwd_plain(torch.from_numpy(x),
                                       torch.from_numpy(b),
                                       torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), ref[0], **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,n", [(16, 192), (64, 3072)])
def test_bias_gelu_db_vs_reference_bwd(dtype, rows, n):
    """db, dx's row-sum accumulated in float32 without a float32 copy of
    dx, against the reference's ``_bg_bwd`` db (its Pallas dx in interpret
    mode, ``jnp.sum(dx.astype(float32), axis=0)``) from the same inputs.
    float32: atol = rtol = 1e-5 (summation order); bfloat16: 2**-6 x
    max(1, max|ref|) (both round a float32 sum of bf16 dx once)."""
    rs = np.random.RandomState(rows + n)
    x = (rs.randn(rows, n) * 2).astype(np.float32)
    b = (0.5 * rs.randn(n)).astype(np.float32)
    dy = rs.randn(rows, n).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    _, ref = _bg_bwd(True, (jnp.asarray(x, jdt), jnp.asarray(b, jdt)),
                     jnp.asarray(dy, jdt))
    ref = np.asarray(ref.astype(jnp.float32))
    dx = bias_gelu.bias_gelu_bwd_plain(*(torch.from_numpy(a).to(tdt)
                                         for a in (x, b, dy)))
    got = bias_gelu.bias_gelu_db(dx)
    assert got.dtype == torch.float32 and got.shape == (n,)
    got = got.to(tdt).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, **TOL)
    else:
        tol = 2 ** -6 * max(1.0, np.abs(ref).max())
        assert np.abs(got - ref).max() <= tol


@pytest.mark.parametrize("shape", [(3, 192), (1, 7, 192)])
def test_bias_gelu_bwd_vs_composite_untileable_rows(shape):
    """Row counts the Pallas kernel refuses: held against the vjp of the
    XLA composite."""
    rs = np.random.RandomState(3)
    x = rs.randn(*shape).astype(np.float32) * 2
    b = (0.5 * rs.randn(shape[-1])).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    ref_out, ref = _jax_vjp(_composite(
        lambda x_, b_: jfused.bias_gelu(x_, b_, training=False)), (x, b), dy)
    out, got = _grads(lambda x_, b_: fused.bias_gelu(x_, b_, training=False),
                      (x, b), dy)
    np.testing.assert_allclose(out, ref_out, **TOL)
    _assert_all_close(got, ref)


def _ln_inputs(shape, seed):
    rs = np.random.RandomState(seed)
    n = shape[-1]
    return (rs.randn(*shape).astype(np.float32) * 3 + 1,
            (1 + 0.1 * rs.randn(n)).astype(np.float32),
            (0.1 * rs.randn(n)).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("rows,n", [(8, 48), (16, 768)])
def test_layer_norm_bwd_vs_pallas_vjp(rows, n):
    x, w, b, dy = _ln_inputs((rows, n), rows)
    ref_out, ref = _jax_vjp(
        lambda x_, w_, b_: pallas_layer_norm(x_, w_, b_, 1e-5,
                                             interpret=True), (x, w, b), dy)
    out, got = _grads(lambda x_, w_, b_: layer_norm.layer_norm(x_, w_, b_),
                      (x, w, b), dy)
    np.testing.assert_allclose(out, ref_out, **TOL)
    _assert_all_close(got, ref)


@pytest.mark.parametrize("shape", [(3, 48), (1, 5, 48)])
def test_layer_norm_bwd_vs_composite_untileable_rows(shape):
    x, w, b, dy = _ln_inputs(shape, 7)
    ref_out, ref = _jax_vjp(_composite(
        lambda x_, w_, b_: jfused.layer_norm(x_, w_, b_, 1e-5)),
        (x, w, b), dy)
    out, got = _grads(lambda x_, w_, b_: fused.layer_norm(x_, w_, b_, 1e-5),
                      (x, w, b), dy)
    np.testing.assert_allclose(out, ref_out, **TOL)
    _assert_all_close(got, ref)


def test_layer_norm_function_saves_the_forward_statistics():
    """The Function's residuals are the forward's float32 row mean and
    rstd [rows], as the kernel writes them on the card."""
    x, w, b, _ = _ln_inputs((2, 3, 48), 9)
    xt = torch.from_numpy(x).requires_grad_()
    y = layer_norm.layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b))
    _, _, mean, rstd = y.grad_fn.saved_tensors
    xf = x.reshape(-1, 48).astype(np.float64)
    np.testing.assert_allclose(mean.numpy(), xf.mean(-1), **TOL)
    np.testing.assert_allclose(rstd.numpy(),
                               1 / np.sqrt(xf.var(-1) + 1e-5), **TOL)


@pytest.mark.parametrize("S", [16, 32])
def test_flash_attention_bwd_vs_pallas_vjp(S):
    """Causal, unmasked; the Pallas kernel runs its dq and dk/dv kernels
    with block_q = block_k = 8 so the backward walks several tiles.  The
    port's packed Function (the model's path) returns the gradient of the
    fused [B, S, 3, H, D] projection; the q/k/v Function the three
    slices; the plain backward the same from the forward's O and LSE."""
    rs = np.random.RandomState(S)
    B, H, D = 2, 3, 16
    qkv = rs.randn(B, S, 3, H, D).astype(np.float32)
    do = rs.randn(B, S, H, D).astype(np.float32)
    ref_out, ref = _jax_vjp(
        lambda q, k, v: pallas_flash(q, k, v, causal=True, block_q=8,
                                     block_k=8, interpret=True),
        [qkv[:, :, i] for i in range(3)], do)
    out, (g,) = _grads(fused.packed_causal_attention, (qkv,), do)
    np.testing.assert_allclose(out, ref_out, **TOL)
    _assert_all_close([g[:, :, i] for i in range(3)], ref)
    out, got = _grads(
        lambda q, k, v: fused.scaled_dot_product_attention(
            q, k, v, is_causal=True), [qkv[:, :, i] for i in range(3)], do)
    _assert_all_close(got, ref)
    tq = torch.from_numpy(qkv)
    o, lse = flash_attention.flash_attention_plain(*tq.unbind(2))
    plain = flash_attention.flash_attention_bwd_plain(
        *tq.unbind(2), o, lse, torch.from_numpy(do))
    _assert_all_close([t.numpy() for t in plain], ref)


def test_flash_attention_bwd_vs_composite_short_sequence():
    """S = 13 is not a multiple of any Pallas block: held against the vjp
    of the XLA composite."""
    rs = np.random.RandomState(13)
    q, k, v, do = (rs.randn(2, 13, 2, 16).astype(np.float32)
                   for _ in range(4))
    ref_out, ref = _jax_vjp(_composite(
        lambda q_, k_, v_: jfused.scaled_dot_product_attention(
            q_, k_, v_, is_causal=True, training=False)), (q, k, v), do)
    out, got = _grads(
        lambda q_, k_, v_: fused.scaled_dot_product_attention(
            q_, k_, v_, is_causal=True, training=False), (q, k, v), do)
    np.testing.assert_allclose(out, ref_out, **TOL)
    _assert_all_close(got, ref)


def test_flash_attention_plain_dq_dkv_split():
    """The plain dq and dk/dv versions (what each kernel is held against
    on the card) together are the plain backward, and write in place."""
    rs = np.random.RandomState(4)
    qkv = torch.from_numpy(rs.randn(1, 9, 3, 2, 16).astype(np.float32))
    q, k, v = qkv.unbind(2)
    o, lse = flash_attention.flash_attention_plain(q, k, v)
    do = torch.from_numpy(rs.randn(1, 9, 2, 16).astype(np.float32))
    delta = flash_attention.flash_attention_delta(o, do)
    assert delta.shape == (2, 9)
    grad = torch.empty_like(qkv)
    flash_attention.flash_attention_bwd(q, k, v, o, lse, do,
                                        out=grad.unbind(2))
    dq = flash_attention.flash_attention_dq_plain(q, k, v, do, lse, delta)
    dk, dv = flash_attention.flash_attention_dkv_plain(q, k, v, do, lse,
                                                       delta)
    for got, ref in zip(grad.unbind(2), (dq, dk, dv)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [16, 37, 64])
def test_fused_linear_cross_entropy_vs_jax(chunk):
    """Chunks of 16 over a vocab of 37 leave a ragged last chunk of 5; a
    chunk of 37 is one exact chunk; 64 is one padded chunk."""
    rs = np.random.RandomState(chunk)
    h = rs.randn(2, 6, 24).astype(np.float32)
    w = (0.3 * rs.randn(24, 37)).astype(np.float32)
    labels = rs.randint(0, 37, (2, 6))
    g = rs.randn(2, 6).astype(np.float32)
    ref_out, ref = _jax_vjp(_composite(
        lambda h_, w_: jfused.fused_linear_cross_entropy(
            h_, w_, Tensor(jnp.asarray(labels)), chunk_size=chunk)),
        (h, w), g)
    out, got = _grads(lambda h_, w_: fused.fused_linear_cross_entropy(
        h_, w_, torch.from_numpy(labels), chunk_size=chunk), (h, w), g)
    assert out.shape == (2, 6) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref_out, **TOL)
    _assert_all_close(got, ref)


def test_functions_build_no_graph_under_no_grad():
    """Serving runs under torch.no_grad(): the wrappers return plain
    tensors with no graph, as before the Functions existed."""
    x = torch.randn(3, 8, requires_grad=True)
    w = torch.ones(8, requires_grad=True)
    qkv = torch.randn(1, 5, 3, 2, 16, requires_grad=True)
    with torch.no_grad():
        outs = (layer_norm.layer_norm(x, w, w), bias_gelu.bias_gelu(x, w),
                fused.packed_causal_attention(qkv))
    assert all(o.grad_fn is None and not o.requires_grad for o in outs)


# ---------------------------------------------------------------------------
# the non-causal and masked forms of flash attention
# ---------------------------------------------------------------------------
# tolerances of tests/test_pallas_kernels.py's masked-attention parity
MASK_FWD_TOL = dict(rtol=1e-4, atol=1e-5)
MASK_GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _mask_case(kind, causal, B=2, S=16, H=3, seed=0):
    """None, bool key padding [B, 1, 1, S], additive [B, 1, S, S],
    per-head [B, H, S, S] and 2-D [S, S].  Causal bool masks keep key 0
    visible (a causal row masked everywhere depends on the Pallas tiles);
    non-causal, batch row 1 is masked everywhere."""
    rs = np.random.RandomState(seed)
    if kind is None:
        return None
    if kind == "bool":
        m = rs.rand(B, 1, 1, S) > 0.3
        m[..., 0] = True
        if not causal:
            m[1] = False
        return m
    shape = {"additive": (B, 1, S, S), "per_head": (B, H, S, S),
             "2d": (S, S)}[kind]
    return rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", [None, "bool", "additive", "per_head",
                                  "2d"])
def test_masked_attention_vs_pallas_vjp(causal, kind):
    """Forward and gradients of the port's ``attention`` (the reference's
    public ``flash_attention``: ``_mha``/``_mha_masked``) against the
    Pallas kernel in interpret mode with 8-wide tiles, and the plain
    forward and backward, for causal x every mask form."""
    B, S, H, D = 2, 16, 3, 16
    rs = np.random.RandomState(21)
    q, k, v, do = (rs.randn(B, S, H, D).astype(np.float32)
                   for _ in range(4))
    m = _mask_case(kind, causal)
    jm = None if m is None else jnp.asarray(m)
    ref_out, ref = _jax_vjp(
        lambda q_, k_, v_: pallas_flash(q_, k_, v_, causal=causal, mask=jm,
                                        block_q=8, block_k=8,
                                        interpret=True), (q, k, v), do)
    tm = None if m is None else torch.from_numpy(m)
    out, got = _grads(lambda q_, k_, v_: flash_attention.attention(
        q_, k_, v_, causal=causal, mask=tm), (q, k, v), do)
    np.testing.assert_allclose(out, ref_out, **MASK_FWD_TOL)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **MASK_GRAD_TOL)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    bias = None if tm is None else flash_attention.fold_mask(tm, B, H, S, S)
    o, lse = flash_attention.flash_attention_plain(tq, tk, tv, causal, bias)
    plain = flash_attention.flash_attention_bwd_plain(
        tq, tk, tv, o, lse, torch.from_numpy(do), causal, bias)
    for g, r in zip(plain, ref):
        np.testing.assert_allclose(g.numpy(), r, **MASK_GRAD_TOL)


def test_fold_mask_broadcasts_without_copying_and_refuses_bad_shapes():
    """A bool [B, 1, 1, S] mask becomes 0 / -1e30 float32, expanded to
    [B, H, S, S] with stride 0 over the head and query dims; a mask that
    does not broadcast, or of rank > 4, raises."""
    m = torch.tensor([[True, True, False]])[:, None, None, :]
    bias = flash_attention.fold_mask(m, 1, 4, 3, 3)
    assert bias.shape == (1, 4, 3, 3) and bias.dtype == torch.float32
    assert bias.stride()[1:3] == (0, 0)
    assert torch.equal(bias[0, 2, 1],
                       torch.tensor([0.0, 0.0, -1e30], dtype=torch.float32))
    x = torch.zeros(1, 3, 4, 16)
    with pytest.raises(ValueError):
        flash_attention.attention(x, x, x, mask=torch.zeros(3, 1, 3, 3))
    with pytest.raises(ValueError):
        flash_attention.attention(x, x, x, mask=torch.zeros(1, 1, 1, 3, 3))


def test_mask_gets_no_gradient():
    """The mask is data: its cotangent is zero (None in autograd)."""
    q = torch.randn(1, 5, 2, 16, requires_grad=True)
    m = torch.randn(1, 1, 5, 5, requires_grad=True)
    flash_attention.attention(q, q, q, mask=m).sum().backward()
    assert q.grad is not None and m.grad is None
