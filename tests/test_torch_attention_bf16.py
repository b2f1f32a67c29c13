"""bf16 attention on the CPU: the port's plain versions (what the
tensor-core kernels are held against on the card) against the JAX
package's Pallas kernels (`_fwd_call`, `_bwd_call`) in interpret mode, on
the same bf16 inputs made from a numpy seed.

Tolerance 2**-6 x max(1, max|ref|), the card tests' bf16 limit.  The two
sides differ by more than summation order: the reference rounds p and ds to
bf16 before the second product of each tile (as the tensor-core kernels
do), the plain versions keep them in float32, and each side rounds its
result to bf16 once (an ulp is 2**-8 of the value, 2**-7 at most of the top
binade).  The rounding of p and ds is relative, 2**-9 an entry, and is
averaged over the keys or queries of a sum, so it stays far inside the
limit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import _bwd_call, _fwd_call
from paddle_tpu_torch.ops.kernels import flash_attention as KF

B, H, D = 2, 3, 16
BLOCK = 8          # Pallas tiles: several per sequence, so every loop walks
FORMS = ["causal", "padding", "causal+additive"]


def _fold(x):
    """[B, S, H, D] torch bf16 -> [B*H, S, D] jax bf16, as `_mha` folds."""
    a = x.float().numpy().transpose(0, 2, 1, 3).reshape(B * H, -1, D)
    return jnp.asarray(a, dtype=jnp.bfloat16)


def _unfold(y):
    """[B*H, S, D] jax -> [B, S, H, D] float32 numpy."""
    a = np.asarray(y.astype(jnp.float32))
    return a.reshape(B, H, -1, D).transpose(0, 2, 1, 3)


def _case(form, S, seed):
    """bf16 q, k, v, dO; causal flag; the port's bias view and the
    reference's folded [B, S, S] bias (one plane a batch row)."""
    rs = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rs.randn(B, S, H, D).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    causal = form.startswith("causal")
    mask = None
    if form == "padding":            # key padding; key 0 stays visible
        lens = rs.randint(1, S + 1, B)
        mask = torch.from_numpy(np.arange(S)[None, :] < lens[:, None])
        mask = mask[:, None, None, :]
    elif form == "causal+additive":
        mask = torch.from_numpy(rs.randn(B, 1, S, S).astype(np.float32))
    bias = jbias = None
    if mask is not None:
        bias = KF.fold_mask(mask, B, H, S, S)
        jbias = jnp.asarray(bias[:, 0].contiguous().numpy())
    return q, k, v, do, causal, bias, jbias


def _check(got, ref, what):
    ref = np.asarray(ref, dtype=np.float32)
    tol = 2 ** -6 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got.float().numpy() - ref).max())
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("S", [16, 32])
@pytest.mark.parametrize("form", FORMS)
def test_bf16_forward_plain_vs_pallas(form, S):
    q, k, v, _, causal, bias, jbias = _case(form, S, seed=S)
    scale = D ** -0.5
    ref_o, ref_lse = _fwd_call(_fold(q), _fold(k), _fold(v), jbias, causal,
                               scale, BLOCK, BLOCK, True)
    assert ref_o.dtype == jnp.bfloat16
    out, lse = KF.flash_attention_plain(q, k, v, causal, bias)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _check(out, _unfold(ref_o), "out")
    _check(lse, np.asarray(ref_lse), "lse")


@pytest.mark.parametrize("S", [16, 32])
@pytest.mark.parametrize("form", FORMS)
def test_bf16_backward_plain_vs_pallas(form, S):
    """dk/dv (and dq) of the plain versions, from the plain forward's O and
    LSE, against `_bwd_call` from the reference's own forward."""
    q, k, v, do, causal, bias, jbias = _case(form, S, seed=100 + S)
    scale = D ** -0.5
    jq, jk, jv, jdo = (_fold(t) for t in (q, k, v, do))
    ref_o, ref_lse = _fwd_call(jq, jk, jv, jbias, causal, scale, BLOCK,
                               BLOCK, True)
    ref = _bwd_call(jq, jk, jv, ref_o, ref_lse, jdo, jbias, causal, scale,
                    BLOCK, BLOCK, True)
    out, lse = KF.flash_attention_plain(q, k, v, causal, bias)
    delta = KF.flash_attention_delta(out, do)
    dk, dv = KF.flash_attention_dkv_plain(q, k, v, do, lse, delta, causal,
                                          bias)
    dq = KF.flash_attention_dq_plain(q, k, v, do, lse, delta, causal, bias)
    assert dk.dtype == dv.dtype == torch.bfloat16
    for got, r, what in zip((dq, dk, dv), ref, ("dq", "dk", "dv")):
        assert r.dtype == jnp.bfloat16
        _check(got, _unfold(r), what)
