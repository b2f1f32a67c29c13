"""The softmax cross-entropy slice of the port on the CPU, against the JAX
package.

- The kernel module's plain versions (what a CPU tensor takes, and what
  the CUDA kernels are held against on the card) and its autograd
  Function against ``softmax_xent(..., interpret=True)`` — the Pallas
  kernel in interpret mode — and its ``jax.grad``, for V in {2, 512,
  1000}, N in {1, 37}, with ignored rows; tolerances as
  tests/test_pallas_kernels.py's xent parity: rtol = atol = 1e-5 forward,
  rtol 1e-4 / atol 1e-5 for gradients.
- ``ops.fused.softmax_cross_entropy`` over [B, S, V] logits (and the
  strided view ``logits[:, :-1]``) against the reference's.
- ``nn.functional.cross_entropy`` for every reduction, soft labels,
  class weights and ``use_softmax=False`` against
  ``paddle_tpu.nn.functional.cross_entropy``.
- ``GPTForCausalLM.forward(ids, labels)`` against the JAX package's, loss
  and every gradient, at rtol 1e-4 / atol 1e-6 (test_torch_train.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.nn.layer_base import functional_call, state_pytrees
from paddle_tpu.ops import fused as jfused
from paddle_tpu.ops.pallas.softmax_xent import softmax_xent as pallas_xent
from paddle_tpu.tensor import Tensor, unwrap
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
    load_numpy_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.ops.kernels import softmax_xent

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-6)


def _case(n, v, seed, ignore=-100):
    rs = np.random.RandomState(seed)
    z = (2 * rs.randn(n, v)).astype(np.float32)
    lab = rs.randint(0, v, n).astype(np.int64)
    lab[::3] = ignore                          # row 0 and every third
    g = rs.randn(n).astype(np.float32)
    return z, lab, g


@pytest.mark.parametrize("n", [1, 37])
@pytest.mark.parametrize("v", [2, 512, 1000])
def test_plain_versions_vs_pallas(n, v):
    z, lab, g = _case(n, v, n * v)
    ref = pallas_xent(jnp.asarray(z), jnp.asarray(lab, jnp.int32),
                      interpret=True)
    ref_dz = jax.grad(lambda zz: (pallas_xent(
        zz, jnp.asarray(lab, jnp.int32), interpret=True)
        * jnp.asarray(g)).sum())(jnp.asarray(z))
    tz, tl = torch.from_numpy(z), torch.from_numpy(lab)
    loss, lse = softmax_xent.softmax_xent_plain(tz, tl)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref), **FWD_TOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax.nn.logsumexp(jnp.asarray(z), -1)),
        **FWD_TOL)
    dz = softmax_xent.softmax_xent_bwd_plain(tz, tl, lse,
                                             torch.from_numpy(g))
    np.testing.assert_allclose(dz.numpy(), np.asarray(ref_dz), **GRAD_TOL)
    # ignored rows: loss 0 and a gradient of exactly 0
    assert np.all(loss.numpy()[::3] == 0) and np.all(dz.numpy()[::3] == 0)
    # the wrapper takes the plain version for a CPU tensor
    before = softmax_xent.softmax_xent_fwd.launches
    torch.testing.assert_close(softmax_xent.softmax_xent_fwd(tz, tl)[0],
                               loss, rtol=0, atol=0)
    assert softmax_xent.softmax_xent_fwd.launches == before


@pytest.mark.parametrize("n,v", [(1, 2), (37, 1000)])
def test_function_vs_pallas_grad(n, v):
    """The autograd Function (``_sxent``'s custom_vjp): loss in the
    logits' dtype with their leading shape, gradient as jax.grad's."""
    z, lab, g = _case(n, v, 7 + n)
    z3, lab3, g3 = z.reshape(1, n, v), lab.reshape(1, n), g.reshape(1, n)
    ref = pallas_xent(jnp.asarray(z3), jnp.asarray(lab3, jnp.int32),
                      interpret=True)
    ref_dz = jax.grad(lambda zz: (pallas_xent(
        zz, jnp.asarray(lab3, jnp.int32), interpret=True)
        * jnp.asarray(g3)).sum())(jnp.asarray(z3))
    tz = torch.from_numpy(z3).requires_grad_()
    loss = softmax_xent.softmax_xent(tz, torch.from_numpy(lab3)[..., None])
    assert loss.shape == (1, n) and loss.dtype == torch.float32
    loss.backward(torch.from_numpy(g3))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref),
                               **FWD_TOL)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(ref_dz),
                               **GRAD_TOL)


def test_empty_and_bfloat16_and_bad_labels():
    z = torch.zeros(0, 5)
    out = softmax_xent.softmax_xent(z, torch.zeros(0, dtype=torch.long))
    assert out.shape == (0,) and out.dtype == z.dtype
    zb = torch.randn(3, 4, 7).to(torch.bfloat16)
    out = softmax_xent.softmax_xent(zb, torch.ones(3, 4, dtype=torch.long))
    assert out.dtype == torch.bfloat16 and out.shape == (3, 4)
    with pytest.raises(ValueError):
        softmax_xent.softmax_xent(zb, torch.ones(3, 5, dtype=torch.long))
    with pytest.raises(TypeError):
        softmax_xent.softmax_xent(zb, torch.ones(3, 4))


def test_strided_rows_collapse_into_two_strides():
    """``logits[:, :-1]`` of a [B, S, V] tensor: rows r at (r / (S-1)) * S*V
    + (r % (S-1)) * V, read in place; a view whose leading dims do not
    collapse into two is copied."""
    base = torch.randn(3, 5, 7)
    view = base[:, :-1]
    z, inner, so, si = softmax_xent._rows(view)
    assert z.data_ptr() == base.data_ptr() and (inner, so, si) == (4, 35, 7)
    z, inner, so, si = softmax_xent._rows(base)
    assert (inner, so, si) == (15, 0, 7)
    z, inner, so, si = softmax_xent._rows(base[:1, :1])
    assert (inner, so, si) == (1, 0, 0)
    z, _, _, _ = softmax_xent._rows(torch.randn(2, 3, 4, 5)[:, :2, :3])
    assert z.is_contiguous()


def test_fused_softmax_cross_entropy_vs_reference_strided():
    """GPT's next-token form: logits[:, :-1] (a strided view) against
    labels[:, 1:], with ignored positions, forward and gradient."""
    rs = np.random.RandomState(5)
    logits = rs.randn(2, 9, 31).astype(np.float32)
    labels = rs.randint(0, 31, (2, 9))
    labels[0, 3] = -100
    g = rs.randn(2, 8).astype(np.float32)

    def jfn(z):
        return unwrap(jfused.softmax_cross_entropy(
            Tensor(z[:, :-1]), Tensor(jnp.asarray(labels[:, 1:]))))

    ref, vjp = jax.vjp(jfn, jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    loss = fused.softmax_cross_entropy(t[:, :-1],
                                       torch.from_numpy(labels[:, 1:]))
    loss.backward(torch.from_numpy(g))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref),
                               **FWD_TOL)
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), **GRAD_TOL)
    assert np.all(t.grad.numpy()[:, -1] == 0)


CE_CASES = {
    "hard": {},
    "ignore_minus_one": dict(ignore_index=-1),
    "weight": dict(weight=True),
    "no_softmax": dict(use_softmax=False),
    "soft": dict(soft_label=True),
}


def _ce_inputs(kind, seed):
    rs = np.random.RandomState(seed)
    logits = rs.randn(2, 5, 11).astype(np.float32)
    if kind == "soft":
        lab = rs.rand(2, 5, 11).astype(np.float32)
        return logits, lab / lab.sum(-1, keepdims=True), None
    if kind == "no_softmax":
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    lab = rs.randint(0, 11, (2, 5))
    lab[0, 1] = -1 if kind == "ignore_minus_one" else -100
    weight = rs.rand(11).astype(np.float32) + 0.5 if kind == "weight" \
        else None
    return logits, lab, weight


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("kind", sorted(CE_CASES))
def test_cross_entropy_matches_reference(kind, reduction):
    """Every reduction of each label form, loss and gradient.  Hard labels
    with no weight take the kernel route and, as the reference's, a plain
    mean; the composite forms keep the mean over valid entries."""
    logits, lab, weight = _ce_inputs(kind, len(kind) + len(reduction))
    kw = {k: v for k, v in CE_CASES[kind].items() if k != "weight"}

    def jfn(z):
        return unwrap(JF.cross_entropy(
            Tensor(z), Tensor(jnp.asarray(lab)),
            weight=None if weight is None else Tensor(jnp.asarray(weight)),
            reduction=reduction, **kw))

    ref, vjp = jax.vjp(jfn, jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = F.cross_entropy(
        t, torch.from_numpy(lab),
        weight=None if weight is None else torch.from_numpy(weight),
        reduction=reduction, **kw)
    g = np.asarray(np.random.RandomState(3).randn(*np.shape(ref)),
                   np.float32)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **FWD_TOL)
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), **GRAD_TOL)


def test_cross_entropy_refuses_float_hard_labels():
    with pytest.raises(TypeError):
        F.cross_entropy(torch.zeros(2, 3), torch.zeros(2))


def test_activations_match_reference():
    x = np.random.RandomState(2).randn(3, 7).astype(np.float32)
    jx, tx = Tensor(jnp.asarray(x)), torch.from_numpy(x)
    for name in ("tanh", "softmax", "log_softmax", "relu", "gelu"):
        np.testing.assert_allclose(
            getattr(F, name)(tx).numpy(),
            np.asarray(getattr(JF, name)(jx).numpy()), **FWD_TOL,
            err_msg=name)


GPT_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               max_position_embeddings=32, dropout=0.0, attn_dropout=0.0)


def test_gpt_forward_with_labels_matches_jax():
    """(logits, mean(softmax_cross_entropy(logits[:, :-1], labels[:, 1:])))
    and every parameter gradient of that loss."""
    ids = np.random.RandomState(1).randint(0, 64, (2, 16))
    labels = ids.copy()
    labels[1, 5] = -100
    paddle.seed(3)
    jm = JGPTForCausalLM(JGPTConfig(**GPT_CFG))
    jm.train()
    params, buffers = state_pytrees(jm)

    def loss_fn(p):
        (logits, loss), _ = functional_call(
            jm, p, (paddle.to_tensor(ids, "int64"),),
            {"labels": paddle.to_tensor(labels, "int64")}, buffers=buffers)
        return unwrap(loss), unwrap(logits)

    (ref_loss, ref_logits), ref_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    model = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu").train()
    load_numpy_state(model, {k: np.asarray(v) for k, v in params.items()})
    logits, loss = model(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    assert loss.shape == () and logits.shape == (2, 16, 64)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), **MODEL_TOL)
    np.testing.assert_allclose(loss.item(), float(ref_loss), **MODEL_TOL)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(ref_grads[name]),
                                   err_msg=name, **MODEL_TOL)
