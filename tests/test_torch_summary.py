"""``summary``, ``flops`` and ``Model.parameters`` of the port against the
JAX package's, on the CPU.

- ``summary``: the printed table equals the reference's line for line
  (Linear, LeNet, a small GPT and a small BERT), the return value too; for
  resnet18 (batch norm) the lines are equal as a set and the totals equal.
- ``flops``: ``Linear(8, 4)`` at [2, 8] equals the reference's count
  exactly and LeNet at [1, 1, 28, 28] is within 5 % of it.  The
  reference's ``flops`` feeds float32 zeros, which its integer-id GPT and
  BERT refuse, so for them its compiled ``cost_analysis`` is read as
  ``flops`` reads it, on int32 ids.  On the CPU that count expands GeLU's
  ``erfc`` into a polynomial (64 flops an element) and counts fused
  producers once a consumer, where the convention counts a transcendental
  as 0 (ROADMAP.md §C records both numbers).  The port is held within 5 %
  of the reference's program counted by the convention (its jaxpr), and,
  for the GPT, within 5 % of the compiled count once GeLU is counted by
  each side's own rule.
- each fused op's analytic count equals the counter's count of its plain
  version's ops, spelled out (so the card, where the kernels run, and the
  CPU give one count); the counter is suspended inside a fused op and off
  outside a count; per-sublayer ``training`` flags come back.
- ``Model.parameters()`` is the network's list.
"""
import contextlib
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.nn.layer_base import functional_call, state_pytrees
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     GPTConfig, GPTForCausalLM)
from paddle_tpu_torch.ops.kernels import bias_gelu as bg
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import layer_norm as ln
from paddle_tpu_torch.ops.kernels import softmax_xent as sx
from paddle_tpu_torch.utils import flops as tflops
from paddle_tpu_torch.vision import models as tmodels

GPT = dict(vocab_size=211, hidden_size=48, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0, attn_dropout=0.0)
BERT = dict(vocab_size=60, hidden_size=16, num_layers=2, num_heads=2,
            intermediate_size=32, max_position_embeddings=16, dropout=0.0)
GPT_IDS, BERT_IDS = (2, 16), (2, 12)
FLOPS_RTOL = 0.05


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue().splitlines(), out


def _pair(name):
    paddle.seed(0)
    if name == "linear":
        return paddle.nn.Linear(8, 4), ptt.nn.Linear(8, 4)
    if name == "lenet":
        return jmodels.LeNet(), tmodels.LeNet(device="cpu")
    if name == "gpt":
        return (JGPT(JGPTConfig(**GPT)),
                GPTForCausalLM(GPTConfig(**GPT), device="cpu"))
    if name == "bert":
        return (JBert(JBertConfig(**BERT)),
                BertForPretraining(BertConfig(**BERT), device="cpu"))
    return (jmodels.resnet18(num_classes=10),
            tmodels.resnet18(num_classes=10, device="cpu"))


@pytest.mark.parametrize("name", ["linear", "lenet", "gpt", "bert"])
def test_summary_text_equals_the_reference_line_for_line(name):
    ref, ours = _pair(name)
    want, want_ret = _printed(paddle.summary, ref)
    got, got_ret = _printed(ptt.summary, ours)
    assert got == want
    assert got_ret == want_ret
    assert got[-1] == f"Total params: {got_ret['total_params']}"


def test_summary_of_a_batch_norm_stack_equals_the_reference_as_a_set():
    ref, ours = _pair("resnet18")
    want, want_ret = _printed(paddle.summary, ref)
    got, got_ret = _printed(ptt.summary, ours)
    assert sorted(got) == sorted(want) and got_ret == want_ret


def test_model_summary_and_parameters():
    _, net = _pair("linear")
    model = ptt.Model(net)
    got, ret = _printed(model.summary)
    assert ret == {"total_params": 36} and got[0].split()[1:] == ["[8,", "4]",
                                                                  "32"]
    params = model.parameters()
    assert isinstance(params, list) and len(params) == 2
    assert all(a is b for a, b in zip(params, net.parameters()))


# -- flops ---------------------------------------------------------------
def _ref_forward(net):
    net.eval()
    params, buffers = state_pytrees(net)

    def fwd(params, *xs):
        out, _ = functional_call(net, params, tuple(JTensor(x) for x in xs),
                                 buffers=buffers)
        outs = out if isinstance(out, (tuple, list)) else [out]
        return tuple(o.value for o in outs)
    return fwd, params


def _ref_compiled(net, shape):
    """The reference's ``flops`` body on int32 ids: its compiled
    cost_analysis."""
    fwd, params = _ref_forward(net)
    ca = jax.jit(fwd).lower(params, jnp.zeros(shape, jnp.int32)) \
        .compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return int(ca["flops"])


_JAX_ELEMENTWISE = {
    "add", "sub", "mul", "div", "neg", "max", "min", "abs", "sign", "floor",
    "ceil", "round", "select_n", "eq", "ne", "lt", "le", "gt", "ge", "and",
    "or", "not", "square", "clamp", "rem", "add_any"}
_JAX_REDUCTIONS = {"reduce_sum", "reduce_max", "reduce_min", "argmax",
                   "argmin", "cumsum"}


def _jaxpr_flops(jaxpr):
    """The reference's program counted by the port's convention
    (utils/flops.py): dots 2 x out x reduced extent, elementwise 1 an
    output element, reductions 1 an input element, transcendentals and
    data movement 0.  Sub-jaxprs (jit, custom_jvp) are walked."""
    total = 0
    for e in jaxpr.eqns:
        name = e.primitive.name
        out = sum(math.prod(v.aval.shape) for v in e.outvars
                  if hasattr(v.aval, "shape"))
        if name == "dot_general":
            (lc, _), _ = e.params["dimension_numbers"]
            k = math.prod(e.invars[0].aval.shape[d] for d in lc)
            total += 2 * out * k
        elif name == "conv_general_dilated":
            w = e.invars[1].aval.shape
            rhs = e.params["dimension_numbers"].rhs_spec
            total += 2 * out * math.prod(w) // w[rhs[0]]
        elif name == "integer_pow":
            total += max(abs(e.params["y"]) - 1, 1) * out
        elif name in _JAX_ELEMENTWISE:
            total += out
        elif name in _JAX_REDUCTIONS:
            total += math.prod(e.invars[0].aval.shape)
        for p in e.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    total += _jaxpr_flops(inner)
    return total


def _ref_by_convention(net, shape):
    fwd, params = _ref_forward(net)
    return _jaxpr_flops(
        jax.make_jaxpr(fwd)(params, jnp.zeros(shape, jnp.int32)).jaxpr)


def _gelu_elements(net, shape):
    """The elements the reference's forward passes through GeLU (its
    jaxpr's ``erfc`` outputs)."""
    fwd, params = _ref_forward(net)
    jaxpr = jax.make_jaxpr(fwd)(params, jnp.zeros(shape, jnp.int32)).jaxpr

    def walk(j):
        n = 0
        for e in j.eqns:
            if e.primitive.name == "erfc":
                n += math.prod(e.outvars[0].aval.shape)
            for p in e.params.values():
                inner = getattr(p, "jaxpr", p)
                if hasattr(inner, "eqns"):
                    n += walk(inner)
        return n
    return walk(jaxpr)


def test_flops_of_linear_equals_the_reference_exactly():
    ref, ours = _pair("linear")
    assert ptt.flops(ours, [2, 8]) == paddle.flops(ref, [2, 8]) == 136


def test_flops_of_lenet_is_within_5_percent_of_the_reference():
    ref, ours = _pair("lenet")
    want = paddle.flops(ref, [1, 1, 28, 28])
    got = ptt.flops(ours, [1, 1, 28, 28])
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)


@pytest.mark.parametrize("name,shape", [("gpt", GPT_IDS),
                                        ("bert", BERT_IDS)])
def test_flops_of_a_transformer_is_within_5_percent_of_the_convention(
        name, shape):
    ref, ours = _pair(name)
    with pytest.raises(TypeError, match="integer"):
        paddle.flops(ref, list(shape))   # float32 zeros reach an embedding
    got = ptt.flops(ours, list(shape), dtypes="int64")
    want = _ref_by_convention(ref, shape)
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)


def test_flops_of_gpt_against_the_compiled_count_with_gelu_aside():
    """The compiled count less its GeLU (jax.nn.gelu's own compiled count
    over the same elements) against the port's less its GeLU (4 an
    element: bias_gelu_flops less the bias add)."""
    ref, ours = _pair("gpt")
    n = _gelu_elements(ref, GPT_IDS)
    gelu = jax.jit(lambda x: jax.nn.gelu(x, approximate=False)).lower(
        jnp.zeros((n,), jnp.float32)).compile().cost_analysis()
    gelu = (gelu[0] if isinstance(gelu, (list, tuple)) else gelu)["flops"]
    want = _ref_compiled(ref, GPT_IDS) - gelu
    got = ptt.flops(ours, list(GPT_IDS), dtypes="int64") - 4 * n
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)


def _spelled_out(fn, *args, **kwargs):
    with torch.no_grad(), tflops.FlopCounter() as c:
        fn(*args, **kwargs)
    return c.total


def _fused_cases():
    rs = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))
    x, w, b = t(3, 5, 16), t(16), t(16)
    q, k, v = t(2, 7, 3, 8), t(2, 9, 3, 8), t(2, 9, 3, 8)
    bias = t(2, 3, 7, 9)
    z = t(10, 33)
    lab = torch.from_numpy(rs.randint(0, 33, 10))
    yield "layer_norm", (ln.layer_norm, (x, w, b)), \
        (ln._plain_with_stats, (x, w, b, 1e-5))
    yield "bias_gelu", (bg.bias_gelu, (x, b)), (bg.bias_gelu_plain, (x, b))
    for causal in (True, False):
        for bb in (None, bias):
            yield (f"attention causal={causal} bias={bb is not None}",
                   (fa.flash_attention, (q, k, v, causal, bb)),
                   (fa.flash_attention_plain, (q, k, v, causal, bb)))
    yield "softmax_xent", (sx.softmax_xent_fwd, (z, lab)), \
        (sx.softmax_xent_plain, (z, lab))


@pytest.mark.parametrize("case", list(_fused_cases()), ids=lambda c: c[0])
def test_a_fused_ops_count_is_its_plain_versions_spelled_out(case):
    _, (entry, args), (plain, plain_args) = case
    got = _spelled_out(entry, *args)
    assert got > 0 and got == _spelled_out(plain, *plain_args)


def test_the_counter_is_suspended_inside_a_fused_op_and_off_outside():
    x = torch.ones(4, 8)
    with tflops.FlopCounter() as c:
        with tflops.fused(lambda: 7):
            x + x                        # counted by the fused op's 7
        x + x                            # 32
    assert c.total == 7 + 32
    calls = []
    assert tflops.fused(lambda: calls.append(1)) is not None and not calls


def test_flops_restores_each_sublayers_training_flag():
    _, net = _pair("lenet")
    net.train()
    frozen = net.features[0]
    frozen.eval()
    ptt.flops(net, [1, 1, 28, 28])
    assert net.training and not frozen.training
    assert all(m.training for m in net.modules() if m is not frozen)
