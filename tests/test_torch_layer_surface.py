"""The port's ``nn.Layer`` and dropout surface against the JAX package's, on
the CPU.

- ``Layer.__init__(name_scope=None, dtype="float32")``: a subclass that
  names its scope, a bare layer given a dtype name, and a layer of another
  default dtype build the reference's dtype and shape; ``full_name`` is the
  reference's ``<scope>_<n>``; every built-in layer holds the reference's
  parameters (names, shapes, dtypes);
- ``F.dropout(x, p, axis, training, mode)`` and ``nn.Dropout(p, axis,
  mode, name)``: the reference's signatures; ``axis`` shares one keep mask
  along the other dimensions; ``upscale_in_train`` scales kept entries by
  1/(1-p) in training, ``downscale_in_infer`` leaves them and multiplies
  by (1-p) in eval; the default path draws what torch's dropout draws;
- the traversal surface: ``parameters()`` and ``buffers()`` are lists;
  ``named_parameters``, ``named_buffers``, ``state_dict``,
  ``named_sublayers`` and ``sublayers`` give the reference's names in its
  order on the same network; ``include_sublayers=False`` gives the layer's
  own; ``register_buffer(persistable=)``, ``add_parameter``,
  ``create_tensor``, ``register_forward_post_hook``, ``full_name``,
  ``clear_gradients``, ``no_sync`` and ``Model.parameters()``; torch's own
  keywords keep working.
- C8: the trailing ``name`` of nine functions, ``F.embedding``'s and
  ``nn.Embedding``'s ``padding_idx`` (the reference's argument order),
  ``Linear(name=)``, ``ClipGradByGlobalNorm(group_name=)`` and
  ``Layer.to(device, dtype, blocking)``'s positional forms;
- C9: ``Optimizer.minimize`` (bitwise ``backward(); step()``),
  ``clear_gradients``, ``set_dict``, every scheduler re-exported from
  ``optimizer`` and ``Model.eval_batch_no_loss``.

Counts and names are exact; values compared are exact where no
arithmetic differs, else float32 within 1e-6 (the two packages' libraries
round a transcendental or a sum in their own order).
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework.dtype import convert_dtype
from paddle_tpu_torch.nn import functional as TF


def _dtype_name(d):
    return str(d).replace("torch.", "")


# -- C4: Layer.__init__(name_scope, dtype) ------------------------------------
def _enc(nn):
    class Enc(nn.Layer):
        def __init__(self):
            super().__init__("enc")
            self.w = self.create_parameter([2, 2])

    return Enc()


def test_subclass_with_a_name_scope_builds_the_references_parameter():
    t, j = _enc(tnn), _enc(jnn)
    assert tuple(t.w.shape) == tuple(j.w.shape) == (2, 2)
    assert _dtype_name(t.w.dtype) == str(j.w.dtype) == "float32"


def test_full_name_follows_the_references_scheme():
    """``<scope>_<n>``, n counting the layers of that scope made so far, a
    counter per scope (the class name in lower case by default)."""
    t = [_enc(tnn).full_name() for _ in range(3)]
    j = [_enc(jnn).full_name() for _ in range(3)]
    for names in (t, j):
        assert all(n.startswith("enc_") for n in names)
        nums = [int(n.rsplit("_", 1)[1]) for n in names]
        assert nums == list(range(nums[0], nums[0] + 3))
    assert tnn.Linear(3, 4).full_name().startswith("linear_")
    assert jnn.Linear(3, 4).full_name().startswith("linear_")


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16",
                                   "float64"])
def test_create_parameter_converts_a_dtype_name(dtype):
    t = tnn.Layer().create_parameter([2, 3], dtype=dtype)
    j = jnn.Layer().create_parameter([2, 3], dtype=dtype)
    assert _dtype_name(t.dtype) == str(j.dtype) == dtype
    assert tuple(t.shape) == tuple(j.shape)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", torch.float16])
def test_the_layers_dtype_is_create_parameters_default(dtype):
    t = tnn.Layer(dtype=dtype)
    j = jnn.Layer(dtype=_dtype_name(dtype))
    assert t._dtype == convert_dtype(dtype)
    assert _dtype_name(t.create_parameter([3]).dtype) == \
        str(j.create_parameter([3]).dtype)
    assert _dtype_name(tnn.Layer("scope", dtype).create_parameter(
        [3]).dtype) == str(j.create_parameter([3]).dtype)


_BUILT_INS = [
    ("Linear", (5, 3)), ("Embedding", (7, 4)), ("LayerNorm", (6,)),
    ("BatchNorm1D", (4,)), ("BatchNorm2D", (3,)), ("Conv2D", (2, 3, 3)),
    ("Conv1D", (2, 3, 2)), ("GroupNorm", (2, 4)), ("PReLU", ()),
    ("MultiHeadAttention", (8, 2)),
    ("TransformerEncoderLayer", (8, 2, 16)),
]


@pytest.mark.parametrize("name,args", _BUILT_INS,
                         ids=[n for n, _ in _BUILT_INS])
def test_built_in_layers_hold_the_references_parameters(name, args):
    t, j = getattr(tnn, name)(*args), getattr(jnn, name)(*args)
    tp = [(n, tuple(p.shape), _dtype_name(p.dtype))
          for n, p in t.named_parameters()]
    jp = [(n, tuple(p.shape), str(p.dtype)) for n, p in j.named_parameters()]
    assert sorted(tp) == sorted(jp)


# -- C5: dropout --------------------------------------------------------------
def test_dropout_signatures_are_the_references():
    assert list(inspect.signature(TF.dropout).parameters) == \
        list(inspect.signature(JF.dropout).parameters)
    assert list(inspect.signature(tnn.Dropout).parameters) == \
        list(inspect.signature(jnn.Dropout).parameters)
    assert inspect.signature(TF.dropout).parameters["mode"].default == \
        inspect.signature(JF.dropout).parameters["mode"].default


def test_third_positional_argument_is_axis():
    """``F.dropout(x, 0.5, 0)``: axis 0, training (the default) on — the
    parent port read the 0 as ``training`` and dropped nothing."""
    torch.manual_seed(0)
    y = TF.dropout(torch.ones(64, 3), 0.5, 0)
    rows = y.reshape(64, 3)
    # one mask over dim 0, shared along dim 1: each row all 0 or all 2
    assert set(torch.unique(rows, dim=1).flatten().tolist()) <= {0.0, 2.0}
    assert all(len(set(r.tolist())) == 1 for r in rows)
    assert 0 < int((rows[:, 0] == 0).sum()) < 64


@pytest.mark.parametrize("axis,shared", [(0, (1, 2)), (1, (0, 2)),
                                         ([0, 2], (1,)), ((1, 2), (0,)),
                                         (-1, (0, 1))])
def test_axis_shares_one_mask_along_the_other_dims(axis, shared):
    torch.manual_seed(1)
    x = torch.ones(6, 5, 4)
    y = TF.dropout(x, 0.4, axis=axis)
    keep = y != 0
    # constant along each shared dim
    for d in shared:
        first = keep.select(d, 0).unsqueeze(d)
        assert torch.equal(keep, first.expand_as(keep))
    assert set(torch.unique(y).tolist()) <= {0.0, np.float32(1.0 / 0.6)}


def test_modes_scale_as_paddle_defines_them():
    torch.manual_seed(2)
    x = torch.full((200,), 3.0)
    up = TF.dropout(x, 0.25)
    assert set(torch.unique(up).tolist()) == {0.0, np.float32(3.0 / 0.75)}
    down = TF.dropout(x, 0.25, mode="downscale_in_infer")
    assert set(torch.unique(down).tolist()) == {0.0, 3.0}
    assert torch.equal(TF.dropout(x, 0.25, training=False), x)
    assert torch.equal(TF.dropout(x, 0.25, training=False,
                                  mode="downscale_in_infer"), x * 0.75)
    with pytest.raises(ValueError):
        TF.dropout(x, 0.25, mode="nope")


def test_default_dropout_draws_what_torchs_dropout_draws():
    """axis None, upscale_in_train: the same generator draws, the same
    mask, so the training runs of earlier slices keep their streams."""
    x = torch.randn(16, 9)
    torch.manual_seed(3)
    a = TF.dropout(x, 0.1)
    torch.manual_seed(3)
    b = torch.nn.functional.dropout(x, 0.1, training=True)
    assert torch.equal(a, b)


def test_dropout_layer_takes_axis_and_mode():
    torch.manual_seed(4)
    d = tnn.Dropout(0.5, axis=1, mode="downscale_in_infer", name="d")
    y = d(torch.ones(8, 6))
    assert all(len(set(c.tolist())) == 1 for c in y.t())
    assert set(torch.unique(y).tolist()) <= {0.0, 1.0}
    d.eval()
    assert torch.equal(d(torch.ones(2, 6)), torch.full((2, 6), 0.5))


def test_dropout_keeps_the_gradient_path():
    torch.manual_seed(5)
    x = torch.ones(4, 5, requires_grad=True)
    TF.dropout(x, 0.5, axis=0).sum().backward()
    assert set(torch.unique(x.grad).tolist()) <= {0.0, 2.0}


# -- C6: traversal surface ----------------------------------------------------
def _net(nn):
    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 4)
            self.norm = nn.BatchNorm1D(4)

        def forward(self, x):
            return self.norm(self.fc(x))

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Linear(3, 4)
            self.blocks = nn.Sequential(Block(), Block())
            self.head = nn.Linear(4, 2)
            self.scale = self.create_parameter([1], is_bias=True)

        def forward(self, x):
            return self.head(self.blocks(self.embed(x))) * self.scale

    return Net()


@pytest.fixture
def nets():
    paddle.seed(0)
    return _net(tnn), _net(jnn)


def test_parameters_is_a_list_in_the_references_order(nets):
    t, j = nets
    assert isinstance(t.parameters(), list)
    assert len(t.parameters()) == len(j.parameters()) == 13
    assert [tuple(p.shape) for p in t.parameters()] == \
        [tuple(p.shape) for p in j.parameters()]
    assert len(tnn.Linear(3, 4).parameters()) == 2


def test_named_parameters_and_buffers_match(nets):
    t, j = nets
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in j.named_parameters()]
    assert [n for n, _ in t.named_parameters(prefix="m")] == \
        [n for n, _ in j.named_parameters(prefix="m")]
    assert sorted(n for n, _ in t.named_buffers()) == \
        sorted(n for n, _ in j.named_buffers())
    assert isinstance(t.buffers(), list)
    assert len(t.buffers()) == len(j.buffers()) == 4


def test_include_sublayers_false_gives_the_layers_own(nets):
    """Paddle's ``include_sublayers=False``: the layer's own tensors only
    (the reference's methods accept the flag and ignore it)."""
    t, _ = nets
    assert [n for n, _ in t.named_parameters(include_sublayers=False)] == \
        ["scale"]
    assert len(t.parameters(include_sublayers=False)) == 1
    assert t.blocks[0].norm.buffers(include_sublayers=False) != []
    assert t.buffers(False) == []
    assert list(t.state_dict(include_sublayers=False)) == ["scale"]


def test_state_dict_keys_match(nets):
    t, j = nets
    assert list(t.state_dict()) == list(j.state_dict())
    for pre in ("net", "net."):
        assert list(t.state_dict(structured_name_prefix=pre)) == \
            list(j.state_dict(structured_name_prefix=pre))


def test_named_sublayers_and_sublayers_match(nets):
    t, j = nets
    for kw in ({}, {"include_self": True}, {"prefix": "root"}):
        tn = [(n, type(l).__name__) for n, l in t.named_sublayers(**kw)]
        jn = [(n, type(l).__name__) for n, l in j.named_sublayers(**kw)]
        assert tn == jn, kw
    assert [type(l).__name__ for l in t.sublayers()] == \
        [type(l).__name__ for l in j.sublayers()]
    assert len(t.sublayers(include_self=True)) == len(t.sublayers()) + 1


def test_a_shared_sublayer_is_visited_once():
    for nn in (tnn, jnn):
        shared = nn.Linear(2, 2)
        seq = nn.Sequential(shared, shared)
        assert len(seq.sublayers()) == 1
        assert len(seq.parameters()) == 2


def test_register_buffer_persistable():
    for nn in (tnn, jnn):
        layer = nn.Layer()
        keep = layer.register_buffer("keep", paddle.to_tensor([1.0])
                                     if nn is jnn else torch.ones(1))
        layer.register_buffer("tmp", paddle.to_tensor([2.0])
                              if nn is jnn else torch.ones(1),
                              persistable=False)
        assert keep is not None
        assert list(layer.state_dict()) == ["keep"]
        assert sorted(n for n, _ in layer.named_buffers()) == ["keep",
                                                              "tmp"]
    layer = tnn.Layer()
    layer.register_buffer("t", torch.ones(1), persistent=False)
    assert list(layer.state_dict()) == []


def test_add_parameter_and_create_tensor():
    t, j = tnn.Layer(), jnn.Layer()
    tp = t.add_parameter("w", t.create_parameter([2, 3]))
    jp = j.add_parameter("w", j.create_parameter([2, 3]))
    assert tp is t.w and jp is j.w
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in j.named_parameters()] == ["w"]
    tt = t.create_tensor("c", persistable=True, dtype="float16")
    jt = j.create_tensor("c", persistable=True, dtype="float16")
    assert tuple(tt.shape) == tuple(jt.shape) == ()
    assert _dtype_name(tt.dtype) == str(jt.dtype) == "float16"
    assert list(t.state_dict()) == list(j.state_dict()) == ["w", "c"]
    assert tnn.Layer().create_tensor().dtype == torch.float32


def test_forward_post_hook_replaces_the_output_and_is_removable():
    results = []
    for nn, ones in ((tnn, torch.ones(1, 3)),
                     (jnn, paddle.to_tensor(np.ones((1, 3), "f")))):
        layer = nn.Linear(3, 2)
        seen = []

        def hook(lay, inputs, out, seen=seen):
            seen.append(len(inputs))
            return out * 0

        h = layer.register_forward_post_hook(hook)
        out = layer(ones)
        h.remove()
        out2 = layer(ones)
        results.append((seen, float(np.abs(np.asarray(
            out.detach() if nn is tnn else out.numpy())).sum()),
            float(np.abs(np.asarray(
                out2.detach() if nn is tnn else out2.numpy())).sum()) > 0))
    assert results[0][0] == results[1][0] == [1]
    assert results[0][1] == results[1][1] == 0.0
    assert results[0][2] and results[1][2]


def test_clear_gradients_and_no_sync():
    layer = tnn.Linear(3, 2)
    layer(torch.ones(1, 3)).sum().backward()
    assert all(p.grad is not None for p in layer.parameters())
    layer.clear_gradients()
    assert all(p.grad is None for p in layer.parameters())
    with layer.no_sync():
        pass
    assert callable(jnn.Linear(3, 2).clear_gradients)


def test_torch_keywords_keep_working(nets):
    t, _ = nets
    assert len(t.parameters(recurse=False)) == 1
    assert len(list(t.named_parameters("p", True, True))) == 13
    assert len(list(t.named_parameters(recurse=False))) == 1
    sd = t.state_dict(destination={}, prefix="x.", keep_vars=True)
    assert all(k.startswith("x.") for k in sd)
    assert isinstance(sd["x.scale"], torch.nn.Parameter)
    assert len(list(t.named_buffers(recurse=True, remove_duplicate=True))) \
        == 4
    assert len(list(t.modules())) == len(t.sublayers(include_self=True))
    t.zero_grad()
    t.load_state_dict(t.state_dict())


def test_model_parameters_is_the_networks_list(nets):
    t, j = nets
    tm, jm = ptt.Model(t), paddle.Model(j)
    assert isinstance(tm.parameters(), list)
    assert len(tm.parameters()) == len(jm.parameters())
    assert all(a is b for a, b in zip(tm.parameters(), t.parameters()))


# -- C8: the reference's parameters -------------------------------------------
RS = np.random.RandomState(8)
X = RS.randn(2, 3, 8).astype(np.float32)
W = RS.randn(8, 5).astype(np.float32)
LN_W, LN_B = RS.randn(8).astype(np.float32), RS.randn(8).astype(np.float32)
Q = RS.randn(1, 4, 2, 8).astype(np.float32)
LOGITS = RS.randn(6, 5).astype(np.float32)
LABELS = RS.randint(0, 5, 6).astype(np.int64)


def _named_calls(F, t):
    """Each function with its trailing ``name`` given (positionally where
    the roadmap's probe gave it so)."""
    return {
        "relu": lambda: F.relu(t(X), name="r"),
        "tanh": lambda: F.tanh(t(X), name="t"),
        "softmax": lambda: F.softmax(t(X), -1, None, "n"),
        "log_softmax": lambda: F.log_softmax(t(X), -1, None, "n"),
        "gelu": lambda: F.gelu(t(X), False, "g"),
        "linear": lambda: F.linear(t(X), t(W), None, "l"),
        "layer_norm": lambda: F.layer_norm(t(X), 8, t(LN_W), t(LN_B), 1e-5,
                                           name="ln"),
        "cross_entropy": lambda: F.cross_entropy(t(LOGITS), t(LABELS),
                                                 name="ce"),
        "scaled_dot_product_attention": lambda: (
            F.scaled_dot_product_attention(t(Q), t(Q), t(Q), name="a")),
    }


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x.numpy())


@pytest.mark.parametrize("fn", list(_named_calls(TF, torch.from_numpy)))
def test_functions_take_the_references_name(fn):
    """float32, 1e-6 (the two packages' libraries may round a
    transcendental differently in the last place)."""
    got = _np(_named_calls(TF, torch.from_numpy)[fn]())
    want = _np(_named_calls(JF, paddle.to_tensor)[fn]())
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_functional_embedding_zeroes_the_padding_rows():
    ids = np.array([[0, 3, 2], [3, 3, 1]], np.int64)
    w = RS.randn(4, 6).astype(np.float32)
    for pad in (3, None, -1):
        got = TF.embedding(torch.from_numpy(ids), torch.from_numpy(w),
                           padding_idx=pad, sparse=False, name="e")
        want = JF.embedding(paddle.to_tensor(ids), paddle.to_tensor(w),
                            padding_idx=pad, sparse=False, name="e")
        assert np.array_equal(_np(got), _np(want)), pad


@pytest.mark.parametrize("pad", [0, -1, None])
def test_embedding_layer_takes_the_references_arguments(pad):
    """``Embedding(num, dim, padding_idx, sparse, weight_attr, name)``: the
    padding row starts at zero and looks up zeros (a negative index counts
    from the end)."""
    j = jnn.Embedding(10, 4, pad, False, None, "emb")
    t = tnn.Embedding(10, 4, pad, False, None, "emb")
    if pad is not None:
        assert not t.weight[pad].any() and not np.asarray(
            j.weight.numpy())[pad].any()
    w = RS.randn(10, 4).astype(np.float32)
    if pad is not None:
        w[pad] = 0.0
    with torch.no_grad():
        t.weight.copy_(torch.from_numpy(w))
    j.weight.set_value(w)
    ids = np.array([0, 9, 3, 0, 9], np.int64)
    assert np.array_equal(_np(t(torch.from_numpy(ids))),
                          _np(j(paddle.to_tensor(ids))))


def test_linear_name_and_clip_group_name():
    assert tuple(tnn.Linear(3, 4, None, None, "fc").weight.shape) == \
        tuple(jnn.Linear(3, 4, None, None, "fc").weight.shape) == (3, 4)
    t = ptt.nn.ClipGradByGlobalNorm(1.0, group_name="g")
    j = paddle.nn.ClipGradByGlobalNorm(1.0, group_name="g")
    assert t.group_name == j.group_name == "g"
    assert ptt.nn.ClipGradByGlobalNorm(1.0).group_name == "default_group"


@pytest.mark.parametrize("args,kwargs", [
    (("cpu", "float64"), {}), (("float32",), {}), ((None, "bfloat16"), {}),
    ((), {"dtype": "float16"}), ((), {"device": "cpu", "dtype": "float64"}),
    (("cpu",), {"blocking": True})], ids=str)
def test_to_takes_the_references_positional_form(args, kwargs):
    """``to(device=None, dtype=None, blocking=None)``: the parameters take
    the reference's dtype (float32 layers)."""
    t, j = tnn.Linear(3, 4), jnn.Linear(3, 4)
    assert t.to(*args, **kwargs) is t
    j.to(*args, **kwargs)
    assert _dtype_name(t.weight.dtype) == str(j.weight.dtype)
    assert _dtype_name(t.bias.dtype) == str(j.bias.dtype)


# -- C9: the reference's public methods ---------------------------------------
def _port_linears(j, n=1):
    """``n`` port Linears holding the weights of the reference's ``j``."""
    out = []
    for _ in range(n):
        t = tnn.Linear(4, 3)
        with torch.no_grad():
            t.weight.copy_(torch.from_numpy(np.array(j.weight.numpy())))
            t.bias.copy_(torch.from_numpy(np.array(j.bias.numpy())))
        out.append(t)
    return out


def test_minimize_is_backward_then_step():
    """Bitwise ``loss.backward(); step()`` in the port, and the
    reference's update (1e-6) and return form."""
    x = RS.randn(5, 4).astype(np.float32)
    j = jnn.Linear(4, 3)
    a, b = _port_linears(j, 2)
    opt_a = ptt.optimizer.Adam(0.1, parameters=a.parameters())
    opt_b = ptt.optimizer.Adam(0.1, parameters=b.parameters())
    opt_j = paddle.optimizer.Adam(0.1, parameters=j.parameters())
    for _ in range(3):
        a(torch.from_numpy(x)).square().mean().backward()
        opt_a.step()
        opt_a.clear_grad()
        none, pg = opt_b.minimize(b(torch.from_numpy(x)).square().mean())
        assert none is None and [p for p, _ in pg] == list(b.parameters())
        assert all(g is p.grad for p, g in pg)
        opt_b.clear_gradients()
        jnone, jpg = opt_j.minimize((j(paddle.to_tensor(x)) ** 2).mean())
        assert jnone is None and len(jpg) == len(pg)
        opt_j.clear_gradients()
    for p, q, r in zip(a.parameters(), b.parameters(), j.parameters()):
        assert torch.equal(p, q)
        np.testing.assert_allclose(_np(q), _np(r), rtol=1e-6, atol=1e-6)
        assert q.grad is None


def test_set_dict_is_set_state_dict():
    (a,) = _port_linears(jnn.Linear(4, 3))
    opt_a = ptt.optimizer.Adam(0.1, parameters=a.parameters())
    a(torch.ones(2, 4)).sum().backward()
    opt_a.step()
    opt_b = ptt.optimizer.Adam(0.1, parameters=a.parameters())
    opt_b.set_dict(opt_a.state_dict())
    sa, sb = opt_a.state_dict(), opt_b.state_dict()
    assert sb.keys() == sa.keys() and len(sa) == 5
    assert all(k == "step_count" or torch.equal(sa[k], sb[k]) for k in sa)
    assert opt_b._step_count == 1
    assert hasattr(paddle.optimizer.Adam, "set_dict")


def test_every_scheduler_is_reexported_from_optimizer():
    from paddle_tpu.optimizer import lr as jlr

    names = [n for n, c in vars(jlr).items()
             if inspect.isclass(c) and c.__module__ == jlr.__name__]
    assert len(names) == 15
    for n in names:
        assert getattr(paddle.optimizer, n) is getattr(jlr, n)
        assert getattr(ptt.optimizer, n) is getattr(ptt.optimizer.lr, n)
    t = ptt.optimizer.StepDecay(0.5, step_size=2, gamma=0.1)
    j = paddle.optimizer.StepDecay(0.5, step_size=2, gamma=0.1)
    seq = []
    for _ in range(5):
        seq.append((t(), j()))
        t.step()
        j.step()
    assert all(a == b for a, b in seq)


def test_model_eval_batch_no_loss():
    j = jnn.Linear(4, 3)
    (t,) = _port_linears(j)
    x = RS.randn(2, 4).astype(np.float32)
    outs, loss = ptt.Model(t).eval_batch_no_loss([torch.from_numpy(x)])
    jouts, jloss = paddle.Model(j).eval_batch_no_loss([paddle.to_tensor(x)])
    np.testing.assert_allclose(_np(outs), _np(jouts), rtol=1e-6, atol=1e-6)
    assert float(loss) == float(np.asarray(jloss)) == 0.0
    assert loss.shape == ()
