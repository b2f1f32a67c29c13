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

Counts and names are exact; values compared are exact (no arithmetic).
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
