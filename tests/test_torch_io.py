"""The port's data pipeline (``paddle_tpu_torch.io``) against the JAX
package's ``paddle_tpu.io``, on the CPU.

- exact equality with the reference: ``DataLoader`` batches of one numpy
  dataset, ``shuffle=False``, at ``num_workers`` 0 and 2 with the buffered
  reader on and off; ``Subset``, ``ComposeDataset``, ``ChainDataset``, an
  ``IterableDataset`` with and without ``drop_last``, ``pad_ragged``
  (buckets, head and tail truncation);
- determinism per seed and the defining properties: ``random_split`` is
  a partition of the given lengths, ``RandomSampler`` (replacement,
  ``num_samples``) and ``WeightedRandomSampler`` stay on the support and
  never draw a zero weight, a seeded shuffle is the same through the
  buffered, unbuffered and 2-worker loaders, a caller's infinite
  ``batch_sampler`` stays lazy;
- workers: an exception comes back with its traceback, a worker that
  exits raises ``RuntimeError`` (not a hang), ``timeout`` raises, an
  unpicklable local dataset falls back to ``fork`` with the reference's
  warning, ``worker_init_fn`` gets ids 0..n-1, bfloat16 / float16 /
  float32 / int64 fields come through bitwise, a worker sees no CUDA
  device (``CUDA_VISIBLE_DEVICES`` is ``""`` in it and restored in the
  parent) and a worker that reaches CUDA fails loudly, a consumer that
  stops early leaves no worker behind;
- ``DataLoader``'s positional order is the reference's;
- ``Model.fit`` / ``evaluate`` / ``predict`` on a small BERT with
  ``num_workers=2``: bitwise the port's ``num_workers=0`` (``shuffle=True``
  from a seed), and within rtol 1e-5 of the reference's own
  ``num_workers=2`` run (shuffle off: the packages draw different orders);
  the placement hook runs on the reader's thread, is ``pin_batch`` only
  on a CUDA model and is restored after the call.

Every loader that starts workers has a ``timeout`` (or a dead worker's
own check) so that no test waits on a hung worker.  Forkserver workers
import this module to unpickle its datasets, so it imports the JAX package
only inside the tests that use it: a worker starts in a fraction of a
second.
"""
import itertools
import multiprocessing as mp
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.io import DataLoader
from paddle_tpu_torch.models import BertConfig, BertForPretraining

TIMEOUT = 60      # seconds a worker batch may take before the loader raises
FIT_TOL = dict(rtol=1e-5, atol=1e-6)


# -- picklable datasets (forkserver workers import this module) ------------
class Rows:
    """N rows of 3 float32 and an int64 label, made from a seed."""

    def __init__(self, n=21):
        rs = np.random.RandomState(0)
        self.x = rs.randn(n, 3).astype(np.float32)
        self.y = rs.randint(0, 100, n).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


class Mixed(ptt.io.Dataset):
    """One field of each dtype a batch carries: float32, bfloat16,
    float16 (values no 8-bit exponent format rounds to) and int64."""

    def __init__(self, n=10):
        rs = np.random.RandomState(1)
        self.f = torch.from_numpy(rs.randn(n, 4).astype(np.float32))
        self.b = torch.from_numpy(rs.randn(n, 4).astype(np.float32)) \
            .to(torch.bfloat16)
        self.h = torch.from_numpy((rs.randn(n, 4) * 1e-5).astype(np.float16))
        self.i = torch.from_numpy(rs.randint(-2 ** 40, 2 ** 40, (n, 2)))

    def __getitem__(self, i):
        return self.f[i], self.b[i], self.h[i], self.i[i]

    def __len__(self):
        return len(self.f)


class Poison(ptt.io.Dataset):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("poison-idx-5")
        return np.float32(i)

    def __len__(self):
        return 12


class Dies(ptt.io.Dataset):
    def __getitem__(self, i):
        if i == 3:
            os._exit(3)
        return np.float32(i)

    def __len__(self):
        return 12


class Slow(ptt.io.Dataset):
    def __getitem__(self, i):
        if i == 2:
            time.sleep(30)
        return np.float32(i)

    def __len__(self):
        return 8


class EnvProbe(ptt.io.Dataset):
    """Each sample: the CUDA_VISIBLE_DEVICES the process reading it sees."""

    def __getitem__(self, i):
        return os.environ.get("CUDA_VISIBLE_DEVICES", "<unset>")

    def __len__(self):
        return 4


class TouchesCuda(ptt.io.Dataset):
    def __getitem__(self, i):
        return torch.zeros(1, device="cuda")

    def __len__(self):
        return 4


_WORKER_ID = None


def record_id(worker_id):
    global _WORKER_ID
    _WORKER_ID = worker_id


class WhoReads(ptt.io.Dataset):
    def __getitem__(self, i):
        return _WORKER_ID

    def __len__(self):
        return 12


def _ref():
    import paddle_tpu
    return paddle_tpu


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = list(g), list(w)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            a, b = _np(a), _np(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(
                a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


# -- equality with the reference ------------------------------------------
@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("buffered", [True, False])
def test_batches_equal_the_reference(workers, buffered):
    kw = dict(batch_size=4, shuffle=False, num_workers=workers,
              use_buffer_reader=buffered, timeout=TIMEOUT)
    got = list(DataLoader(Rows(), **kw))
    want = list(_ref().io.DataLoader(Rows(), batch_size=4, shuffle=False))
    assert len(got) == 6 and got[-1][0].shape == (1, 3)
    _same_batches(got, want)


def test_datasets_equal_the_reference():
    paddle = _ref()
    rows = Rows()
    sub_t, sub_r = ptt.io.Subset(rows, [5, 1, 7]), \
        paddle.io.Subset(rows, [5, 1, 7])
    assert len(sub_t) == len(sub_r) == 3
    for i in range(3):
        np.testing.assert_array_equal(sub_t[i][0], sub_r[i][0])
    comp_t = ptt.io.ComposeDataset([rows, ptt.io.Subset(rows, range(5))])
    comp_r = paddle.io.ComposeDataset([rows, paddle.io.Subset(rows,
                                                              range(5))])
    assert len(comp_t) == len(comp_r) == 5
    for i in range(5):
        for a, b in zip(comp_t[i], comp_r[i]):
            np.testing.assert_array_equal(a, b)
    assert len(comp_t[0]) == 4


class _Stream(ptt.io.IterableDataset):
    def __init__(self, n, start=0):
        self.n, self.start = n, start

    def __iter__(self):
        return iter(np.arange(self.start, self.start + self.n,
                              dtype=np.int64))


@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_and_chain_datasets_equal_the_reference(drop_last):
    paddle = _ref()

    class _JStream(paddle.io.IterableDataset):
        def __init__(self, n, start=0):
            self.n, self.start = n, start

        def __iter__(self):
            return iter(np.arange(self.start, self.start + self.n,
                                  dtype=np.int64))

    chain_t = ptt.io.ChainDataset([_Stream(5), _Stream(6, 100)])
    chain_r = paddle.io.ChainDataset([_JStream(5), _JStream(6, 100)])
    assert list(iter(chain_t)) == list(iter(chain_r))
    for ds_t, ds_r in ((_Stream(11), _JStream(11)), (chain_t, chain_r)):
        got = [[b] for b in DataLoader(ds_t, batch_size=4,
                                       drop_last=drop_last)]
        want = [[b] for b in paddle.io.DataLoader(ds_r, batch_size=4,
                                                  drop_last=drop_last)]
        assert len(got) == (2 if drop_last else 3)
        _same_batches(got, want)
    with pytest.raises(TypeError):
        len(DataLoader(_Stream(3)))
    with pytest.raises(RuntimeError):
        _Stream(3)[0]


@pytest.mark.parametrize("kw", [
    {}, {"buckets": [4, 8, 16]}, {"buckets": [2, 3]},
    {"buckets": [2, 3], "truncate": "head"}, {"pad_value": -1},
    {"dtype": np.int32, "buckets": [6]}])
def test_pad_ragged_equals_the_reference(kw):
    seqs = [[1, 2, 3], [4], [5, 6, 7, 8, 9], []]
    got = ptt.io.pad_ragged(seqs, **kw)
    want = _ref().io.pad_ragged(seqs, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- samplers and seeds ---------------------------------------------------
def test_random_split_is_a_seeded_partition():
    ds = Rows(20)

    def split(s):
        ptt.seed(s)
        return [list(p.indices) for p in ptt.io.random_split(ds, [5, 7, 8])]
    a = split(3)
    assert [len(p) for p in a] == [5, 7, 8]
    assert sorted(sum(a, [])) == list(range(20))
    assert split(3) == a and split(4) != a
    g = torch.Generator().manual_seed(9)
    assert [list(p.indices) for p in ptt.io.random_split(ds, [10, 10], g)] \
        == [list(p.indices) for p in ptt.io.random_split(
            ds, [10, 10], torch.Generator().manual_seed(9))]
    with pytest.raises(ValueError):
        ptt.io.random_split(ds, [5, 5])


def test_random_sampler_replacement_and_num_samples():
    ds = Rows(10)
    ptt.seed(0)
    s = ptt.io.RandomSampler(ds, replacement=True, num_samples=50)
    draws = list(s)
    assert len(s) == 50 and len(draws) == 50
    assert set(draws) <= set(range(10)) and len(set(draws)) > 5
    ptt.seed(0)
    assert list(ptt.io.RandomSampler(ds, replacement=True,
                                     num_samples=50)) == draws
    head = list(ptt.io.RandomSampler(ds, num_samples=4))
    assert len(head) == 4 and len(set(head)) == 4
    assert sorted(ptt.io.RandomSampler(ds)) == list(range(10))


@pytest.mark.parametrize("replacement", [True, False])
def test_weighted_sampler_never_draws_a_zero_weight(replacement):
    w = [0.0, 1.0, 3.0, 0.0, 2.0, 0.5]
    g = torch.Generator().manual_seed(1)
    n = 400 if replacement else 4
    draws = list(ptt.io.WeightedRandomSampler(w, n, replacement, g))
    assert len(draws) == n and set(draws) <= {1, 2, 4, 5}
    if not replacement:
        assert len(set(draws)) == 4
    else:
        counts = np.bincount(draws, minlength=6)
        assert counts[2] > counts[1] > counts[5]
    assert list(ptt.io.WeightedRandomSampler(
        w, n, replacement, torch.Generator().manual_seed(1))) == draws


def test_a_seeded_shuffle_is_the_same_through_every_loader():
    def order(**kw):
        ptt.seed(5)
        loader = DataLoader(Rows(), batch_size=4, shuffle=True,
                            timeout=TIMEOUT, **kw)
        return [[b[1].tolist() for b in loader] for _ in range(2)]
    want = order(use_buffer_reader=False)
    assert want[0] != want[1]          # each epoch draws anew
    assert order() == want
    assert order(num_workers=2) == want


class _Forever(ptt.io.Sampler):
    batch_size = 2

    def __iter__(self):
        i = 0
        while True:
            yield [i, i + 1]
            i += 2


@pytest.mark.parametrize("workers", [0, 2])
def test_a_callers_infinite_batch_sampler_stays_lazy(workers):
    loader = DataLoader(Rows(100), batch_sampler=_Forever(),
                        num_workers=workers, timeout=TIMEOUT)
    it = iter(loader)
    got = [b[1].tolist() for b in itertools.islice(it, 3)]
    it.close()
    want = Rows(100).y
    assert got == [want[0:2].tolist(), want[2:4].tolist(), want[4:6].tolist()]


def test_positional_order_is_the_references():
    """(d) ``DataLoader(ds, None, None, True, sampler)``: feed_list,
    places and return_list come before batch_sampler."""
    ds = Rows(8)
    sampler = ptt.io.BatchSampler(ds, batch_size=3)
    loader = DataLoader(ds, None, None, True, sampler)
    assert loader.batch_sampler is sampler and loader.batch_size == 3
    assert [len(b[1]) for b in loader] == [3, 3, 2]
    paddle = _ref()
    ref = paddle.io.DataLoader(ds, None, None, True,
                               paddle.io.BatchSampler(ds, batch_size=3))
    assert ref.batch_size == 3
    with pytest.raises(TypeError):
        DataLoader(ds, None, None, True, sampler, 1, False, False, None, 0,
                   True, 2, False, 0, None, False, None)   # generator: kw


def test_tensor_dataset_pickles_host_tensors_and_get_worker_info():
    ds = ptt.io.TensorDataset([torch.arange(6.0), np.arange(6)])
    back = pickle.loads(pickle.dumps(ds))
    assert torch.equal(back.tensors[0], torch.arange(6.0))
    assert back.tensors[0].device.type == "cpu"
    assert ptt.io.get_worker_info() is None is _ref().io.get_worker_info()


# -- workers --------------------------------------------------------------
@pytest.mark.parametrize("buffered", [True, False])
def test_bf16_and_f16_fields_cross_the_process_boundary_bitwise(buffered):
    """(b) a worker collates into CPU torch tensors: each field is bitwise
    the in-process collate's, bfloat16 included."""
    kw = dict(batch_size=3, use_buffer_reader=buffered)
    got = list(DataLoader(Mixed(), num_workers=2, timeout=TIMEOUT, **kw))
    want = list(DataLoader(Mixed(), **kw))
    assert [b[1].dtype for b in got] == [torch.bfloat16] * 4
    assert [b[2].dtype for b in got] == [torch.float16] * 4
    _bitwise(got, want)


def test_a_workers_exception_comes_back_with_its_traceback():
    loader = DataLoader(Poison(), batch_size=2, num_workers=2,
                        timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="(?s)worker 0 failed.*"
                       "Traceback.*poison-idx-5"):
        list(loader)


def test_a_worker_that_exits_raises_not_hangs():
    loader = DataLoader(Dies(), batch_size=2, num_workers=2)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="died with exit code 3"):
        list(loader)
    assert time.monotonic() - t0 < 20


def test_timeout_raises():
    loader = DataLoader(Slow(), batch_size=2, num_workers=1, timeout=1)
    with pytest.raises(RuntimeError, match="timed out after 1s"):
        list(loader)


def test_an_unpicklable_dataset_falls_back_to_fork_with_the_warning():
    class Local(ptt.io.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return np.full((2,), i, np.float32)

    loader = DataLoader(Local(), batch_size=4, num_workers=1,
                        timeout=TIMEOUT)
    with pytest.warns(RuntimeWarning, match=r"not\s+picklable"):
        out = list(loader)
    assert loader._pick_start_method() == "fork" and len(out) == 2
    assert DataLoader(Rows(), num_workers=1)._pick_start_method() \
        in ("forkserver", "spawn")


def test_the_start_method_follows_the_environment(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_MP_START", "fork")
    loader = DataLoader(Rows(), batch_size=8, num_workers=1,
                        timeout=TIMEOUT)
    assert loader._pick_start_method() == "fork"
    assert len(list(loader)) == 3


def test_worker_init_fn_gets_ids_0_to_n_minus_1():
    loader = DataLoader(WhoReads(), batch_size=2, num_workers=3,
                        worker_init_fn=record_id, timeout=TIMEOUT)
    ids = [b.tolist() for b in loader]
    # batch b goes to worker b % 3
    assert ids == [[b % 3] * 2 for b in range(6)]


@pytest.mark.parametrize("method", ["forkserver", "fork"])
def test_a_worker_sees_no_cuda_device(monkeypatch, method):
    """(a) CUDA_VISIBLE_DEVICES is "" while the workers start, and in
    them; the parent's value comes back after."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("PADDLE_TPU_MP_START", method)
    loader = DataLoader(EnvProbe(), batch_size=2, num_workers=2,
                        timeout=TIMEOUT)
    assert sum(list(loader), []) == [""] * 4
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"
    assert sum(list(DataLoader(EnvProbe(), batch_size=2)), []) == ["0"] * 4


def test_a_worker_that_reaches_cuda_fails_loudly():
    loader = DataLoader(TouchesCuda(), batch_size=2, num_workers=1,
                        timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="(?s)worker 0 failed.*cuda"):
        list(loader)


@pytest.mark.parametrize("buffered", [True, False])
def test_stopping_early_shuts_the_workers_down(buffered):
    loader = DataLoader(Rows(200), batch_size=2, num_workers=2,
                        use_buffer_reader=buffered, timeout=TIMEOUT)
    it = iter(loader)
    next(it)
    it.close()
    deadline = time.monotonic() + 10
    while mp.active_children() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not [p for p in mp.active_children()
                if p.name.startswith("Process")]


def test_the_placement_hook_runs_on_the_readers_thread():
    seen = []

    def place(batch):
        seen.append(threading.current_thread().name)
        return batch

    loader = DataLoader(Rows(8), batch_size=4)
    loader.placement = place
    assert len(list(loader)) == 2 and seen == ["DataLoader reader"] * 2
    loader.use_buffer_reader = False
    seen.clear()
    list(loader)
    assert seen == [threading.current_thread().name] * 2


# -- Model.fit / evaluate / predict with workers ---------------------------
BERT = dict(vocab_size=60, hidden_size=16, num_layers=2, num_heads=2,
            intermediate_size=32, max_position_embeddings=16, dropout=0.0)
N, S = 24, 12


def _bert_data():
    rs = np.random.RandomState(12)
    lens = rs.randint(S // 2, S + 1, N)
    return [rs.randint(0, 60, (N, S)), rs.randint(0, 2, (N, S)),
            (np.arange(S)[None] < lens[:, None])[:, None, None, :],
            np.where(rs.rand(N, S) < 0.3, rs.randint(0, 60, (N, S)), -100),
            rs.randint(0, 2, N)]


def _bert_loss(F):
    def loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels):
        mlm = F.cross_entropy(mlm_logits, mlm_labels, reduction="none",
                              ignore_index=-100)
        denom = (mlm_labels != -100).float().sum() \
            if F is ptt.nn.functional else \
            (mlm_labels != -100).astype("float32").sum()
        return mlm.sum() / denom + F.cross_entropy(nsp_logits, nsp_labels)
    return loss


def _model(pkg, net):
    m = pkg.Model(net, labels=["mlm", "nsp"])
    m.prepare(pkg.optimizer.Momentum(0.05, parameters=net.parameters()),
              _bert_loss(pkg.nn.functional))
    return m


def _losses(pkg):
    seen = []

    class Record(pkg.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            seen.append(float(logs["loss"]))
    return Record(), seen


def _port_bert(state):
    net = BertForPretraining(BertConfig(**BERT), device="cpu")
    net.set_state_dict(state)
    return net


def _run(pkg, net, data, workers, shuffle, epochs=2):
    m = _model(pkg, net)
    cb, seen = _losses(pkg)
    ds = pkg.io.TensorDataset(data)
    m.fit(ds, batch_size=8, epochs=epochs, shuffle=shuffle, verbose=0,
          num_workers=workers, callbacks=[cb])
    ev = m.evaluate(ds, batch_size=8, verbose=0, num_workers=workers)
    pred = m.predict(pkg.io.TensorDataset(data[:3]), batch_size=8,
                     num_workers=workers)
    return seen, ev["loss"], [_np(p) for p in pred[0]]


@pytest.fixture(scope="module")
def bert_state():
    from paddle_tpu.models.bert import BertConfig as JBertConfig
    from paddle_tpu.models.bert import BertForPretraining as JBert

    _ref().seed(4)
    ref = JBert(JBertConfig(**BERT))
    return ref, {k: np.asarray(v.numpy()) for k, v in
                 ref.state_dict().items()}


def test_fit_with_workers_is_bitwise_the_in_process_fit(bert_state):
    _, state = bert_state
    data = [torch.from_numpy(np.ascontiguousarray(a)) for a in _bert_data()]
    runs = []
    for workers in (0, 2):
        ptt.seed(7)
        runs.append(_run(ptt, _port_bert(state), data, workers, True))
    (l0, e0, p0), (l2, e2, p2) = runs
    assert len(l0) == 6 and l2 == l0 and e2 == e0
    for a, b in zip(p0, p2):
        np.testing.assert_array_equal(a, b)


def test_fit_with_workers_matches_the_references(bert_state):
    ref, state = bert_state
    data = _bert_data()
    got = _run(ptt, _port_bert(state), [torch.from_numpy(
        np.ascontiguousarray(a)) for a in data], 2, False, epochs=1)
    want = _run(_ref(), ref, data, 2, False, epochs=1)
    np.testing.assert_allclose(got[0], want[0], **FIT_TOL)
    np.testing.assert_allclose(got[1], want[1], **FIT_TOL)
    for a, b in zip(got[2], want[2]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_the_pinning_hook_is_set_only_on_a_cuda_model_and_restored(
        monkeypatch):
    net = ptt.nn.Linear(3, 1)
    model = ptt.Model(net)
    model.prepare(ptt.optimizer.SGD(0.1, parameters=net.parameters()),
                  lambda out, y: ((out[:, 0] - y.float()) ** 2).mean())
    loader = DataLoader(Rows(8), batch_size=4)
    mine = lambda b: b                       # noqa: E731
    loader.placement = mine
    hooks = []

    class Spy(ptt.callbacks.Callback):
        def on_train_batch_begin(self, step, logs=None):
            hooks.append(loader.placement)

    model.fit(loader, epochs=1, verbose=0, callbacks=[Spy()])
    assert hooks == [mine, mine] and loader.placement is mine
    monkeypatch.setattr(ptt.Model, "device",
                        property(lambda self: torch.device("cuda")))
    assert model._pin(loader) is mine
    assert loader.placement is ptt.io.pin_batch
