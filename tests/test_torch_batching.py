"""The port's adaptive batcher (paddle_tpu_torch/serving/engine.py) and the
``Predictor`` under it, on the CPU, against the JAX package's.

* ``BucketSpec``: ``parse``, ``powers_of_two``, ``batch_for``, ``seq_for``
  and ``repr`` equal the reference's over a hypothesis sweep (errors too).
* Rows: the example's BERT (vocab 400, hidden 48, 2 layers, 4 heads, FFN
  96, dropout 0; examples/bert_serving.py) with the reference's weights
  through ``load_numpy_state``, served by both engines on the same
  requests at the same buckets: each row of the port equals the
  reference's row, float32, atol = rtol = 1e-5.  Padded positions are
  attended in both (no mask), so a row is held at its bucket, and the
  port's row is bitwise its direct ``Predictor.run`` of the same padded
  batch.
* ``_unpad``, the ``max_buckets`` ``ValueError``, ``QueueFullError`` on a
  full queue, ``DeadlineExceededError``, cancellation and ``drain``
  behave as the reference's (same duck-typed runners on both).
* Warm-up covers the bucket grid exactly: a predictor counting each new
  signature as a capture counts none after ``start()``, and
  ``compile_count`` stays put.
* A dispatched batch fetches its outputs to the host once (the
  predictor's one packed copy), and the rows handed to futures own their
  bytes.
* The packed buffer layout of the Predictor's graph form (``_pack`` /
  ``_unpack``) round-trips every dtype bitwise.
"""
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import BertModel as JBertModel
from paddle_tpu.serving import BucketSpec as JBucketSpec
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import engine as jengine
from paddle_tpu_torch import inference
from paddle_tpu_torch.models import BertConfig, BertModel, load_numpy_state
from paddle_tpu_torch.serving import (BucketSpec, DeadlineExceededError,
                                      EngineStoppedError, QueueFullError,
                                      ServingEngine)
from paddle_tpu_torch.serving import engine as pengine

BERT = dict(vocab_size=400, hidden_size=48, num_layers=2, num_heads=4,
            intermediate_size=96, max_position_embeddings=64, dropout=0.0)
BUCKETS = "1,2,4x8,16"
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def berts():
    paddle.seed(0)
    jm = JBertModel(JBertConfig(**BERT))
    jm.eval()
    pm = BertModel(BertConfig(**BERT), device="cpu")
    load_numpy_state(pm, {k: np.asarray(v.numpy())
                          for k, v in jm.state_dict().items()})
    return jm, pm.eval()


def _requests(n, seed=0, lo=3, hi=16):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, BERT["vocab_size"], rs.randint(lo, hi + 1))
            for _ in range(n)]


# -- BucketSpec --------------------------------------------------------------

def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


@settings(max_examples=200, deadline=None)
@given(batches=st.lists(st.integers(1, 64), min_size=1, max_size=6),
       seqs=st.one_of(st.none(),
                      st.lists(st.integers(1, 512), min_size=1, max_size=5)),
       n=st.integers(1, 80), s=st.integers(1, 600))
def test_bucket_spec_equals_the_reference(batches, seqs, n, s):
    text = ",".join(map(str, batches))
    if seqs:
        text += "x" + ",".join(map(str, seqs))
    got, want = BucketSpec.parse(text), JBucketSpec.parse(text)
    for a, b in ((got, want),
                 (BucketSpec.powers_of_two(max(batches), seqs),
                  JBucketSpec.powers_of_two(max(batches), seqs))):
        assert (a.batch_sizes, a.seq_lens, a.max_batch, repr(a)) == \
            (b.batch_sizes, b.seq_lens, b.max_batch, repr(b))
        assert a.batch_for(n) == b.batch_for(n)
        assert _outcome(lambda: a.seq_for(s)) == \
            _outcome(lambda: b.seq_for(s))


@pytest.mark.parametrize("text", ["", "  ", "0,2", "1,2x0", "x8"])
def test_bucket_spec_rejects_as_the_reference(text):
    with pytest.raises(ValueError) as want:
        JBucketSpec.parse(text)
    with pytest.raises(ValueError) as got:
        BucketSpec.parse(text)
    assert str(got.value) == str(want.value)


# -- rows against the reference's engine --------------------------------------

class _Recording:
    """Wraps a predictor: keeps each batch it ran and its outputs."""

    def __init__(self, pred):
        self.pred, self.batches = pred, []

    def __getattr__(self, name):
        return getattr(self.pred, name)

    def run(self, arrays):
        outs = self.pred.run(arrays)
        self.batches.append(([a.copy() for a in arrays],
                             [np.array(o, copy=True) for o in outs]))
        return outs


def _serve_all(eng, reqs):
    """Submit every request at once (one flush window), wait for all."""
    with eng:
        futs = [eng.submit([r]) for r in reqs]
        return [f.result(60) for f in futs]


def test_served_rows_match_the_reference_engine(berts):
    jm, pm = berts
    reqs = _requests(7, seed=1)
    kw = dict(batch_timeout_ms=50, buckets=BUCKETS, max_batch_size=4)
    want = _serve_all(JServingEngine(
        jm, input_specs=[((-1, -1), "int32")], **kw),
        [r.astype(np.int32) for r in reqs])
    rec = _Recording(inference.Predictor.from_layer(pm))
    got = _serve_all(ServingEngine(
        rec, input_specs=[((-1, -1), "int64")], **kw),
        [r.astype(np.int64) for r in reqs])
    for r, g, w in zip(reqs, got, want):
        assert len(g) == len(w) == 2          # sequence output, pooled
        assert g[0].shape == (len(r), BERT["hidden_size"])
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, **TOL)
    # each served row is bitwise its row of the recorded batch, and the
    # batch bitwise its direct run at the same bucket (padded positions
    # attended, no mask)
    matched = 0
    for arrays, outs in rec.batches:
        again = rec.pred.run(arrays)
        for o, a in zip(outs, again):
            np.testing.assert_array_equal(o, a)
        for i, row in enumerate(arrays[0]):
            for r, g in zip(reqs, got):
                if np.array_equal(row[:len(r)], r) \
                        and not row[len(r):].any():
                    np.testing.assert_array_equal(g[0], outs[0][i, :len(r)])
                    np.testing.assert_array_equal(g[1], outs[1][i])
                    matched += 1
    assert matched == len(reqs)


def test_padded_rows_are_attended_as_in_the_reference(berts):
    """A row padded from 5 to 8 positions differs from its unpadded run
    in both packages (no attention mask is passed), by the same values."""
    jm, pm = berts
    r = _requests(1, seed=2, lo=5, hi=5)[0]
    jeng = JServingEngine(jm, batch_timeout_ms=1, buckets="1x8",
                          input_specs=[((-1, -1), "int32")])
    peng = ServingEngine(pm, batch_timeout_ms=1, buckets="1x8",
                         input_specs=[((-1, -1), "int64")])
    with jeng, peng:
        want = jeng.predict([r.astype(np.int32)], timeout=60)[0]
        got = peng.predict([r.astype(np.int64)], timeout=60)[0]
    np.testing.assert_allclose(got, want, **TOL)
    with torch.no_grad():
        unpadded = pm(torch.from_numpy(r[None].astype(np.int64)))[0][0]
    assert not np.allclose(got, unpadded.numpy(), atol=1e-4)


def test_warm_up_covers_the_grid_and_nothing_is_captured_after(berts):
    """A predictor counting each new input signature as a capture (the
    card's graph cache) counts the whole grid at start() and no more
    under traffic spanning every bucket."""
    _, pm = berts

    class Counting:
        def __init__(self):
            self.pred = inference.Predictor.from_layer(pm)
            self.seen = set()
            self.compile_count = 0

        def run(self, arrays):
            key = inference.Predictor._bucket_key(arrays)
            if key not in self.seen:
                self.seen.add(key)
                self.compile_count += 1
            return self.pred.run(arrays)

    c = Counting()
    eng = ServingEngine(c, batch_timeout_ms=2, buckets=BUCKETS,
                        input_specs=[((-1, -1), "int64")])
    eng.start()
    warmed = c.compile_count
    assert warmed == 6 == eng.metrics.snapshot()["compile_count"]
    results = {}

    def fire(i, r):
        results[i] = eng.predict([r], timeout=60)

    reqs = [r.astype(np.int64) for r in _requests(16, seed=3)]
    threads = [threading.Thread(target=fire, args=(i, r))
               for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert eng.drain(timeout=60)
    assert len(results) == 16
    assert c.compile_count == warmed
    assert eng.metrics.snapshot()["compile_count"] == warmed


def test_a_batch_fetches_once_and_rows_own_their_bytes(berts, monkeypatch):
    _, pm = berts
    fetches = []
    real = inference._fetch

    def counting(packed):
        fetches.append(packed.shape)
        return real(packed)

    monkeypatch.setattr(inference, "_fetch", counting)
    # one seq bucket (8): one batch
    reqs = [r.astype(np.int64) for r in _requests(3, seed=4, hi=8)]
    eng = ServingEngine(pm, batch_timeout_ms=50, buckets=BUCKETS,
                        input_specs=[((-1, -1), "int64")])
    with eng:
        fetches.clear()
        outs = [f.result(60) for f in [eng.submit([r]) for r in reqs]]
    snap = eng.metrics.snapshot()
    assert snap["batches"] == 1 and len(fetches) == 1
    for o in outs:
        for a in o:
            assert a.base is None and a.flags.owndata


# -- the reference's engine contracts -----------------------------------------

class _BlockingRunner:
    """Duck-typed predictor whose run() blocks until released (pure
    numpy: the same class drives both packages' engines)."""

    def __init__(self):
        self.release = threading.Event()
        self.calls = 0

    def run(self, arrays):
        self.calls += 1
        assert self.release.wait(30)
        return [np.asarray(arrays[0]) * 2.0]


class _Echo:
    def run(self, arrays):
        return [np.asarray(arrays[0]) * 2.0]


def _blocked(Engine, runner, **kw):
    eng = Engine(runner, max_batch_size=1, batch_timeout_ms=0, buckets="1",
                 **kw).start()
    fut = eng.submit([np.ones(2, np.float32)])
    deadline = time.monotonic() + 10
    while runner.calls == 0:  # batcher now blocked inside run()
        assert time.monotonic() < deadline
        time.sleep(0.001)
    return eng, fut


@pytest.mark.parametrize("Engine,Full", [(JServingEngine,
                                          jengine.QueueFullError),
                                         (ServingEngine, QueueFullError)])
def test_queue_full(Engine, Full):
    runner = _BlockingRunner()
    eng, first = _blocked(Engine, runner, queue_depth=2)
    try:
        ok = [eng.submit([np.ones(2, np.float32)]) for _ in range(2)]
        with pytest.raises(Full, match="capacity"):
            eng.submit([np.ones(2, np.float32)])
        assert eng.metrics.counters["rejected_queue_full"] == 1
        runner.release.set()
        for f in [first] + ok:
            np.testing.assert_array_equal(f.result(10)[0],
                                          np.full(2, 2.0, np.float32))
    finally:
        runner.release.set()
        eng.stop()


@pytest.mark.parametrize("Engine,Expired", [
    (JServingEngine, jengine.DeadlineExceededError),
    (ServingEngine, DeadlineExceededError)])
def test_deadline_and_cancel(Engine, Expired):
    runner = _BlockingRunner()
    eng, first = _blocked(Engine, runner, queue_depth=8)
    try:
        doomed = eng.submit([np.ones(2, np.float32)], deadline_ms=30)
        victim = eng.submit([np.ones(2, np.float32)])
        assert victim.cancel()
        time.sleep(0.08)          # the deadline passes while blocked
        runner.release.set()
        first.result(10)
        with pytest.raises(Expired):
            doomed.result(10)
        assert eng.drain(timeout=10)
        assert victim.cancelled()
        counters = dict(eng.metrics.counters)
    finally:
        runner.release.set()
        eng.stop()
    assert runner.calls == 1
    assert (counters["deadline_expired"], counters["cancelled"]) == (1, 1)


@pytest.mark.parametrize("Engine,Stopped", [
    (JServingEngine, jengine.EngineStoppedError),
    (ServingEngine, EngineStoppedError)])
def test_drain_rejects_new_work(Engine, Stopped):
    eng = Engine(_Echo(), max_batch_size=1, batch_timeout_ms=0,
                 buckets="1").start()
    out = eng.predict([np.ones(2, np.float32)], timeout=10)[0]
    np.testing.assert_array_equal(out, np.full(2, 2.0, np.float32))
    assert eng.drain(timeout=10) is True
    assert eng.draining
    with pytest.raises(Stopped, match="draining"):
        eng.submit([np.ones(2, np.float32)])
    eng.stop()
    assert eng.metrics.counters["rejected_draining"] == 1


@pytest.mark.parametrize("Engine", [JServingEngine, ServingEngine])
def test_max_buckets(Engine):
    eng = Engine(_Echo(), max_batch_size=1, batch_timeout_ms=0, buckets="1",
                 queue_depth=8, max_buckets=2).start()
    try:
        eng.predict([np.ones(2, np.float32)], timeout=10)
        eng.predict([np.ones(3, np.float32)], timeout=10)
        with pytest.raises(ValueError, match="max_buckets=2"):
            eng.submit([np.ones(4, np.float32)])
        out = eng.predict([np.ones(2, np.float32)], timeout=10)[0]
        np.testing.assert_array_equal(out, np.full(2, 2.0, np.float32))
    finally:
        eng.stop()


@pytest.mark.parametrize("Engine", [JServingEngine, ServingEngine])
def test_a_failing_batch_fails_its_futures_not_the_engine(Engine):
    class Exploding:
        calls = 0

        def run(self, arrays):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("boom")
            return [np.asarray(arrays[0]) * 2.0]

    eng = Engine(Exploding(), max_batch_size=1, batch_timeout_ms=0,
                 buckets="1").start()
    try:
        with pytest.raises(RuntimeError, match="boom"):
            eng.predict([np.ones(2, np.float32)], timeout=10)
        out = eng.predict([np.ones(2, np.float32)], timeout=10)[0]
        np.testing.assert_array_equal(out, np.full(2, 2.0, np.float32))
    finally:
        eng.stop()
    assert eng.metrics.counters["errors"] == 1


_UNPAD_CASES = [
    # (input sample shape, orig len, output row shape, unpad_outputs)
    ((8, 2), 5, (8, 2), True),       # sliced back to 5
    ((8, 2), 5, (8, 3), True),       # a different width: still sliced
    ((8,), 5, (8,), True),
    ((8, 2), 5, (8,), True),         # lower rank: untouched
    ((8, 2), 5, (3, 2), True),       # padded dim absent: untouched
    ((8, 2), 8, (8, 2), True),       # no padding
    ((8, 2), 5, (8, 2), False),      # unpad off
]


@pytest.mark.parametrize("case", _UNPAD_CASES)
def test_unpad_equals_the_reference(case):
    shape, orig, out_shape, unpad = case
    out = np.arange(int(np.prod(out_shape)), dtype=np.float32).reshape(
        out_shape)
    res = []
    for Engine, Req in ((JServingEngine, jengine._Request),
                        (ServingEngine, pengine._Request)):
        eng = Engine(_Echo(), buckets="1,2x8", unpad_outputs=unpad)
        req = Req([np.zeros(shape, np.float32)], [orig], None, None)
        res.append(eng._unpad(out, req))
    np.testing.assert_array_equal(res[0], res[1])
    assert res[0].shape == res[1].shape


@pytest.mark.parametrize("Engine", [JServingEngine, ServingEngine])
def test_fixed_seq_dim_pads_only_to_itself(Engine):
    eng = Engine(_Echo(), batch_timeout_ms=1, buckets="1,2x4,8",
                 input_specs=[((-1, 8, 2), "float32")]).start()
    try:
        with pytest.raises(ValueError, match="dim 0"):
            eng.submit([np.zeros((3, 2), np.float32)])   # bucket 4 != 8
        out, = eng.predict([np.zeros((5, 2), np.float32)], timeout=10)
        assert out.shape == (5, 2)
        with pytest.raises(ValueError, match="rank"):
            eng.submit([np.zeros((5,), np.float32)])
    finally:
        eng.stop()


# -- the Predictor --------------------------------------------------------------

@pytest.mark.parametrize("dtypes", [
    (torch.float32,), (torch.float32, torch.int64),
    (torch.bfloat16, torch.bool, torch.float16, torch.int32),
    (torch.uint8, torch.float64)])
def test_pack_round_trips_bitwise(dtypes):
    g = torch.Generator().manual_seed(0)
    shapes = [(3, 5), (), (7,), (2, 1, 3)]
    outs = []
    for dt, shape in zip(dtypes, shapes):
        x = torch.randn(shape, generator=g) * 100
        outs.append(x > 0 if dt == torch.bool else x.to(dt))
    packed, meta = inference._pack(outs)
    assert packed.dtype == torch.uint8 and packed.numel() % 16 == 0
    back = inference._unpack(inference._fetch(packed), meta)
    for o, b in zip(outs, back):
        want = o.float().numpy() if o.dtype == torch.bfloat16 else o.numpy()
        assert b.shape == tuple(o.shape) and b.dtype == want.dtype
        np.testing.assert_array_equal(b, want)


def test_predictor_surface_matches_the_reference(berts):
    jm, pm = berts
    ids = _requests(1, seed=5, lo=8, hi=8)[0][None]
    jp = jinference.Predictor.from_layer(jm)
    pp = inference.Predictor.from_layer(pm)
    want = jp.run([ids.astype(np.int32)])
    got = pp.run([ids.astype(np.int64)])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    assert pp.get_input_names() == jp.get_input_names() == ["x0"]
    assert pp.get_output_names() == jp.get_output_names() == ["out0", "out1"]
    # the zero-copy handle path
    pp.get_input_handle("x0").copy_from_cpu(ids.astype(np.int64))
    out_h = pp.get_output_handle("out0")
    again = pp.run()
    np.testing.assert_array_equal(again[0], got[0])
    np.testing.assert_array_equal(out_h.copy_to_cpu(), got[0])
    assert pp.warm([(2, 8)], ["int64"]) is True
    assert pp.compile_count == 0        # the CPU runs eagerly


def test_export_paths_are_not_ported_yet():
    with pytest.raises(NotImplementedError, match="A11"):
        inference.Config("some/prefix")
    with pytest.raises(NotImplementedError, match="A11"):
        inference.create_predictor("some/prefix")
    with pytest.raises(NotImplementedError, match="A11"):
        ServingEngine("some/prefix")
