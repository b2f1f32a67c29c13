"""Adaptive-batching serving engine over the Predictor (port of
paddle_tpu/serving/engine.py, whole).

Concurrent requests land on a bounded queue; a batcher thread coalesces
them into padded fixed-shape batches drawn from a finite bucket grid
(batch × sequence), and one captured CUDA graph per bucket (the port's
``inference.Predictor``) amortizes across users.  Every bucket is captured
at ``start()``, so steady-state serving never captures.

Contracts:
  * per-request ``concurrent.futures.Future`` — deadline expiry and
    cancellation drop a request *before* it wastes a batch slot
  * bounded queue — ``submit`` raises :class:`QueueFullError` instead of
    buffering unboundedly (backpressure is the client's signal to shed)
  * padding — batch slots are padded with ``pad_value`` rows and peeled
    off row-wise; a padded sequence dim is sliced back to the request's
    original length.  No attention mask is passed: a model attends to the
    padded positions, so a served row equals the run of the same padded
    batch at the same bucket shape (bitwise on the card: a GEMM may take
    another algorithm at another batch size, so a batch-1 run agrees only
    within a tolerance)
  * one device-to-host copy a batch — the predictor fetches the batch's
    outputs once; each request's rows are copied out of that host batch,
    so they own their bytes
  * graceful drain — ``drain()`` rejects new work, flushes everything
    queued, and completes every in-flight future (the SIGTERM path in
    serving/server.py reuses distributed/resilience.py's latch pattern)
  * chaos hooks — each dispatched batch passes through
    ``utils.chaos.on_step``, so crash/preempt/slow injection exercises
    the serving recovery paths exactly like the training runtime's
"""
from __future__ import annotations

import concurrent.futures
import logging
import queue
import threading
import time

import numpy as np
from torch.profiler import record_function

from ..framework import flags as _flags
from ..framework.dtype import dtype_name
from ..monitor import tracing as _tracing
from ..utils import chaos
from .metrics import ServingMetrics

logger = logging.getLogger("paddle_tpu_torch.serving")

__all__ = ["BucketSpec", "ServingEngine", "QueueFullError",
           "DeadlineExceededError", "EngineStoppedError"]


class QueueFullError(RuntimeError):
    """Backpressure: the request queue is at capacity — shed or retry."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before a batch could serve it."""


class EngineStoppedError(RuntimeError):
    """submit() after drain()/stop() — the engine no longer accepts work."""


class BucketSpec:
    """Finite shape-bucket grid: batch sizes × optional sequence lengths.

    String form (``FLAGS_serving_buckets``): ``"1,2,4,8"`` (batch only)
    or ``"1,2,4,8x16,32,64"`` (batch × sequence).  A request is padded UP
    to the smallest bucket that fits; oversized requests are rejected at
    submit.  Keeping the grid finite is what makes warmup exhaustive and
    steady-state serving capture-free.
    """

    def __init__(self, batch_sizes, seq_lens=None):
        self.batch_sizes = sorted(set(int(b) for b in batch_sizes))
        if not self.batch_sizes or self.batch_sizes[0] < 1:
            raise ValueError(f"invalid batch buckets {batch_sizes!r}")
        self.seq_lens = (sorted(set(int(s) for s in seq_lens))
                         if seq_lens else None)
        if self.seq_lens and self.seq_lens[0] < 1:
            raise ValueError(f"invalid seq buckets {seq_lens!r}")

    @classmethod
    def parse(cls, spec: str) -> "BucketSpec":
        spec = (spec or "").strip()
        if not spec:
            raise ValueError("empty bucket spec")
        batch_part, _, seq_part = spec.partition("x")
        batches = [int(s) for s in batch_part.split(",") if s.strip()]
        seqs = [int(s) for s in seq_part.split(",") if s.strip()] \
            if seq_part else None
        return cls(batches, seqs)

    @classmethod
    def powers_of_two(cls, max_batch: int, seq_lens=None) -> "BucketSpec":
        sizes, b = [], 1
        while b < max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(int(max_batch))
        return cls(sizes, seq_lens)

    @property
    def max_batch(self) -> int:
        return self.batch_sizes[-1]

    def batch_for(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.max_batch

    def seq_for(self, s: int):
        if self.seq_lens is None:
            return s
        for q in self.seq_lens:
            if q >= s:
                return q
        raise ValueError(f"sequence length {s} exceeds the largest bucket "
                         f"{self.seq_lens[-1]}")

    def __repr__(self):
        seq = ",".join(map(str, self.seq_lens)) if self.seq_lens else "-"
        return (f"BucketSpec(batch={','.join(map(str, self.batch_sizes))}, "
                f"seq={seq})")


class _Request:
    __slots__ = ("inputs", "orig_lens", "key", "future", "t_enqueue",
                 "deadline", "span", "own_span", "span_queue", "span_exec")

    def __init__(self, inputs, orig_lens, key, deadline, span=None,
                 own_span=False):
        self.inputs = inputs
        self.orig_lens = orig_lens     # per-input pre-pad seq length
        self.key = key                 # padded shape signature = bucket
        self.future = concurrent.futures.Future()
        self.t_enqueue = time.monotonic()
        self.deadline = deadline       # absolute monotonic time or None
        self.span = span               # request span (tracing), or None
        self.own_span = own_span       # engine-rooted: engine ends it
        self.span_queue = None         # live "serve.queued" child
        self.span_exec = None          # live "serve.execute" child

    def end_spans(self, status: str):
        """Terminal span cleanup for early exits (deadline, cancel,
        drain): close any live child, and the root if the engine owns
        it (server-owned roots are ended by the HTTP handler)."""
        for s in (self.span_queue, self.span_exec):
            if s is not None:
                s.end(status=status)
        self.span_queue = self.span_exec = None
        if self.span is not None:
            self.span.set_attr("status", status)
            if self.own_span:
                self.span.end()
            self.span = None


_WAKE = object()   # queue sentinel: wakes an idle-blocked batcher


def _as_predictor(model):
    """Accept a Predictor or an in-memory Layer; anything else with a
    .run(list)->list method is used as-is (test seam).  An export
    prefix/Config needs the export format (not ported yet: raises)."""
    from .. import inference
    from ..nn.layer_base import Layer

    if isinstance(model, Layer):
        return inference.Predictor.from_layer(model)
    if isinstance(model, (str, inference.Config)):
        return inference.create_predictor(model)
    if hasattr(model, "run"):
        return model
    raise TypeError(f"cannot serve a {type(model).__name__}; pass a "
                    "Predictor or nn.Layer")


class ServingEngine:
    """Coalesces concurrent requests into padded fixed-shape batches.

    Args:
      model: Predictor | nn.Layer (an export prefix / Config raises until
        the export format is ported).
      max_batch_size / batch_timeout_ms / queue_depth: adaptive-batcher
        knobs; default from ``FLAGS_serving_max_batch`` /
        ``FLAGS_serving_timeout_ms`` / ``FLAGS_serving_queue_depth``.
      buckets: BucketSpec or its string form (``FLAGS_serving_buckets``);
        default = powers of two up to max_batch_size, no seq bucketing.
      seq_axis: per-sample axis padded to the sequence bucket (batch axis
        excluded — requests are single samples).
      pad_value: fill for padded slots/positions.
      input_specs: [(shape, dtype), ...] *with* the batch dim (e.g.
        ``[((-1, 128), "int64")]``) used for warmup; defaults to the
        predictor's export manifest.

    Lifecycle: ``start()`` warms every bucket (on the card: captures its
    CUDA graph, so serving never captures), ``submit()``/``predict()`` serve, ``drain()`` finishes
    in-flight work and rejects new requests, ``stop()`` kills the
    batcher.  Usable as a context manager.
    """

    def __init__(self, model, *, max_batch_size=None, batch_timeout_ms=None,
                 queue_depth=None, buckets=None, seq_axis=0, pad_value=0,
                 input_specs=None, warmup=True, unpad_outputs=True,
                 max_buckets=32):
        self._predictor = _as_predictor(model)
        max_batch_size = int(max_batch_size
                             or _flags.flag("FLAGS_serving_max_batch", 8))
        if batch_timeout_ms is None:
            batch_timeout_ms = float(
                _flags.flag("FLAGS_serving_timeout_ms", 5.0))
        if buckets is None:
            buckets = _flags.flag("FLAGS_serving_buckets", "") or None
        if isinstance(buckets, str):
            buckets = BucketSpec.parse(buckets)
        self.buckets = buckets or BucketSpec.powers_of_two(max_batch_size)
        self.batch_timeout_s = max(0.0, batch_timeout_ms / 1e3)
        self.queue_depth = int(queue_depth
                               or _flags.flag("FLAGS_serving_queue_depth",
                                              256))
        self.seq_axis = int(seq_axis)
        self.pad_value = pad_value
        self.unpad_outputs = unpad_outputs
        # Hard cap on DISTINCT shape signatures ever admitted: without
        # input specs there is no submit-time shape validation, and each
        # new signature costs one CUDA graph kept forever — untrusted
        # traffic cycling shapes must hit a ValueError, not a capture
        # storm with unbounded graph memory.
        self.max_buckets = int(max_buckets)
        self._seen_keys: set = set()
        self._warmup = warmup
        self._input_specs = self._resolve_specs(input_specs)

        self.metrics = ServingMetrics()
        self._queue: queue.Queue[_Request] = queue.Queue(self.queue_depth)
        self._pending: dict[tuple, list[_Request]] = {}
        self._thread = None
        self._started = False
        self._draining = False
        self._stopped = False
        self._idle = threading.Event()   # queue + pending empty
        self._idle.set()
        self._batch_seq = 0

    # -- setup -------------------------------------------------------------
    def _resolve_specs(self, input_specs):
        if input_specs is None:
            input_specs = getattr(self._predictor, "_input_specs", None)
            if input_specs is not None:
                input_specs = [(tuple(s["shape"]), s["dtype"])
                               for s in input_specs]
            return input_specs
        out = []
        for s in input_specs:
            if isinstance(s, (tuple, list)) and len(s) == 2 \
                    and not np.isscalar(s[0]):
                shape, dtype = s
            else:  # InputSpec-like
                shape, dtype = s.shape, s.dtype
            out.append((tuple(int(d) if d is not None else -1
                              for d in shape), np.dtype(dtype_name(dtype))))
        return out

    def start(self) -> "ServingEngine":
        if self._started:
            return self
        if self._warmup:
            self.warm()
        self._started = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="paddle-serving-batcher")
        self._thread.start()
        return self

    def warm(self):
        """Warm every (batch × seq) bucket (on the card: capture its CUDA
        graph) so steady-state serving never captures.  No-op without
        input specs (a Layer-backed engine then captures lazily, once per
        bucket, on first traffic)."""
        if not self._input_specs:
            logger.warning("serving warmup skipped: no input specs "
                           "(pass input_specs= to capture buckets ahead of traffic)")
            return 0
        seqs = self.buckets.seq_lens or [None]
        seen = set()
        warmed = 0
        for b in self.buckets.batch_sizes:
            for s in seqs:
                arrays = []
                ok = True
                for shape, dtype in self._input_specs:
                    sample = list(shape[1:])
                    if s is not None and len(sample) > self.seq_axis:
                        if sample[self.seq_axis] in (-1, s):
                            sample[self.seq_axis] = s
                    if any(d < 0 for d in sample):
                        ok = False  # non-seq dynamic dim: cannot warm
                        break
                    arrays.append(np.zeros([b] + sample,
                                           np.dtype(dtype)))
                if not ok:
                    logger.warning("serving warmup skipped for bucket "
                                   "(%d, %s): unresolved dynamic dim", b, s)
                    continue
                key = tuple((a.shape, str(a.dtype)) for a in arrays)
                if key in seen:   # fixed seq dim: several seq buckets
                    continue      # resolve to one shape — warm it once
                seen.add(key)
                # per-request signatures drop the batch dim
                self._seen_keys.add(tuple(
                    ((a.shape[1:]), str(a.dtype)) for a in arrays))
                with record_function("paddle.serve/warmup"):
                    self._predictor.run(arrays)
                warmed += 1
        self._sync_compile_count()
        logger.info("serving warmup made %d bucket(s): %s", warmed,
                    self.buckets)
        return warmed

    def _sync_compile_count(self):
        n = getattr(self._predictor, "compile_count", None)
        if n is not None:
            self.metrics.set_compile_count(n)

    # -- request intake ----------------------------------------------------
    def _prepare(self, inputs):
        """Single-sample arrays → (padded arrays, orig seq lens, group
        key).  The group key is the padded per-sample signature — one key
        == one bucket graph."""
        # intake converts host payloads (lists / client numpy), never
        # device buffers
        arrays = [np.asarray(x) for x in inputs]
        if self._input_specs:
            if len(arrays) != len(self._input_specs):
                raise ValueError(
                    f"expected {len(self._input_specs)} inputs, got "
                    f"{len(arrays)}")
            for j, (a, (shape, _dt)) in enumerate(
                    zip(arrays, self._input_specs)):
                sample = shape[1:]  # requests carry no batch dim
                if a.ndim != len(sample):
                    raise ValueError(
                        f"inputs[{j}] has rank {a.ndim}, expected rank "
                        f"{len(sample)} (sample shape {list(sample)})")
                for k, d in enumerate(sample):
                    if d > 0 and a.shape[k] != d:
                        # a short seq may pad UP to a FIXED export dim,
                        # but only when the bucket it lands in IS that
                        # dim — any other bucket is a shape the artifact
                        # cannot serve and warm() never captured
                        if (k == self.seq_axis
                                and self.buckets.seq_lens is not None
                                and a.shape[k] < d
                                and self.buckets.seq_for(a.shape[k]) == d):
                            continue
                        raise ValueError(
                            f"inputs[{j}] dim {k} is {a.shape[k]}, "
                            f"expected {d}")
        padded, orig = [], []
        for a in arrays:
            orig.append(a.shape[self.seq_axis]
                        if a.ndim > self.seq_axis else None)
            if self.buckets.seq_lens is not None \
                    and a.ndim > self.seq_axis:
                want = self.buckets.seq_for(a.shape[self.seq_axis])
                if want != a.shape[self.seq_axis]:
                    pad = [(0, 0)] * a.ndim
                    pad[self.seq_axis] = (0, want - a.shape[self.seq_axis])
                    a = np.pad(a, pad, constant_values=self.pad_value)
            padded.append(a)
        key = tuple((a.shape, str(a.dtype)) for a in padded)
        if key not in self._seen_keys:
            if len(self._seen_keys) >= self.max_buckets:
                raise ValueError(
                    f"shape signature {key} would exceed max_buckets="
                    f"{self.max_buckets} distinct serving shapes — fix "
                    "the client, pass input_specs for validation, or "
                    "raise max_buckets")
            self._seen_keys.add(key)
        return padded, orig, key

    def submit(self, inputs, deadline_ms=None, span=None) \
            -> concurrent.futures.Future:
        """Enqueue one request (a list of single-sample arrays, NO batch
        dim).  Returns a Future resolving to the per-request output list.
        Raises QueueFullError under backpressure and EngineStoppedError
        once draining/stopped.

        `span=` joins the request to a caller-owned trace span (the HTTP
        layer passes its server span); without one, a direct API caller
        gets a head-sampled engine root span."""
        if self._draining or self._stopped:
            self.metrics.count("rejected_draining")
            raise EngineStoppedError("serving engine is draining — no new "
                                     "requests accepted")
        if not self._started:
            raise EngineStoppedError("serving engine not started — call "
                                     "start()")
        padded, orig, key = self._prepare(
            inputs if isinstance(inputs, (list, tuple)) else [inputs])
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        own_span = False
        if span is None:
            tracer = _tracing.default_tracer()
            if tracer.enabled:
                span = tracer.start_span("serve.request")
                own_span = True
        if span is not None and not span.sampled:
            span, own_span = None, False
        req = _Request(padded, orig, key, deadline, span=span,
                       own_span=own_span)
        if span is not None:
            # child spans MUST attach before enqueue: the batcher may
            # claim the request the instant it lands on the queue
            req.span_queue = span.child("serve.queued")
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            req.end_spans("rejected_queue_full")
            self.metrics.count("rejected_queue_full")
            raise QueueFullError(
                f"serving queue at capacity ({self.queue_depth}); retry "
                "with backoff") from None
        self._idle.clear()
        self.metrics.count("accepted")
        return req.future

    def predict(self, inputs, timeout=None, deadline_ms=None):
        """Synchronous convenience: submit + wait."""
        return self.submit(inputs, deadline_ms=deadline_ms).result(timeout)

    # -- the batcher loop --------------------------------------------------
    def _wake(self):
        """Nudge a batcher blocked on an empty queue (drain/stop path).
        A full queue is by definition non-empty — the batcher is awake."""
        try:
            self._queue.put_nowait(_WAKE)
        except queue.Full:
            pass

    def _run(self):
        tick = max(5e-4, min(self.batch_timeout_s / 4.0, 0.005)) \
            if self.batch_timeout_s else 5e-4
        while True:
            # idle (nothing pending, not shutting down): block with NO
            # timeout — zero wakeups under zero traffic.  The tick poll
            # only runs while a partial batch awaits its flush deadline.
            block = (not self._pending
                     and not (self._draining or self._stopped))
            try:
                req = self._queue.get(timeout=None if block else tick)
            except queue.Empty:
                req = None
            if req is not None:
                if req is not _WAKE:
                    self._route(req)
                while True:  # drain whatever else arrived this tick
                    try:
                        r2 = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if r2 is not _WAKE:
                        self._route(r2)
            self._sweep_deadlines()
            now = time.monotonic()
            for key in list(self._pending):
                lst = self._pending[key]
                while len(lst) >= self.buckets.max_batch:
                    self._dispatch(key, lst[:self.buckets.max_batch])
                    del lst[:self.buckets.max_batch]
                if lst and (self._draining or self._stopped
                            or now - lst[0].t_enqueue
                            >= self.batch_timeout_s):
                    self._dispatch(key, lst)
                    lst.clear()
                if not lst:
                    del self._pending[key]
            if not self._pending and self._queue.empty():
                self._idle.set()
                if self._draining or self._stopped:
                    return

    def _route(self, req: _Request):
        self._pending.setdefault(req.key, []).append(req)

    def _sweep_deadlines(self):
        now = time.monotonic()
        for lst in self._pending.values():
            keep = []
            for r in lst:
                if r.future.done():   # client-side cancel: just drop it
                    self.metrics.count("cancelled")
                    r.end_spans("cancelled")
                elif r.deadline is not None and now > r.deadline:
                    self.metrics.count("deadline_expired")
                    r.end_spans("deadline_expired")
                    r.future.set_exception(DeadlineExceededError(
                        "request deadline passed while queued"))
                else:
                    keep.append(r)
            lst[:] = keep

    def _dispatch(self, key, reqs):
        # claim futures; a cancelled request never occupies a slot
        live = []
        for r in reqs:
            if r.future.set_running_or_notify_cancel():
                live.append(r)
            else:
                self.metrics.count("cancelled")
                r.end_spans("cancelled")
        if not live:
            return
        self._batch_seq += 1
        now = time.monotonic()
        for r in live:
            self.metrics.observe_queue_wait(now - r.t_enqueue)
            # queued → dispatched transition (host timestamps only —
            # this is the engine's hot path)
            if r.span_queue is not None:
                r.span_queue.end()
                r.span_queue = None
            if r.span is not None:
                r.span_exec = r.span.child("serve.execute",
                                           batch=len(live),
                                           batch_seq=self._batch_seq)
        try:
            chaos.on_step(self._batch_seq)  # fault injection seam
            bucket_b = self.buckets.batch_for(len(live))
            arrays = []
            for j in range(len(live[0].inputs)):
                rows = np.stack([r.inputs[j] for r in live])
                if bucket_b > len(live):
                    fill = np.full((bucket_b - len(live),) + rows.shape[1:],
                                   self.pad_value, rows.dtype)
                    rows = np.concatenate([rows, fill], axis=0)
                arrays.append(rows)
            with record_function("paddle.serve/batch"):
                outs = self._predictor.run(arrays)
        except Exception as e:  # noqa: BLE001 - fail THIS batch, keep serving
            self.metrics.count("errors", len(live))
            logger.exception("serving batch %d failed", self._batch_seq)
            for r in live:
                r.end_spans("error")
                if not r.future.done():
                    r.future.set_exception(e)
            return
        try:
            # waste accounting in elements: padded batch slots AND padded
            # sequence positions both count against the ratio
            total_elems = sum(int(a.size) for a in arrays)
            real_elems = 0
            for r in live:
                for j, a in enumerate(r.inputs):
                    e = int(a.size)
                    orig = r.orig_lens[j]
                    if orig is not None and a.ndim > self.seq_axis \
                            and a.shape[self.seq_axis]:
                        e = e * orig // a.shape[self.seq_axis]
                    real_elems += e
            self.metrics.observe_batch(len(live), bucket_b, real_elems,
                                       total_elems)
            self._sync_compile_count()
            done_t = time.monotonic()
            # the predictor fetched the batch to the host in one copy
            # (its graph's static output is overwritten by the next
            # replay); each request's rows are copied out of that host
            # batch so they own their bytes — a view would pin the whole
            # [bucket_b, ...] batch per request
            host_outs = [np.asarray(o) for o in outs]
            for i, r in enumerate(live):
                row = [np.array(self._unpad(o[i], r), copy=True)
                       for o in host_outs]
                # stop() may have failed this future while the batch was
                # on the device — a done future is not re-resolved
                if not r.future.done():
                    r.future.set_result(row)
                    self.metrics.observe_completion(done_t - r.t_enqueue)
                r.end_spans("ok")
        except Exception as e:  # noqa: BLE001 - e.g. an output without the
            # batch dim: fail this batch's unresolved futures, never the
            # batcher thread (the engine's single point of failure)
            logger.exception("serving batch %d result distribution failed",
                             self._batch_seq)
            for r in live:
                r.end_spans("error")
                if not r.future.done():
                    self.metrics.count("errors")
                    r.future.set_exception(e)

    def _unpad(self, out, req: _Request):
        """Slice a padded sequence dim back to the request's original
        length.  Only fires when seq bucketing actually padded, on
        outputs of at least the padded input's rank that carry the
        padded dim at seq_axis (a lower-rank pooled output — e.g. class
        logits whose size happens to equal the bucket — is never
        sliced).  Set ``unpad_outputs=False`` for models whose outputs
        don't follow the input's sequence layout."""
        if self.buckets.seq_lens is None or not self.unpad_outputs:
            return out
        for j, orig in enumerate(req.orig_lens):
            if orig is None:
                continue
            padded = req.inputs[j].shape[self.seq_axis]
            if padded != orig and out.ndim >= req.inputs[j].ndim \
                    and out.ndim > self.seq_axis \
                    and out.shape[self.seq_axis] == padded:
                sl = [slice(None)] * out.ndim
                sl[self.seq_axis] = slice(0, orig)
                return out[tuple(sl)]
        return out

    # -- shutdown ----------------------------------------------------------
    def drain(self, timeout=None) -> bool:
        """Graceful: reject new work, flush every queued request, wait
        for all in-flight futures, stop the batcher.  Returns True when
        fully drained."""
        self._draining = True
        if self._thread is None:
            return True
        self._wake()
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        drained = self._idle.wait(timeout)
        # one budget for the WHOLE drain: join only gets what wait left
        self._thread.join(None if deadline is None
                          else max(0.0, deadline - time.monotonic()))
        alive = self._thread.is_alive()
        if not alive:
            self._thread = None
        # a submit racing the drain flag can slip one request into the
        # queue after the batcher's final empty-check — fail it rather
        # than leaving its future pending forever
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is _WAKE:
                continue
            drained = False
            if not req.future.done():
                req.future.set_exception(EngineStoppedError(
                    "request arrived during drain"))
        return drained and not alive

    def stop(self):
        """Hard stop: fail everything still queued, stop the batcher."""
        self._stopped = True
        self._draining = True
        thread = self._thread
        batcher_alive = False
        if thread is not None:
            self._wake()
            thread.join(5.0)
            batcher_alive = thread.is_alive()
            if not batcher_alive:
                self._thread = None
        # the queue is thread-safe — always safe to fail leftovers (the
        # done() guards make a benign race with the batcher harmless)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is _WAKE:
                continue
            if not req.future.done():
                req.future.set_exception(
                    EngineStoppedError("engine stopped"))
        if batcher_alive:
            # a batch is still on the device: _pending belongs to
            # the batcher thread — touching it here would race its own
            # mutations.  It sees _stopped when the batch returns,
            # flushes what's left, and exits.
            logger.warning("stop(): batcher still executing a batch; its "
                           "remaining requests resolve when it returns")
            return
        for lst in self._pending.values():
            for r in lst:
                if not r.future.done():
                    r.future.set_exception(
                        EngineStoppedError("engine stopped"))
        self._pending.clear()

    @property
    def draining(self) -> bool:
        return self._draining

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        if exc[0] is None:
            self.drain(timeout=30.0)
        self.stop()
        return False
