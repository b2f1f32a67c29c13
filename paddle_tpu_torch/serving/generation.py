"""Continuous-batching autoregressive generation engine over a paged KV
cache (port of paddle_tpu/serving/generation.py, the prefix-miss path).

* **prefill/decode split** — each admitted prompt runs ONE
  ``slot_prefill`` (padded to its prompt bucket) that fills freshly mapped
  pages of the device-resident paged KV cache; then one ``step()``
  advances ALL in-flight sequences a token per iteration through
  ``slot_decode_paged``, popping a tail page on the device as a lane
  crosses a page boundary.
* **continuous batching** — queued requests are admitted into free slots
  at iteration boundaries once the page pool can reserve their worst
  case; lanes retire on EOS / max_new_tokens (their pages return to the
  pool in the same step) and are preempted on deadline / cancellation.
  The decode step always runs all ``max_slots`` lanes, so a lane's
  arithmetic does not depend on which other lanes are live: a request
  admitted mid-decode produces the tokens it would alone.
* **in place, one copy per step** — the reference AOT-compiles every
  transition and donates the decode state; PyTorch runs eagerly, so the
  state tensors are allocated once at ``start()`` and updated in place
  (serving/kv_cache.py).  Each ``step()`` ends in ONE device-to-host copy
  of the sampled tokens and the finished mask together; admission fetches
  the first token.  No per-lane ``.item()``.

Sampling is greedy (argmax of the raw logits) or temperature / top-k
categorical.  JAX's per-slot threefry chain cannot be reproduced in
PyTorch: each request draws from its own ``torch.Generator`` on the
engine's device, seeded from the request's seed, once at admission and
once per decode step — deterministic per seed and independent of batch
mates.  Top-k keeps the reference's ``lg2 < kth`` rule, so ties at the
k-th value survive.

Not ported yet (ROADMAP.md): the prefix cache, speculative decode,
chunked prefill, tensor-parallel serving, tracing spans, ``op_report``
and ``resume_pos`` failover.
"""
from __future__ import annotations

import collections
import logging
import queue
import threading
import time

import numpy as np
import torch

from ..framework import flags as _flags
from ..framework.place import resolve_device
from ..framework.random import make_generator
from .engine import DeadlineExceededError, EngineStoppedError, QueueFullError
from .kv_cache import (CacheGeometry, admit_slot, make_state, release_slots,
                       take_pages, write_prompt)
from .metrics import GenerationMetrics
from .scheduler import SlotScheduler

logger = logging.getLogger("paddle_tpu_torch.serving")

__all__ = ["GenerationEngine", "GenerationHandle", "sample_tokens"]

_WAKE = object()   # queue sentinel: wakes an idle-blocked decode loop
_END = object()    # handle sentinel: no more tokens


class GenerationHandle:
    """Per-request streaming face: tokens arrive as the decode loop
    produces them; iterate (``for tok in handle``), poll
    (``next_token``), or block for everything (``result``)."""

    def __init__(self, prompt_len: int, max_new_tokens: int):
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.tokens: list[int] = []       # appended by the decode thread
        self._q: queue.Queue = queue.Queue()
        self._done = threading.Event()
        self._error: BaseException | None = None
        self._req = None                  # backref set by the engine
        self.t_submit = time.monotonic()

    def next_token(self, timeout=None):
        """Next generated token id, or None when the stream has ended
        (raises the request's error, if it failed)."""
        if self._done.is_set() and self._q.empty():
            if self._error is not None:
                raise self._error
            return None
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(f"no token within {timeout:g}s") from None
        if item is _END:
            if self._error is not None:
                raise self._error
            return None
        return item

    def __iter__(self):
        while True:
            tok = self.next_token()
            if tok is None:
                return
            yield tok

    def result(self, timeout=None) -> list[int]:
        """Block until the request finishes; the generated token ids
        (prompt excluded).  Raises on deadline expiry / engine failure."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"generation not finished in {timeout:g}s")
        if self._error is not None:
            raise self._error
        return list(self.tokens)

    def cancel(self):
        """Ask the engine to preempt this request at the next iteration
        boundary (its slot is freed; tokens produced so far remain)."""
        req = self._req
        if req is not None:
            req.cancelled = True
            req.engine._wake()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def error(self):
        return self._error

    def _push(self, tok: int):
        self.tokens.append(tok)
        self._q.put(tok)

    def _finish(self, error: BaseException | None = None):
        if self._done.is_set():
            return
        self._error = error
        self._done.set()
        self._q.put(_END)


class _GenRequest:
    __slots__ = ("prompt", "bucket", "max_new_tokens", "do_sample",
                 "temperature", "top_k", "seed", "eos", "deadline",
                 "handle", "engine", "cancelled", "t_last_token",
                 "generator")

    def __init__(self, engine, prompt, bucket, max_new_tokens, do_sample,
                 temperature, top_k, seed, eos, deadline):
        self.engine = engine
        self.prompt = prompt               # np.int32 [L]
        self.bucket = bucket               # padded prompt length Sp
        self.max_new_tokens = max_new_tokens
        self.do_sample = do_sample
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.eos = eos                     # int; vocab_size == never
        self.deadline = deadline           # absolute monotonic or None
        self.cancelled = False
        self.t_last_token = None
        self.generator = None              # set at admission
        self.handle = GenerationHandle(len(prompt), max_new_tokens)
        self.handle._req = self


def sample_tokens(logits, do_sample, temp, top_k, noise, k_max: int):
    """Per-lane sampling over logits [n, V]: greedy = argmax of the raw
    logits; sampling = temperature scale, top-k cutoff (lanes with
    top_k 0 keep the full vocabulary; values tied with the k-th survive),
    then the Gumbel-max draw ``argmax(logits + noise)`` — a categorical
    sample when ``noise`` holds standard Gumbel variates.  ``noise`` None
    means no lane samples."""
    lg = logits.float()
    greedy = lg.argmax(-1)
    if noise is None:
        return greedy
    lg2 = lg / temp.float().clamp_min(1e-6)[:, None]
    vals = lg2.topk(k_max, dim=-1).values
    kth = vals.gather(1, (top_k.long() - 1).clamp(0, k_max - 1)[:, None])
    lg3 = torch.where((top_k > 0)[:, None] & (lg2 < kth),
                      torch.finfo(torch.float32).min, lg2)
    return torch.where(do_sample, (lg3 + noise).argmax(-1), greedy)


class GenerationEngine:
    """Continuous-batching decode over a device-resident paged KV cache.

    Args:
      model: a causal LM exposing ``slot_prefill`` / ``slot_decode_paged``
        and a ``cfg`` (models/gpt.py GPTForCausalLM), on ``device``.
      max_slots, max_seq_len, prompt_buckets, queue_depth, page_size,
        num_pages: as in the reference (``FLAGS_genserve_*`` defaults).
      max_top_k: largest per-request top_k accepted.
      device: where the engine runs; None means the CUDA card (raises
        where there is none).  The model's parameters must live there.

    Lifecycle: ``start()`` allocates the decode state and starts the
    decode thread, ``submit()`` returns a streaming
    :class:`GenerationHandle`, ``drain()`` finishes in-flight decodes and
    rejects new work, ``stop()`` kills the loop.
    """

    def __init__(self, model, *, max_slots=None, max_seq_len=None,
                 prompt_buckets=None, queue_depth=None, max_top_k=64,
                 page_size=None, num_pages=None, device=None):
        for req_attr in ("slot_prefill", "slot_decode_paged", "cfg"):
            if not hasattr(model, req_attr):
                raise TypeError(
                    f"GenerationEngine needs a model with `{req_attr}` "
                    "(a causal LM with the slot-batched paged KV-cache "
                    "decode path, e.g. models.GPTForCausalLM); got "
                    f"{type(model).__name__}")
        self.device = resolve_device(device)
        param = next(model.parameters())
        if param.device.type != self.device.type:
            raise ValueError(f"model parameters live on {param.device}, "
                             f"the engine runs on {self.device}")
        self.model = model
        cfg = model.cfg
        self.max_slots = int(max_slots
                             or _flags.flag("FLAGS_genserve_max_slots", 4))
        self.max_seq_len = int(
            max_seq_len or _flags.flag("FLAGS_genserve_max_seq_len", 256))
        if self.max_seq_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the model's "
                f"max_position_embeddings {cfg.max_position_embeddings}")
        if prompt_buckets is None:
            prompt_buckets = _flags.flag("FLAGS_genserve_prompt_buckets",
                                         "16,32,64")
        if isinstance(prompt_buckets, str):
            prompt_buckets = [int(s) for s in prompt_buckets.split(",")
                              if s.strip()]
        self.prompt_buckets = sorted(set(int(b) for b in prompt_buckets))
        if not self.prompt_buckets or self.prompt_buckets[0] < 1:
            raise ValueError(f"invalid prompt buckets {prompt_buckets!r}")
        if self.prompt_buckets[-1] >= self.max_seq_len:
            raise ValueError(
                f"largest prompt bucket {self.prompt_buckets[-1]} leaves "
                f"no room to generate within max_seq_len {self.max_seq_len}")
        self.queue_depth = int(
            queue_depth or _flags.flag("FLAGS_genserve_queue_depth", 128))
        self.max_top_k = int(max_top_k)
        page_size = int(page_size
                        or _flags.flag("FLAGS_genserve_page_size", 16))
        if num_pages is None:
            num_pages = int(_flags.flag("FLAGS_genserve_num_pages", 0))
        self.geometry = CacheGeometry(
            num_layers=cfg.num_layers, max_slots=self.max_slots,
            max_seq_len=self.max_seq_len, num_heads=cfg.num_heads,
            head_dim=cfg.hidden_size // cfg.num_heads,
            vocab_size=cfg.vocab_size, page_size=page_size,
            num_pages=int(num_pages), dtype=param.dtype)
        self.metrics = GenerationMetrics(
            max_slots=self.max_slots, num_pages=self.geometry.num_pages)
        self._queue: queue.Queue = queue.Queue(self.queue_depth)
        self._backlog: collections.deque = collections.deque()
        self._sched = SlotScheduler(self.max_slots,
                                    num_pages=self.geometry.num_pages)
        self._thread = None
        self._started = False
        self._draining = False
        self._stopped = False
        self._idle = threading.Event()
        self._idle.set()
        self._state = None
        self._lane = None

    # -- warmup: allocate the decode state ---------------------------------
    def start(self) -> "GenerationEngine":
        if self._started:
            return self
        self.model.eval()
        geom = self.geometry
        self._state = make_state(geom, self.device)
        self._lane = torch.arange(self.max_slots, device=self.device)
        logger.info(
            "generation engine on %s: slots=%d S_max=%d prompt buckets=%s "
            "pages=%dx%d cache=%.1f MB", self.device, self.max_slots,
            self.max_seq_len, self.prompt_buckets, geom.num_pages,
            geom.page_size, geom.kv_bytes() / 1048576)
        self._started = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="paddle-genserve-decode")
        self._thread.start()
        return self

    @property
    def free_count(self) -> int:
        """Pages on the device free list (a device sync; for tests and
        diagnostics, not the decode loop)."""
        return int(self._state["free_count"])

    # -- request intake ----------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if b >= n:
                return b
        raise ValueError(
            f"prompt length {n} exceeds the largest prompt bucket "
            f"{self.prompt_buckets[-1]}")

    def submit(self, prompt, max_new_tokens=32, *, do_sample=False,
               temperature=1.0, top_k=0, seed=0, eos_token_id=None,
               deadline_ms=None) -> GenerationHandle:
        """Enqueue one prompt (1-D int token ids).  Returns a streaming
        :class:`GenerationHandle`.  Raises QueueFullError under
        backpressure, EngineStoppedError once draining/stopped, and
        ValueError for requests the cache geometry cannot hold."""
        if self._draining or self._stopped:
            self.metrics.count("rejected_draining")
            raise EngineStoppedError("generation engine is draining — no "
                                     "new requests accepted")
        if not self._started:
            raise EngineStoppedError("generation engine not started — "
                                     "call start()")
        prompt = np.array(prompt, np.int32).reshape(-1)
        L = int(prompt.shape[0])
        if L < 1:
            raise ValueError("empty prompt")
        if prompt.min() < 0 or prompt.max() >= self.geometry.vocab_size:
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self.geometry.vocab_size})")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        bucket = self._bucket_for(L)
        if L + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt {L} + max_new_tokens {max_new_tokens} exceeds "
                f"max_seq_len {self.max_seq_len}")
        worst_pages = self.geometry.pages_for(L + max_new_tokens)
        if worst_pages > self.geometry.num_pages:
            self.metrics.count("rejected_pages_exhausted")
            raise ValueError(
                f"request needs {worst_pages} KV pages worst-case; the "
                f"pool holds {self.geometry.num_pages} (raise num_pages "
                f"or page_size)")
        top_k = int(top_k)
        if top_k > self.max_top_k:
            raise ValueError(f"top_k {top_k} exceeds max_top_k "
                             f"{self.max_top_k}")
        eos = self.geometry.vocab_size if eos_token_id is None \
            else int(eos_token_id)
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        req = _GenRequest(self, prompt, bucket, max_new_tokens,
                          bool(do_sample), float(temperature), top_k,
                          int(seed), eos, deadline)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self.metrics.count("rejected_queue_full")
            raise QueueFullError(
                f"generation queue at capacity ({self.queue_depth}); "
                "retry with backoff") from None
        self._idle.clear()
        self.metrics.count("admitted")
        return req.handle

    def generate(self, prompt, max_new_tokens=32, timeout=None, **kw):
        """Synchronous convenience: submit + result."""
        return self.submit(prompt, max_new_tokens, **kw).result(timeout)

    # -- the decode loop ---------------------------------------------------
    def _wake(self):
        try:
            self._queue.put_nowait(_WAKE)
        except queue.Full:
            pass

    def _run(self):
        try:
            # grad mode is per thread: this one never builds a graph
            with torch.no_grad():
                self._loop()
        except BaseException:
            logger.exception("generation decode loop crashed")
            self._stopped = True
            self._fail_everything(EngineStoppedError(
                "generation decode loop crashed"))
            self._idle.set()
            raise

    def _loop(self):
        while True:
            self._pull_requests()
            self._sweep_backlog()
            self._admit_ready()
            self._preempt_swept()
            occupied = self._sched.occupied
            self.metrics.set_occupancy(len(occupied))
            self.metrics.set_page_occupancy(self._sched.pages_reserved)
            if occupied and not self._stopped:
                toks, fin = self.step()
                self._distribute(toks, fin)
                continue
            if self._queue.empty() and not self._backlog:
                self._idle.set()
                if self._draining or self._stopped:
                    return

    def _pull_requests(self):
        """Move queued requests to the backlog; block only when idle."""
        block = (not self._sched.occupied and not self._backlog
                 and not (self._draining or self._stopped))
        try:
            req = self._queue.get(block=block)
        except queue.Empty:
            return
        if req is not _WAKE:
            self._backlog.append(req)
        while True:
            try:
                r2 = self._queue.get_nowait()
            except queue.Empty:
                return
            if r2 is not _WAKE:
                self._backlog.append(r2)

    def _sweep_backlog(self):
        now = time.monotonic()
        keep = collections.deque()
        for req in self._backlog:
            if req.cancelled:
                self.metrics.count("cancelled")
                req.handle._finish()
            elif req.deadline is not None and now > req.deadline:
                self.metrics.count("deadline_expired")
                req.handle._finish(DeadlineExceededError(
                    "request deadline passed while queued"))
            else:
                keep.append(req)
        self._backlog = keep

    def _admit_ready(self):
        while self._backlog and not self._stopped:
            req = self._backlog[0]
            need = self.geometry.pages_for(
                len(req.prompt) + req.max_new_tokens)
            if not self._sched.can_admit(need):
                # no free lane, or the pool cannot reserve the worst case:
                # FIFO head-of-line wait until a retirement frees some
                break
            self._backlog.popleft()
            slot = self._sched.admit(req, n_pages=need)
            try:
                self._admit(req, slot)
            except Exception as e:  # noqa: BLE001 - fail THIS request,
                # keep the decode loop alive for the others
                logger.exception("generation admission failed")
                self.metrics.count("errors")
                self._release([slot])
                self._host_retire(slot)
                req.handle._finish(e)

    def _gumbel(self, reqs):
        """Standard Gumbel noise [len(reqs), V], one row drawn from each
        request's own generator.  A None entry (a lane that does not
        sample, whose noise is never read) gets a finite filler row and
        draws nothing."""
        V = self.geometry.vocab_size
        tiny = torch.finfo(torch.float32).tiny
        filler = None
        rows = []
        for r in reqs:
            if r is None:
                if filler is None:
                    filler = torch.full((V,), 0.5, device=self.device)
                rows.append(filler)
            else:
                rows.append(torch.rand(V, generator=r.generator,
                                       device=self.device))
        u = torch.stack(rows)
        return -torch.log(-torch.log(u.clamp_min(tiny)))

    def _admit(self, req: _GenRequest, slot: int):
        """Prefill + insert: fill the slot's freshly mapped pages and arm
        the lane with its first sampled token — the request joins the
        in-flight batch at this iteration boundary."""
        L = len(req.prompt)
        dev = self.device
        ids = np.zeros((1, req.bucket), np.int64)
        ids[0, :L] = req.prompt
        k_new, v_new, logits = self.model.slot_prefill(
            torch.from_numpy(ids).to(dev), L)
        write_prompt(self._state, slot, k_new, v_new, L)
        req.generator = make_generator(req.seed, dev)
        noise = self._gumbel([req]) if req.do_sample else None
        # fill kernels, not host-to-device copies (each of which syncs)
        tok1 = sample_tokens(
            logits[None], torch.full((1,), req.do_sample, device=dev),
            torch.full((1,), req.temperature, device=dev),
            torch.full((1,), req.top_k, device=dev), noise,
            min(self.max_top_k, self.geometry.vocab_size))[0]
        admit_slot(self._state, slot, tok1, L, req.do_sample,
                   req.temperature, req.top_k, L + req.max_new_tokens,
                   req.eos)
        t1 = int(tok1)      # the admission's one device-to-host copy
        now = time.monotonic()
        req.t_last_token = now
        req.handle._push(t1)
        self.metrics.observe_ttft(now - req.handle.t_submit)
        self.metrics.observe_tokens(1)
        if req.max_new_tokens == 1 or t1 == req.eos:
            self._release([slot])
            self._host_retire(slot)
            self.metrics.count("retired")
            req.handle._finish()

    def _release(self, slots):
        mask = torch.zeros((self.max_slots,), dtype=torch.bool)
        mask[list(slots)] = True
        release_slots(self._state, mask.to(self.device))

    def _host_retire(self, slot: int):
        """Drop the slot's scheduler reservation (the device-side page
        free already happened in the step or release).  Returns the
        slot's request."""
        return self._sched.retire(slot)

    def _preempt_swept(self):
        swept = self._sched.sweep()
        if not swept:
            return
        self._release([slot for slot, _, _ in swept])
        for slot, req, reason in swept:
            self._host_retire(slot)
            self.metrics.count(reason)
            self.metrics.count("preempted")
            req.handle._finish(
                None if reason == "cancelled" else DeadlineExceededError(
                    "request deadline passed mid-decode"))

    def step(self):
        """ONE decode iteration: every in-flight lane advances a token.
        Pops tail pages for lanes crossing a page boundary, runs
        ``slot_decode_paged`` (KV written into the pool in place), samples,
        retires finished lanes and returns their pages — all on the
        device — then copies the tokens and the finished mask to the host
        in one transfer."""
        st, geom = self._state, self.geometry
        ps, pps = geom.page_size, geom.pages_per_slot
        lane = self._lane
        pos, active, ptab = st["pos"], st["active"], st["ptab"]
        pidx = (pos // ps).clamp(0, pps - 1).long()
        cur = ptab[lane, pidx]
        need = active & (cur < 0)
        pages, free_count = take_pages(st["free_stack"], st["free_count"],
                                       need)
        ptab[lane, pidx] = torch.where(need, pages, cur)
        st["free_count"].copy_(free_count)
        logits, _, _ = self.model.slot_decode_paged(
            st["tok"], pos, active, st["kp"], st["vp"], ptab,
            self.max_seq_len)
        occupied = self._sched.occupied
        noise = None
        if any(r.do_sample for r in occupied.values()):
            # one row per lane, in lane order: no lane index to copy over
            noise = self._gumbel([
                r if r is not None and r.do_sample else None
                for r in map(occupied.get, range(self.max_slots))])
        toks = sample_tokens(logits, st["do_sample"], st["temp"],
                             st["top_k"], noise,
                             min(self.max_top_k, geom.vocab_size))
        toks = torch.where(active, toks.to(torch.int32), st["tok"])
        new_pos = torch.where(active, pos + 1, pos)
        finished = active & ((toks == st["eos"])
                             | (new_pos + 1 >= st["stop_pos"]))
        st["tok"].copy_(toks)
        st["pos"].copy_(new_pos)
        release_slots(st, finished)
        # the step's one device-to-host copy (copy=True: one aten._to_copy
        # on every device; a CPU tensor's .cpu() would be the tensor itself)
        host = torch.stack([toks, finished.to(torch.int32)]).to(
            "cpu", copy=True).numpy()
        return host[0], host[1].astype(bool)

    def _distribute(self, toks_np, fin_np):
        now = time.monotonic()
        occupied = list(self._sched.occupied.items())
        self.metrics.observe_tokens(len(occupied))
        for slot, req in occupied:
            if req.t_last_token is not None:
                self.metrics.observe_inter_token(now - req.t_last_token)
            req.t_last_token = now
            req.handle._push(int(toks_np[slot]))
            if fin_np[slot]:
                # the step already returned the lane's pages on device;
                # this drops the host bookkeeping
                self._host_retire(slot)
                self.metrics.count("retired")
                req.handle._finish()

    def _fail_everything(self, exc):
        while self._backlog:
            self._backlog.popleft().handle._finish(exc)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not _WAKE:
                req.handle._finish(exc)
        for slot in list(self._sched.occupied):
            self._sched.retire(slot).handle._finish(exc)

    # -- shutdown ----------------------------------------------------------
    def drain(self, timeout=None) -> bool:
        """Graceful: reject new work, finish every queued and in-flight
        generation, stop the decode loop.  True when fully drained."""
        self._draining = True
        if self._thread is None:
            return True
        self._wake()
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        drained = self._idle.wait(timeout)
        self._thread.join(None if deadline is None
                          else max(0.0, deadline - time.monotonic()))
        alive = self._thread.is_alive()
        if not alive:
            self._thread = None
        # a submit racing the drain flag can slip a request in after the
        # loop's final empty-check — fail it, never strand its handle
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is _WAKE:
                continue
            drained = False
            if not req.handle.done:
                req.handle._finish(EngineStoppedError(
                    "request arrived during drain"))
        return drained and not alive

    def stop(self):
        """Hard stop: fail everything queued and in-flight."""
        self._stopped = True
        self._draining = True
        thread = self._thread
        if thread is not None:
            self._wake()
            thread.join(5.0)
            if not thread.is_alive():
                self._thread = None
        self._fail_everything(EngineStoppedError("engine stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        if exc[0] is None:
            self.drain(timeout=30.0)
        self.stop()
        return False
