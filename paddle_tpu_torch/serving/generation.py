"""Continuous-batching autoregressive generation engine over a paged KV
cache (port of paddle_tpu/serving/generation.py).

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
* **prefix sharing** (``FLAGS_genserve_prefix_cache``, on by default) —
  identical page-aligned prompt prefixes occupy the pool once
  (serving/prefix_cache.py): a hit maps the cached read-only pages into
  the slot's page table and prefills only the suffix through
  ``slot_prefill_prefix``, attending over the cached prefix K/V.
* **chunked prefill** (``FLAGS_genserve_prefill_chunk``) — a prompt whose
  unshared suffix is longer than the chunk streams into its pages one
  chunk per loop iteration, each followed by a decode step of the armed
  lanes, so a long prompt does not stall the streams in flight.
* **the decode step as one CUDA graph** — the reference AOT-compiles its
  decode step at ``start()`` and calls the executable afterwards; on a
  CUDA device ``start()`` captures the step once (after one warm-up step
  on a side stream, on the all-inactive state) and ``step()`` replays it.
  The state tensors are allocated before the capture and only ever
  written in place, by the replays and by the eager admission, chunk,
  release and reclaim transitions between them, on the same stream.  A
  failed capture raises at ``start()``; there is no eager fallback on the
  card.  The CPU runs the same step eagerly (``_step_eager``).
* **speculative decode** (``draft_model=``, ``spec_tokens=``) — a draft
  model proposes ``spec_tokens`` tokens a lane per iteration (K + 1
  chained greedy ``slot_decode_paged`` calls over its own pool, which the
  same page table addresses) and the target scores the committed token
  and the K proposals in ONE batched ``slot_verify_paged``; a greedy lane
  emits the longest agreeing run plus the target's next token, a sampling
  lane exactly one token from the verify's first position.  On the card
  this whole step is the one captured graph, in place of the decode step.
* **one copy per step** — each ``step()`` (``step_spec()``) ends in ONE
  device-to-host copy of the sampled tokens and the finished mask
  together (with the emitted mask); admission fetches the first token
  (with the page-table row when the prefix cache is on).

Sampling is greedy (argmax of the raw logits) or temperature / top-k
categorical.  JAX's per-slot threefry chain cannot be reproduced in
PyTorch: each request draws from its own ``torch.Generator`` on the
engine's device, seeded from the request's seed, once at admission and
once per decode step — deterministic per seed and independent of batch
mates.  The decode graph always takes the sampling form and reads its
Gumbel noise from a static buffer that the host fills before a replay in
which some lane samples; greedy lanes take the argmax through the same
``where``, so their tokens do not depend on the noise.  Top-k keeps the
reference's ``lg2 < kth`` rule, so ties at the k-th value survive.

* **resume_pos failover** — ``submit(prompt + emitted[:n],
  resume_pos=n, seed=s)`` continues a stream cut after ``n`` tokens (the
  router's re-admission of a request whose replica died): a sampling
  lane's generator is advanced past the ``n`` Gumbel rows the
  uninterrupted run drew (one ``[V]`` row a token, in the plain and the
  speculative step alike) before its first token's draw, so the resumed
  stream draws what the uninterrupted one would have.  A greedy lane
  draws nothing.
* **request tracing** (monitor/tracing.py) — ``submit(span=)`` hangs the
  engine's ``gen.queued`` / ``gen.prefill`` / ``gen.decode`` children off
  the caller's span (the HTTP server's ``server.generate``); without one
  a sampled ``genserve.request`` root is started when the process tracer
  is on.  Every span timestamp is taken on the host, around work the
  engine has already synchronised: tracing adds no sync to a step.

* **the replica process** — ``python -m paddle_tpu_torch.serving.generation``
  serves a seeded random-weight GPT with this engine behind a
  ``ServingServer`` (:func:`main`, the reference's argv plus ``--device``);
  under a fleet supervisor (serving/fleet.py) it registers its URL with
  the pod coordinator and heartbeats there.  Before every decode and
  speculative step the engine calls ``chaos.on_step`` (utils/chaos.py) on
  the host, the seam the fleet's replica drills fire from.

Not ported yet (ROADMAP.md): tensor-parallel serving and ``op_report``.
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
from ..monitor import tracing as _tracing
from ..ops.capture import capture, side_stream
from ..utils import chaos
from .engine import DeadlineExceededError, EngineStoppedError, QueueFullError
from .kv_cache import (CacheGeometry, admit_slot, make_state, reclaim_pages,
                       release_slots, take_pages, write_prompt)
from .metrics import GenerationMetrics
from .prefix_cache import PrefixCache
from .scheduler import SlotScheduler

logger = logging.getLogger("paddle_tpu_torch.serving")

__all__ = ["GenerationEngine", "GenerationHandle", "sample_tokens",
           "replica_parser", "build_replica", "main"]

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
        self.t_first_token = None         # set when the first token lands

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

    @property
    def ttft_ms(self):
        """Milliseconds from submit to the first token (None before it)."""
        if self.t_first_token is None:
            return None
        return (self.t_first_token - self.t_submit) * 1e3

    def _push(self, tok: int):
        if self.t_first_token is None:
            self.t_first_token = time.monotonic()
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
                 "temperature", "top_k", "seed", "resume_pos", "eos",
                 "deadline", "handle", "engine", "cancelled",
                 "t_last_token", "span", "own_span", "span_queue",
                 "span_decode", "generator", "prefilling", "prefill_cursor",
                 "chunk_row", "j_hit", "pin_final")

    def __init__(self, engine, prompt, bucket, max_new_tokens, do_sample,
                 temperature, top_k, seed, eos, deadline, span=None,
                 own_span=False, resume_pos=0):
        self.engine = engine
        self.prompt = prompt               # np.int32 [L]
        self.bucket = bucket               # padded prompt length Sp
        self.max_new_tokens = max_new_tokens
        self.do_sample = do_sample
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.resume_pos = resume_pos       # tokens a dead replica emitted
        self.eos = eos                     # int; vocab_size == never
        self.deadline = deadline           # absolute monotonic or None
        self.cancelled = False
        self.t_last_token = None
        self.span = span                   # request span (sampled or None)
        self.own_span = own_span           # engine owns span's end()
        self.span_queue = None             # "gen.queued" child
        self.span_decode = None            # "gen.decode" child (or the
        #                                    chunked "gen.prefill")
        self.generator = None              # set when the lane is armed
        self.prefilling = False            # chunked prefill in flight
        self.prefill_cursor = 0            # tokens already prefilled
        self.chunk_row = None              # the slot's page row (device)
        self.j_hit = 0                     # prefix-cache pages mapped
        self.pin_final = 0                 # pinned count once armed
        self.handle = GenerationHandle(len(prompt), max_new_tokens)
        self.handle._req = self

    def end_spans(self, status: str):
        """Close any open child spans and settle the request span with a
        terminal status; the parent is ended here only when the engine
        owns it (direct submit — HTTP requests end theirs upstream)."""
        for s in (self.span_queue, self.span_decode):
            if s is not None:
                s.end(status=status)
        self.span_queue = self.span_decode = None
        if self.span is not None:
            self.span.set_attr("status", status)
            if self.own_span:
                self.span.end()
            self.span = None


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
        (and ``slot_prefill_prefix`` when the prefix cache or chunked
        prefill is on) and a ``cfg`` (models/gpt.py GPTForCausalLM), on
        ``device``.
      max_slots, max_seq_len, prompt_buckets, queue_depth, page_size,
        num_pages: as in the reference (``FLAGS_genserve_*`` defaults).
      max_top_k: largest per-request top_k accepted.
      prefix_cache: share identical page-aligned prompt prefixes as
        refcounted read-only pages (``FLAGS_genserve_prefix_cache``,
        default on); hits prefill only the suffix.
      prefill_chunk: tokens per prefill chunk, a multiple of page_size
        and at most the largest bucket (``FLAGS_genserve_prefill_chunk``;
        0 prefills whole prompts).
      device: where the engine runs; None means the CUDA card (raises
        where there is none).  The model's parameters must live there.
      draft_model: a smaller causal LM of the same vocabulary (with
        ``slot_prefill``, ``slot_decode_paged``, ``slot_prefill_prefix``
        and ``cfg``; a ``hapi.Model`` is unwrapped to its network), on the
        same device in the same dtype: speculative decode.
      spec_tokens: draft proposals an iteration (K >= 1;
        ``FLAGS_genserve_spec_tokens``, default 4); 0 without a draft.

    Lifecycle: ``start()`` allocates the decode state, captures the
    decode step on a CUDA device and starts the decode thread,
    ``submit()`` returns a streaming :class:`GenerationHandle`,
    ``drain()`` finishes in-flight decodes and rejects new work,
    ``stop()`` kills the loop.  The model's parameters must not be
    replaced or moved after ``start()``: the captured step reads them
    where they were.

    Capture bookkeeping: ``capture_count`` (captures made, 1 after
    ``start()`` on a CUDA device: the decode step, or with a draft the
    speculative step; also ``compile_count``, the reference's name, and
    the metrics' gauge of that name), ``replays`` (steps replayed),
    ``graph_launches`` (kernel wrapper name -> launches in one replay, as
    the wrappers counted them while the step was captured: a replay runs
    the kernels again without passing through the wrappers) and
    ``graph_variants`` (kernel -> {variant: launches in one replay}).
    """

    def __init__(self, model, *, max_slots=None, max_seq_len=None,
                 prompt_buckets=None, queue_depth=None, max_top_k=64,
                 page_size=None, num_pages=None, prefix_cache=None,
                 prefill_chunk=None, device=None, draft_model=None,
                 spec_tokens=None):
        from ..hapi.model import Model as _HapiModel

        if isinstance(model, _HapiModel):
            model = model.network
        if isinstance(draft_model, _HapiModel):
            draft_model = draft_model.network
        if prefix_cache is None:
            prefix_cache = bool(int(
                _flags.flag("FLAGS_genserve_prefix_cache", 1)))
        if prefill_chunk is None:
            prefill_chunk = int(
                _flags.flag("FLAGS_genserve_prefill_chunk", 0))
        needs = ["slot_prefill", "slot_decode_paged", "cfg"]
        if prefix_cache or prefill_chunk:
            needs.append("slot_prefill_prefix")
        for req_attr in needs:
            if not hasattr(model, req_attr):
                raise TypeError(
                    f"GenerationEngine needs a model with `{req_attr}` "
                    "(a causal LM with the slot-batched paged KV-cache "
                    "decode path, e.g. models.GPTForCausalLM); got "
                    f"{type(model).__name__}")
        self.device = resolve_device(device)
        param = next(iter(model.parameters()))
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
        # speculative decode: a draft model proposes spec_tokens a step,
        # the target verifies them in one batched step
        draft_kw = {}
        if draft_model is not None:
            for req_attr in ("slot_prefill", "slot_decode_paged",
                             "slot_prefill_prefix", "cfg"):
                if not hasattr(draft_model, req_attr):
                    raise TypeError(
                        f"draft_model needs `{req_attr}`; got "
                        f"{type(draft_model).__name__}")
            dcfg = draft_model.cfg
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {dcfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}")
            if self.max_seq_len > dcfg.max_position_embeddings:
                raise ValueError(
                    f"max_seq_len {self.max_seq_len} exceeds the draft "
                    "model's max_position_embeddings "
                    f"{dcfg.max_position_embeddings}")
            dparam = next(iter(draft_model.parameters()))
            if (dparam.device.type, dparam.dtype) != (param.device.type,
                                                      param.dtype):
                raise ValueError(
                    f"the draft model's parameters ({dparam.dtype} on "
                    f"{dparam.device}) must share the target's dtype and "
                    f"device ({param.dtype} on {param.device}): one page "
                    "pool dtype serves both")
            draft_kw = dict(draft_layers=dcfg.num_layers,
                            draft_num_heads=dcfg.num_heads,
                            draft_head_dim=dcfg.hidden_size // dcfg.num_heads)
        self.draft_model = draft_model
        if spec_tokens is None:
            spec_tokens = int(_flags.flag("FLAGS_genserve_spec_tokens", 4))
        self.spec_tokens = int(spec_tokens) if draft_model is not None \
            else 0
        if draft_model is not None and self.spec_tokens < 1:
            raise ValueError(
                f"spec_tokens must be >= 1 with a draft model, got "
                f"{self.spec_tokens}")
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
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk:
            if self.prefill_chunk % page_size:
                raise ValueError(
                    f"prefill_chunk {self.prefill_chunk} must be a "
                    f"multiple of page_size {page_size} (chunk cursors "
                    "resume at page boundaries)")
            if self.prefill_chunk > self.prompt_buckets[-1]:
                raise ValueError(
                    f"prefill_chunk {self.prefill_chunk} exceeds the "
                    f"largest prompt bucket {self.prompt_buckets[-1]}")
        self.geometry = CacheGeometry(
            num_layers=cfg.num_layers, max_slots=self.max_slots,
            max_seq_len=self.max_seq_len, num_heads=cfg.num_heads,
            head_dim=cfg.hidden_size // cfg.num_heads,
            vocab_size=cfg.vocab_size, page_size=page_size,
            num_pages=int(num_pages), dtype=param.dtype, **draft_kw)
        self.metrics = GenerationMetrics(
            max_slots=self.max_slots, num_pages=self.geometry.num_pages)
        self._prefix = PrefixCache(page_size) if prefix_cache else None
        self._slot_pins: dict[int, list] = {}   # slot -> pinned page ids
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
        self._noise = None       # [max_slots, V] Gumbel rows the graph reads
        # the graph's static output, int32: [2, max_slots] (tokens,
        # finished); speculative: [max_slots, 2 (K + 1) + 1] (outs,
        # emitted, finished)
        self._out = None
        self._graph = None
        self._iter = 0           # decode iterations, the chaos seam's step
        self.capture_count = 0
        self.capture_ms = None
        self.replays = 0
        self.graph_launches: dict[str, int] = {}
        self.graph_variants: dict[str, dict] = {}

    # -- warmup: allocate the decode state, capture the step ---------------
    def start(self) -> "GenerationEngine":
        if self._started:
            return self
        self.model.eval()
        if self.draft_model is not None:
            self.draft_model.eval()
        geom = self.geometry
        dev = self.device
        self._state = make_state(geom, dev)
        self._lane = torch.arange(self.max_slots, device=dev)
        self._noise = torch.zeros((self.max_slots, geom.vocab_size),
                                  dtype=torch.float32, device=dev)
        self._out = torch.zeros(
            (self.max_slots, 2 * self.spec_tokens + 3)
            if self.draft_model is not None else (2, self.max_slots),
            dtype=torch.int32, device=dev)
        if dev.type == "cuda":
            t0 = time.perf_counter()
            with torch.no_grad():
                self._capture()
            self.capture_ms = (time.perf_counter() - t0) * 1e3
        logger.info(
            "generation engine on %s: slots=%d S_max=%d prompt buckets=%s "
            "pages=%dx%d cache=%.1f MB prefix cache=%s prefill chunk=%d "
            "spec tokens=%d capture ms=%s graph launches=%s", dev,
            self.max_slots, self.max_seq_len, self.prompt_buckets,
            geom.num_pages, geom.page_size, geom.kv_bytes() / 1048576,
            self._prefix is not None, self.prefill_chunk, self.spec_tokens,
            None if self.capture_ms is None else round(self.capture_ms, 1),
            self.graph_launches)
        self._started = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="paddle-genserve-decode")
        self._thread.start()
        return self

    def _capture(self):
        """Capture the step into one CUDA graph (ops/capture.py): the
        decode step, or with a draft model the speculative step.  A
        warm-up step runs first on a side stream, so that the kernel
        libraries load, the paged decode kernel's arrival counters and
        cuBLAS's workspace are allocated and every lazy choice is made
        outside the capture.  Both run on the all-inactive state, which a
        step leaves as it was; any change to the state raises, as does a
        capture that fails (an op that syncs or allocates on the host)."""
        st = self._state
        before = {k: t.clone() for k, t in st.items()}
        body = self._graph_spec_step if self.draft_model is not None \
            else self._graph_step
        cap = capture(body, warm_up=lambda: side_stream(body, self.device))
        self.graph_launches, self.graph_variants = cap.launches, cap.variants
        changed = [k for k, t in st.items() if not torch.equal(t, before[k])]
        if changed:
            raise RuntimeError(f"the step's warm-up and capture changed the "
                               f"idle state: {changed}")
        self._graph = cap.graph
        self.capture_count += 1
        self.metrics.set_compile_count(self.compile_count)

    @property
    def compile_count(self) -> int:
        """The graphs captured at ``start()`` (1 on a CUDA device, 0 on
        the CPU): the reference's count of the executables it compiles at
        warmup, which the metrics' ``compile_count`` gauge reads."""
        return self.capture_count

    @property
    def free_count(self) -> int:
        """Pages on the device free list (a device sync; for tests and
        diagnostics, not the decode loop)."""
        return int(self._state["free_count"])

    @property
    def resident_pages(self) -> int:
        """Pages the prefix cache holds resident (0 without one): idle,
        ``free_count + resident_pages == num_pages``."""
        return self._prefix.resident_pages if self._prefix is not None \
            else 0

    # -- request intake ----------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if b >= n:
                return b
        raise ValueError(
            f"prompt length {n} exceeds the largest prompt bucket "
            f"{self.prompt_buckets[-1]}")

    def submit(self, prompt, max_new_tokens=32, *, do_sample=False,
               temperature=1.0, top_k=0, seed=0, resume_pos=0,
               eos_token_id=None, deadline_ms=None,
               span=None) -> GenerationHandle:
        """Enqueue one prompt (1-D int token ids).  Returns a streaming
        :class:`GenerationHandle`.  Raises QueueFullError under
        backpressure, EngineStoppedError once draining/stopped, and
        ValueError for requests the cache geometry cannot hold.

        ``resume_pos``: the prompt ends with that many tokens an earlier
        run of the same request (same seed) emitted; a sampling request
        skips their draws, so it continues that run's stream.
        ``span``: an open request span to hang the engine's gen.queued /
        gen.prefill / gen.decode children from (the HTTP server passes
        its adopted server.generate span); without one, a sampled root
        span is started when the process tracer is enabled."""
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
        resume_pos = int(resume_pos)
        if resume_pos < 0:
            raise ValueError("resume_pos must be >= 0")
        eos = self.geometry.vocab_size if eos_token_id is None \
            else int(eos_token_id)
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        own_span = False
        if span is not None and not span.sampled:
            span = None
        elif span is None:
            tracer = _tracing.default_tracer()
            if tracer.enabled:
                root = tracer.start_span(
                    "genserve.request",
                    attrs={"prompt_len": L,
                           "max_new_tokens": max_new_tokens})
                if root.sampled:
                    span, own_span = root, True
        req = _GenRequest(self, prompt, bucket, max_new_tokens,
                          bool(do_sample), float(temperature), top_k,
                          int(seed), eos, deadline, span=span,
                          own_span=own_span, resume_pos=resume_pos)
        if span is not None:
            # attached BEFORE enqueue: the decode thread may admit the
            # request (and close this child) before put_nowait returns
            req.span_queue = span.child("gen.queued", bucket=bucket)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self.metrics.count("rejected_queue_full")
            req.end_spans("rejected_queue_full")
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
            self.metrics.set_page_occupancy(
                self.geometry.num_pages - self._sched.pages_available)
            if occupied and not self._stopped:
                # at most ONE prefill chunk per iteration, then a decode
                # step for the armed lanes: a long prompt streams in
                # without stalling the streams in flight
                self._advance_chunk()
                if len(self._sched.occupied) > self._sched.prefilling():
                    if self.draft_model is not None:
                        self._distribute_spec(*self.step_spec())
                    else:
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
                req.end_spans("cancelled")
                req.handle._finish()
            elif req.deadline is not None and now > req.deadline:
                self.metrics.count("deadline_expired")
                req.end_spans("deadline_expired")
                req.handle._finish(DeadlineExceededError(
                    "request deadline passed while queued"))
            else:
                keep.append(req)
        self._backlog = keep

    def _lookup(self, req):
        """(shared pages, their ids, pages to reserve) of the backlog
        head: a prefix-cache hit maps its shared pages and reserves the
        rest of its worst case."""
        j_hit, shared = (self._prefix.lookup(req.prompt)
                         if self._prefix is not None else (0, ()))
        need = self.geometry.pages_for(
            len(req.prompt) + req.max_new_tokens) - j_hit
        return j_hit, shared, need

    def _admit_ready(self):
        while self._backlog and not self._stopped:
            req = self._backlog[0]
            j_hit, shared, need = self._lookup(req)
            if not self._sched.can_admit(need):
                # pool pressure: when a lane is free and idle prefix-cache
                # residents exhaust the pool, evict LRU entries until the
                # head's reservation fits; else distinct prompts park
                # one-reader prefixes over the pool and the backlog never
                # drains.  The lookup is made again: eviction may have
                # dropped the entry the head hit.
                if (self._prefix is not None and self._sched.has_free()
                        and len(self._prefix)
                        and need > self._sched.pages_available):
                    short = need - self._sched.pages_available
                    self._reclaim(self._prefix.evict_idle(short))
                    self._sched.set_shared_resident(
                        self._prefix.resident_pages)
                    j_hit, shared, need = self._lookup(req)
                if not self._sched.can_admit(need):
                    # no free lane, or the pool cannot reserve the worst
                    # case: FIFO head-of-line wait until a retirement
                    # frees some
                    break
            self._backlog.popleft()
            slot = self._sched.admit(req, n_pages=need)
            try:
                if self._prefix is not None:
                    self.metrics.count_prefix(hit=j_hit > 0)
                suffix_len = len(req.prompt) \
                    - j_hit * self.geometry.page_size
                if self.prefill_chunk and suffix_len > self.prefill_chunk:
                    self._admit_chunked(req, slot, j_hit, shared)
                else:
                    self._admit(req, slot, j_hit, shared)
            except Exception as e:  # noqa: BLE001 - fail THIS request,
                # keep the decode loop alive for the others
                logger.exception("generation admission failed")
                self.metrics.count("errors")
                self._release([slot])
                self._host_retire(slot)
                req.end_spans("error")
                req.handle._finish(e)

    def _upload(self, a: np.ndarray):
        """A host array on the engine's device.  On the card it is copied
        from pinned memory without blocking the host (a copy from
        pageable memory waits for the stream)."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _shared_row(self, shared, j_hit: int):
        """The slot's table row as far as it is shared: ``shared[:j_hit]``
        then -1, on the device."""
        row = np.full((self.geometry.pages_per_slot,), -1, np.int32)
        row[:j_hit] = shared[:j_hit]
        return self._upload(row)

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

    def _first_token(self, req, logits):
        """Arm the request's generator and sample its first token from
        the prefill logits [V] (a 0-d device tensor).  A sampling request
        resumed at ``resume_pos`` first draws and discards the rows of
        the ``resume_pos`` tokens already emitted (one [V] row a token, as
        ``_gumbel`` draws them)."""
        dev = self.device
        req.generator = make_generator(req.seed, dev)
        if req.do_sample:
            for _ in range(req.resume_pos):
                torch.rand(self.geometry.vocab_size, generator=req.generator,
                           device=dev)
        noise = self._gumbel([req]) if req.do_sample else None
        # fill kernels, not host-to-device copies (each of which syncs)
        return sample_tokens(
            logits[None], torch.full((1,), req.do_sample, device=dev),
            torch.full((1,), req.temperature, device=dev),
            torch.full((1,), req.top_k, device=dev), noise,
            min(self.max_top_k, self.geometry.vocab_size))[0]

    def _suffix_prefill(self, tokens, shared_row, shared_n: int,
                        length: int):
        """Prefill ``tokens`` (the prompt from page ``shared_n`` on, up to
        ``length``) over the ``shared_n`` resident pages of
        ``shared_row``: the prefix K/V is gathered from the pool and only
        the suffix runs through the model (and through the draft model
        over its own pool).  Returns (k, v, logits, the draft's (k, v) or
        ())."""
        ps = self.geometry.page_size
        ids = np.zeros((1, self._bucket_for(len(tokens))), np.int64)
        ids[0, :len(tokens)] = tokens
        ids = self._upload(ids)
        idx = shared_row[:shared_n].long()

        def over(model, kp, vp):
            L, _, _, nh, hd = kp.shape
            shape = (L, shared_n * ps, nh, hd)
            return model.slot_prefill_prefix(
                ids, kp[:, idx].reshape(shape), vp[:, idx].reshape(shape),
                shared_n * ps, length)

        st = self._state
        k, v, logits = over(self.model, st["kp"], st["vp"])
        if self.draft_model is None:
            return k, v, logits, ()
        dk, dv, _ = over(self.draft_model, st["dkp"], st["dvp"])
        return k, v, logits, (dk, dv)

    def _admit(self, req: _GenRequest, slot: int, j_hit: int, shared):
        """Prefill + insert: map the slot's pages (the cached prefix
        pages on a hit, prefilling only the suffix) and arm the lane with
        its first sampled token — the request joins the in-flight batch
        at this iteration boundary."""
        st = self._state
        L = len(req.prompt)
        if req.span_queue is not None:
            req.span_queue.end(status="ok")
            req.span_queue = None
        j_reg = (self._prefix.shareable_pages(L)
                 if self._prefix is not None else 0)
        sp_prefill = (req.span.child("gen.prefill", bucket=req.bucket,
                                     prompt_len=L, slot=slot,
                                     prefix_pages=j_hit)
                      if req.span is not None else None)
        # a failure before the lane is armed releases its private pages
        st["pinned"][slot] = j_hit
        if j_hit > 0:
            shared_row = self._shared_row(shared, j_hit)
            k_new, v_new, logits, draft_kv = self._suffix_prefill(
                req.prompt[j_hit * self.geometry.page_size:], shared_row,
                j_hit, L)
            row = write_prompt(st, slot, k_new, v_new, L, shared_row, j_hit,
                               *draft_kv)
        else:
            ids = np.zeros((1, req.bucket), np.int64)
            ids[0, :L] = req.prompt
            ids = self._upload(ids)
            k_new, v_new, logits = self.model.slot_prefill(ids, L)
            # the draft's K/V must cover the prompt for its chain to
            # attend it
            draft_kv = () if self.draft_model is None \
                else self.draft_model.slot_prefill(ids, L)[:2]
            row = write_prompt(st, slot, k_new, v_new, L, None, 0,
                               *draft_kv)
        tok1 = self._first_token(req, logits)
        pinned = max(j_hit, j_reg)
        admit_slot(st, slot, tok1, L, req.do_sample, req.temperature,
                   req.top_k, L + req.max_new_tokens, req.eos, pinned)
        self._deliver_first(req, slot,
                            self._fetch_first(req, slot, tok1, row, j_hit,
                                              pinned), sp_prefill)

    def _fetch_first(self, req, slot: int, tok1, row, j_hit: int,
                     pinned: int) -> int:
        """The admission's one device-to-host copy: the first token, and
        with the prefix cache the slot's table row, whose first
        ``pinned`` pages the slot pins and whose unshared full-page
        prefixes it registers.  Returns the token."""
        if self._prefix is None:
            return int(tok1)
        host = torch.cat([tok1.reshape(1).to(torch.int32), row]).to(
            "cpu", copy=True).numpy()
        row_np = host[1:]
        pin_pages = [int(p) for p in row_np[:pinned]]
        held = len(self._slot_pins.get(slot, ()))
        self._prefix.pin(pin_pages[held:])
        self._slot_pins[slot] = pin_pages
        self._reclaim(self._prefix.register(
            req.prompt, row_np, j_hit,
            self._prefix.shareable_pages(len(req.prompt))))
        self._sched.set_shared_resident(self._prefix.resident_pages)
        return int(host[0])

    def _deliver_first(self, req, slot: int, t1: int, sp_prefill=None):
        """Hand the fetched first token to the request, ending its
        ``gen.prefill`` span; the lane retires at once on eos or
        max_new_tokens == 1, else its ``gen.decode`` span opens."""
        if sp_prefill is not None:
            sp_prefill.end(status="ok")
        now = time.monotonic()
        req.t_last_token = now
        req.handle._push(t1)
        if req.span is not None:
            req.span.event("first_token", slot=slot)
        self.metrics.observe_ttft(now - req.handle.t_submit)
        self.metrics.observe_tokens(1)
        if req.max_new_tokens == 1 or t1 == req.eos:
            self._release([slot])
            self._host_retire(slot)
            self.metrics.count("retired")
            req.end_spans("ok")
            req.handle._finish()
        elif req.span is not None:
            req.span_decode = req.span.child("gen.decode", slot=slot)

    def _admit_chunked(self, req: _GenRequest, slot: int, j_hit: int,
                       shared):
        """Admit a long prompt WITHOUT prefilling it: the slot holds its
        worst-case reservation while ``_advance_chunk`` streams
        ``prefill_chunk``-token slices into its pages, one per loop
        iteration.  Only the last chunk arms the lane.  Until then the
        lane's ``pinned`` register stays at the cache-hit count, so a
        cancel or deadline mid-prefill frees every chunk page."""
        L = len(req.prompt)
        if req.span_queue is not None:
            req.span_queue.end(status="ok")
            req.span_queue = None
        req.j_hit = j_hit
        req.pin_final = max(j_hit, self._prefix.shareable_pages(L)
                            if self._prefix is not None else 0)
        req.prefilling = True
        req.prefill_cursor = j_hit * self.geometry.page_size
        req.chunk_row = self._shared_row(shared, j_hit)
        self._state["pinned"][slot] = j_hit
        if self._prefix is not None:
            # the cache-shared head must stay resident for every later
            # chunk's prefix gather (LRU cannot evict it)
            pin_pages = [int(p) for p in shared[:j_hit]]
            self._prefix.pin(pin_pages)
            self._slot_pins[slot] = pin_pages
            self._sched.set_shared_resident(self._prefix.resident_pages)
        if req.span is not None:
            req.span_decode = req.span.child(
                "gen.prefill", bucket=req.bucket, prompt_len=L,
                slot=slot, prefix_pages=j_hit, chunked=True)

    def _advance_chunk(self):
        """Advance ONE prefilling slot by one chunk: bounded work per
        loop iteration, so the armed lanes' inter-token gap stays flat
        while a long prompt streams in.  A chunk that is not the last
        only writes pages (no token, no host copy)."""
        if not self.prefill_chunk:
            return
        slot = req = None
        for s, r in self._sched.occupied.items():
            if r.prefilling:
                slot, req = s, r
                break
        if req is None:
            return
        st = self._state
        L = len(req.prompt)
        cur = req.prefill_cursor
        end = min(cur + self.prefill_chunk, L)
        shared_n = cur // self.geometry.page_size
        k_new, v_new, logits, draft_kv = self._suffix_prefill(
            req.prompt[cur:end], req.chunk_row, shared_n, end)
        req.chunk_row = write_prompt(st, slot, k_new, v_new, end,
                                     req.chunk_row, shared_n, *draft_kv)
        req.prefill_cursor = end
        self.metrics.count_chunk()
        if req.span_decode is not None:
            req.span_decode.event("chunk", end=end)
        if end < L:
            return
        # the last chunk: sample the first token and arm the lane
        req.prefilling = False
        tok1 = self._first_token(req, logits)
        admit_slot(st, slot, tok1, L, req.do_sample, req.temperature,
                   req.top_k, L + req.max_new_tokens, req.eos,
                   req.pin_final)
        t1 = self._fetch_first(req, slot, tok1, req.chunk_row, req.j_hit,
                               req.pin_final)
        sp_prefill, req.span_decode = req.span_decode, None
        self._deliver_first(req, slot, t1, sp_prefill)

    def _release(self, slots):
        mask = np.zeros((self.max_slots,), np.bool_)
        mask[list(slots)] = True
        release_slots(self._state, self._upload(mask))

    def _host_retire(self, slot: int):
        """Host-side retirement: drop the slot's scheduler reservation
        and its prefix-cache pins, reclaiming shared pages whose refcount
        reached zero (the device-side free of its private pages happened
        in the step or the release).  Returns the slot's request."""
        req = self._sched.retire(slot)
        pages = self._slot_pins.pop(slot, None)
        if self._prefix is not None:
            if pages:
                self._reclaim(self._prefix.unpin(pages))
            self._sched.set_shared_resident(self._prefix.resident_pages)
        return req

    def _reclaim(self, pages):
        """Return evicted or orphaned prefix-cache pages to the device
        free stack."""
        if pages:
            reclaim_pages(self._state,
                          self._upload(np.asarray(pages, np.int32)))

    def _preempt_swept(self):
        swept = self._sched.sweep()
        if not swept:
            return
        self._release([slot for slot, _, _ in swept])
        for slot, req, reason in swept:
            self._host_retire(slot)
            self.metrics.count(reason)
            self.metrics.count("preempted")
            req.end_spans(reason)
            req.handle._finish(
                None if reason == "cancelled" else DeadlineExceededError(
                    "request deadline passed mid-decode"))

    def _sampling_lanes(self):
        """The request of each lane, in lane order, whose Gumbel row a
        step draws (None for a lane that does not sample or is still in a
        chunked prefill); None when no lane samples."""
        occupied = self._sched.occupied
        reqs = [r if r is not None and r.do_sample and not r.prefilling
                else None for r in map(occupied.get, range(self.max_slots))]
        return reqs if any(r is not None for r in reqs) else None

    def _decode(self, noise):
        """The device work of ONE decode iteration, with no host sync:
        pops tail pages for lanes crossing a page boundary, runs
        ``slot_decode_paged`` (KV written into the pool in place),
        samples (greedy only when ``noise`` is None), retires finished
        lanes and returns their private pages.  Returns (toks int32,
        finished bool), both [max_slots]."""
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
        return toks, finished

    def _graph_step(self):
        """What the decode graph holds: the step in its sampling form over
        the static noise buffer, its tokens and finished mask written into
        the static output."""
        toks, finished = self._decode(self._noise)
        self._out[0].copy_(toks)
        self._out[1].copy_(finished)

    def step(self):
        """ONE decode iteration: every in-flight lane advances a token.
        On a CUDA device: fill the noise rows of the sampling lanes (when
        there are any), replay the captured step, and copy its tokens and
        finished mask to the host in one transfer.  On the CPU:
        :meth:`_step_eager`.  Either way the chaos seam
        (``chaos.on_step``, utils/chaos.py) runs first, on the host."""
        self._iter += 1
        chaos.on_step(self._iter)   # fault-injection seam (utils/chaos)
        if self._graph is None:
            return self._step_eager()
        reqs = self._sampling_lanes()
        if reqs is not None:
            self._noise.copy_(self._gumbel(reqs))
        self._graph.replay()
        self.replays += 1
        # the step's one device-to-host copy
        host = self._out.to("cpu", copy=True).numpy()
        return host[0], host[1].astype(bool)

    def _step_eager(self):
        """The same iteration issued op by op (the CPU's step, and the
        card tests' reference for the graph)."""
        reqs = self._sampling_lanes()
        toks, finished = self._decode(
            None if reqs is None else self._gumbel(reqs))
        # the step's one device-to-host copy (copy=True: one aten._to_copy
        # on every device; a CPU tensor's .cpu() would be the tensor itself)
        host = torch.stack([toks, finished.to(torch.int32)]).to(
            "cpu", copy=True).numpy()
        return host[0], host[1].astype(bool)

    def _spec(self, noise):
        """The device work of ONE speculative iteration, with no host sync
        (the reference's ``spec_step``, in its order): (1) map every page
        that covers [pos, min(pos + K, stop_pos - 1)] in one take; (2) the
        draft's K + 1 chained ``slot_decode_paged`` calls over its pool,
        with greedy proposals (call i writes chain token c_i's draft K/V
        at pos + i; the last only closes the draft cache for a run
        accepted whole); (3) the target's one ``slot_verify_paged`` over
        c_0..c_K; (4) accept and emit: outs[:, i] is the target's token
        after c_0..c_i, position 0 through ``sample_tokens`` with the
        lane's Gumbel row (``noise`` None: no lane samples), so a
        sampling lane emits exactly one token an iteration, drawn as in
        the plain step, and a greedy lane the longest run its proposals
        agree with plus the target's next token; (5) retire finished
        lanes and free their private pages, as :meth:`_decode` does.
        Rejected proposals need no rollback: their K/V sit inside the
        lane's reservation, past its position, where the next iteration
        overwrites them before any emitted query reads them.  Returns
        (outs int32 [slots, K + 1], emitted bool [slots, K + 1],
        finished bool [slots])."""
        st, geom = self._state, self.geometry
        K, dev = self.spec_tokens, self.device
        ps, pps = geom.page_size, geom.pages_per_slot
        pos, active, stop = st["pos"], st["active"], st["stop_pos"]
        ptab = st["ptab"]
        # (1) every page of the window, mapped off the free stack at once
        hi = torch.minimum(pos + K, stop - 1)
        col = torch.arange(pps, device=dev)[None, :]
        need = active[:, None] & (ptab < 0) & (col >= (pos // ps)[:, None]) \
            & (col <= (hi // ps)[:, None])
        pages, free_count = take_pages(st["free_stack"], st["free_count"],
                                       need.reshape(-1))
        ptab.copy_(torch.where(need, pages.reshape(ptab.shape), ptab))
        st["free_count"].copy_(free_count)
        # (2) the draft's chain (positions clamped at the budget's end, and
        # at 0 for an inactive lane, whose stop_pos is 0)
        t = st["tok"]
        chain = [t]
        for i in range(K + 1):
            p_i = torch.minimum(pos + i, stop - 1).clamp_min(0)
            dlg, _, _ = self.draft_model.slot_decode_paged(
                t, p_i, active, st["dkp"], st["dvp"], ptab, self.max_seq_len)
            if i < K:
                t = dlg.argmax(-1).to(torch.int32)
                chain.append(t)
        tokens = torch.stack(chain, dim=1)                      # [slots, K+1]
        # (3) the target scores all K + 1 candidates in one step
        positions = torch.minimum(
            pos[:, None] + torch.arange(K + 1, device=dev)[None, :],
            (stop - 1)[:, None]).clamp_min(0)
        logits, _, _ = self.model.slot_verify_paged(
            tokens, positions, active, st["kp"], st["vp"], ptab,
            self.max_seq_len)
        # (4) accept and emit
        outs = logits.argmax(-1).to(torch.int32)
        outs[:, 0] = sample_tokens(logits[:, 0], st["do_sample"], st["temp"],
                                   st["top_k"], noise,
                                   min(self.max_top_k, geom.vocab_size))
        greedy = ~st["do_sample"]
        em, emitted, fins = active, [], []
        for i in range(K + 1):
            if i > 0:
                em = em & ~fins[i - 1] & greedy \
                    & (tokens[:, i] == outs[:, i - 1])
            emitted.append(em)
            fins.append((outs[:, i] == st["eos"]) | (pos + i + 2 >= stop))
        emitted = torch.stack(emitted, dim=1)
        n_emit = emitted.sum(1)
        new_tok = outs.gather(1, (n_emit - 1).clamp_min(0)[:, None])[:, 0]
        finished = active & (emitted & torch.stack(fins, dim=1)).any(1)
        st["tok"].copy_(torch.where(active, new_tok, st["tok"]))
        st["pos"].copy_(torch.where(active, pos + n_emit, pos))
        # (5) retire in the step
        release_slots(st, finished)
        return outs, emitted, finished

    def _pack_spec(self, outs, emitted, finished):
        """The speculative step's output as one int32 [slots, 2 (K + 1) +
        1] tensor (outs, emitted, finished), fetched in one copy."""
        return torch.cat([outs, emitted.to(torch.int32),
                          finished.to(torch.int32)[:, None]], dim=1)

    def _split_spec(self, host):
        K1 = self.spec_tokens + 1
        return (host[:, :K1], host[:, K1:2 * K1].astype(bool),
                host[:, 2 * K1].astype(bool))

    def _graph_spec_step(self):
        """What the speculative graph holds: the step in its sampling form
        over the static noise buffer, its output written into the static
        one."""
        self._out.copy_(self._pack_spec(*self._spec(self._noise)))

    def step_spec(self):
        """ONE speculative iteration: every armed lane advances 1..K + 1
        tokens.  On a CUDA device: fill the noise rows of the sampling
        lanes (when there are any), replay the captured step, and copy its
        output to the host in one transfer.  On the CPU:
        :meth:`_step_spec_eager`.  The chaos seam runs first, as in
        :meth:`step`.  Returns (outs [slots, K + 1], emitted [slots, K + 1]
        prefix mask, finished [slots])."""
        self._iter += 1
        chaos.on_step(self._iter)
        if self._graph is None:
            return self._step_spec_eager()
        reqs = self._sampling_lanes()
        if reqs is not None:
            self._noise.copy_(self._gumbel(reqs))
        self._graph.replay()
        self.replays += 1
        return self._split_spec(self._out.to("cpu", copy=True).numpy())

    def _step_spec_eager(self):
        """The same iteration issued op by op (the CPU's step, and the
        card tests' reference for the graph)."""
        reqs = self._sampling_lanes()
        packed = self._pack_spec(*self._spec(
            None if reqs is None else self._gumbel(reqs)))
        # the step's one device-to-host copy
        return self._split_spec(packed.to("cpu", copy=True).numpy())

    def _distribute_spec(self, outs_np, emitted_np, fin_np):
        """Push each armed lane's emitted run, spreading the step's gap over
        its n tokens; the acceptance counters count greedy lanes only (n
        - 1 of a run came from accepted proposals; the last token is the
        target's own, free either way)."""
        now = time.monotonic()
        emitted_total = accepted = proposed = 0
        for slot, req in list(self._sched.occupied.items()):
            if req.prefilling:
                continue
            n = int(emitted_np[slot].sum())
            if n <= 0:
                continue
            emitted_total += n
            if not req.do_sample:
                accepted += n - 1
                proposed += self.spec_tokens
            gap = ((now - req.t_last_token) / n
                   if req.t_last_token is not None else None)
            for i in range(n):
                if gap is not None:
                    self.metrics.observe_inter_token(gap)
                req.handle._push(int(outs_np[slot, i]))
                if req.span_decode is not None:
                    req.span_decode.event("token", i=len(req.handle.tokens))
            req.t_last_token = now
            if fin_np[slot]:
                self._host_retire(slot)
                self.metrics.count("retired")
                req.end_spans("ok")
                req.handle._finish()
        self.metrics.observe_tokens(emitted_total)
        if proposed:
            self.metrics.observe_spec(accepted, proposed)

    def _distribute(self, toks_np, fin_np):
        now = time.monotonic()
        occupied = [(s, r) for s, r in self._sched.occupied.items()
                    if not r.prefilling]
        self.metrics.observe_tokens(len(occupied))
        for slot, req in occupied:
            if req.t_last_token is not None:
                self.metrics.observe_inter_token(now - req.t_last_token)
            req.t_last_token = now
            req.handle._push(int(toks_np[slot]))
            if req.span_decode is not None:
                # host ints only — toks/fin were fetched in step()
                req.span_decode.event("token", i=len(req.handle.tokens))
            if fin_np[slot]:
                # the step already returned the lane's private pages on
                # device; this drops the host bookkeeping
                self._host_retire(slot)
                self.metrics.count("retired")
                req.end_spans("ok")
                req.handle._finish()

    def _fail_everything(self, exc):
        while self._backlog:
            req = self._backlog.popleft()
            req.end_spans("error")
            req.handle._finish(exc)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not _WAKE:
                req.end_spans("error")
                req.handle._finish(exc)
        for slot in list(self._sched.occupied):
            req = self._sched.retire(slot)
            req.end_spans("error")
            req.handle._finish(exc)

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
                req.end_spans("rejected_draining")
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


def replica_parser():
    """The replica's argv: the reference's flags and defaults, plus
    ``--device`` (None: the CUDA card)."""
    import argparse

    parser = argparse.ArgumentParser(
        description="paddle_tpu_torch generation server (continuous-"
                    "batching decode with a device-resident paged KV "
                    "cache, its decode step one CUDA graph on the card)")
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--hidden", type=int, default=64)
    parser.add_argument("--heads", type=int, default=4)
    parser.add_argument("--vocab", type=int, default=211)
    parser.add_argument("--max-seq-len", type=int, default=64)
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--prompt-buckets", default="8,16")
    parser.add_argument("--page-size", type=int, default=16)
    parser.add_argument("--num-pages", type=int, default=0,
                        help="KV page pool size; 0 = dense-equivalent "
                             "(slots * pages_per_slot)")
    parser.add_argument("--prefix-cache", type=int, default=1,
                        help="1 shares identical prompt prefixes as "
                             "read-only pages; 0 disables")
    parser.add_argument("--draft-layers", type=int, default=0,
                        help="layers of the speculative draft model; "
                             "0 disables speculative decode")
    parser.add_argument("--spec-tokens", type=int, default=4,
                        help="draft proposals per speculative iteration")
    parser.add_argument("--prefill-chunk", type=int, default=0,
                        help="tokens per prefill chunk (multiple of "
                             "page-size); 0 prefills whole prompts")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8867,
                        help="0 picks a free port (printed on stdout)")
    parser.add_argument("--device", default=None,
                        help="where the replica runs: the CUDA card "
                             "unless this names another device (cpu)")
    return parser


def build_replica(args) -> GenerationEngine:
    """The replica's engine, not started: a GPT of the argv's widths with
    dropout 0, initialised from ``--seed`` (the initialisers draw from the
    CPU generator, so every process given one seed holds the same
    weights, whatever its device), on ``--device``; with
    ``--draft-layers`` a draft holding the target's embeddings and first
    blocks."""
    from ..framework.random import seed
    from ..models.gpt import GPTConfig, GPTForCausalLM

    device = resolve_device(args.device)
    seed(args.seed)
    cfg = GPTConfig(vocab_size=args.vocab, hidden_size=args.hidden,
                    num_layers=args.layers, num_heads=args.heads,
                    max_position_embeddings=args.max_seq_len,
                    dropout=0.0, attn_dropout=0.0)
    model = GPTForCausalLM(cfg, device=device).eval()
    draft = None
    if args.draft_layers > 0:
        dcfg = GPTConfig(vocab_size=args.vocab, hidden_size=args.hidden,
                         num_layers=args.draft_layers,
                         num_heads=args.heads,
                         max_position_embeddings=args.max_seq_len,
                         dropout=0.0, attn_dropout=0.0)
        draft = GPTForCausalLM(dcfg, device=device)
        # seed the draft from the target's first layers + embeddings so
        # the random-weight replica still accepts some proposals
        tgt = dict(model.state_dict())
        dsd = draft.state_dict()
        for name in list(dsd):
            if name in tgt and tuple(dsd[name].shape) \
                    == tuple(tgt[name].shape):
                dsd[name] = tgt[name]
        draft.set_state_dict(dsd)
        draft.eval()
    return GenerationEngine(model, max_slots=args.slots,
                            max_seq_len=args.max_seq_len,
                            prompt_buckets=args.prompt_buckets,
                            page_size=args.page_size,
                            num_pages=args.num_pages,
                            prefix_cache=bool(args.prefix_cache),
                            draft_model=draft,
                            spec_tokens=args.spec_tokens,
                            prefill_chunk=args.prefill_chunk,
                            device=device)


def main(argv=None):
    """Standalone generation server over a randomly initialised GPT: one
    replica of a serving fleet (real deployments build a GenerationEngine
    around trained weights, or call ``Model.serve_generate()``).  On the
    card ``start()`` captures the decode step; a capture that fails
    raises, and the process exits non-zero."""
    args = replica_parser().parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from .server import ServingServer

    engine = build_replica(args)
    server = ServingServer(None, gen_engine=engine, host=args.host,
                           port=args.port).start()
    # parse-friendly readiness line
    print(f"paddle_tpu_torch.serving listening on {server.url}", flush=True)

    # elastic fleet membership: launched under a replica supervisor
    # (serving/fleet.py exports PADDLE_POD_COORD + PADDLE_POD_RANK), the
    # replica registers its URL in the coordinator KV and heartbeats, so
    # the router evicts it on the epoch delta when it dies or partitions.
    # A REPLICA_PARTITION chaos drill silences the heartbeats while the
    # HTTP server keeps serving.
    from ..distributed.podcoord import PodClient

    pod = PodClient.from_env()
    if pod is not None:
        pod.kv_set(f"serving/replica/{pod.rank}/url",
                   server.url.encode("utf-8"))
        pod.start_heartbeats()
        chaos.register_partition_hook(pod.stop_heartbeats)
        logger.info("replica rank %d registered with fleet coordinator",
                    pod.rank)
    return server.wait()


if __name__ == "__main__":
    import sys

    sys.exit(main())
