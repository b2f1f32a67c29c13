"""Runtime flag registry (port of paddle_tpu/framework/flags.py).

Only the flags the ported modules read are defined here (the adaptive
batcher's and the generation engine's, the durable checkpoints' of
``Model.fit``, and the request tracer's); each is
env-overridable under its own name, as in the reference, and
:func:`set_flags` changes them at run time.
"""
from __future__ import annotations

import os
from typing import Any

_REGISTRY: dict[str, Any] = {}


def define_flag(name: str, default: Any, help_: str = ""):
    env = os.environ.get(name.upper(), os.environ.get(name))
    if env is not None:
        if isinstance(default, bool):
            default = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            default = int(env)
        elif isinstance(default, float):
            default = float(env)
        else:
            default = env
    _REGISTRY[name] = default


def flag(name: str, default: Any = None) -> Any:
    return _REGISTRY.get(name, default)


def set_flags(flags: dict[str, Any]):
    for k, v in flags.items():
        _REGISTRY[k] = v


# -- serving (paddle_tpu_torch.serving adaptive batcher) ------------------
define_flag("FLAGS_serving_max_batch", 8,
            "largest batch the serving engine coalesces (upper bucket)")
define_flag("FLAGS_serving_timeout_ms", 5.0,
            "adaptive-batch flush deadline: a partial batch is dispatched "
            "once its oldest request has waited this long")
define_flag("FLAGS_serving_queue_depth", 256,
            "bounded request queue; submit() raises QueueFullError beyond "
            "this (backpressure, not unbounded buffering)")
define_flag("FLAGS_serving_buckets", "",
            "serving shape-bucket grid, 'B1,B2,...' or 'B1,B2xS1,S2,...' "
            "(batch x sequence); '' = powers of two up to "
            "FLAGS_serving_max_batch, no sequence bucketing")
# -- generation serving (paddle_tpu_torch.serving.generation) --------------
define_flag("FLAGS_genserve_max_slots", 4,
            "in-flight sequences per decode iteration (the continuous-"
            "batching lane count; one decode step spans all slots)")
define_flag("FLAGS_genserve_max_seq_len", 256,
            "per-slot KV-cache length S_max; prompt + max_new_tokens of "
            "every request must fit inside it")
define_flag("FLAGS_genserve_prompt_buckets", "16,32,64",
            "admitted prompt-length grid 'S1,S2,...'; prompts are padded "
            "to the smallest bucket that holds them")
define_flag("FLAGS_genserve_queue_depth", 128,
            "bounded generation admission queue; submit() raises "
            "QueueFullError beyond this")
define_flag("FLAGS_genserve_page_size", 16,
            "tokens per KV-cache page; the page pool is allocated as "
            "[layers, num_pages, page_size, heads, head_dim]")
define_flag("FLAGS_genserve_num_pages", 0,
            "KV page-pool capacity; 0 sizes it dense-equivalently "
            "(max_slots * ceil(max_seq_len / page_size))")
define_flag("FLAGS_genserve_prefix_cache", 1,
            "1 shares identical tokenized prompt prefixes as refcounted "
            "read-only KV pages (hits skip prefill for shared pages); "
            "0 disables sharing")
define_flag("FLAGS_genserve_spec_tokens", 4,
            "speculative-decode draft proposals per iteration (k); only "
            "read when a draft model is attached — each iteration drafts "
            "k tokens and the target verifies all k+1 in one step")
define_flag("FLAGS_genserve_prefill_chunk", 0,
            "chunked-prefill slice length in tokens (page_size multiple, "
            "<= largest prompt bucket); prompts whose un-shared suffix "
            "exceeds it prefill one chunk per decode iteration instead of "
            "stalling every lane; 0 disables chunking")

# -- durable checkpointing (distributed/checkpoint.py) --------------------
define_flag("FLAGS_ckpt_async", True,
            "fit(resume=/fault_tolerant=) writes interval/epoch "
            "checkpoints on a background thread (host snapshot on the "
            "training thread, disk IO off it); False = synchronous saves")
define_flag("FLAGS_ckpt_max_failures", 3,
            "consecutive failed checkpoint generations tolerated before "
            "fit aborts with resilience.DURABILITY_EXIT_CODE (degrade-"
            "then-escalate: warn and keep training until then)")

# -- request tracing (monitor/tracing.py) ---------------------------------
define_flag("FLAGS_trace_sample_rate", 0.01,
            "head-sampling probability for request-scoped spans "
            "(monitor/tracing.py): the decision is derived from the "
            "trace_id itself, so client and server independently agree; "
            "0 disables the tracer, 1 traces every request")
define_flag("FLAGS_trace_buffer_spans", 2048,
            "bounded ring of finished spans the tracer retains "
            "(oldest evicted first)")
