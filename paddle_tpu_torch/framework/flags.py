"""Runtime flag registry (port of paddle_tpu/framework/flags.py).

Only the flags the ported modules read are defined here (the adaptive
batcher's and the generation engine's, the fleet router's and its
replica supervisor's, the durable checkpoints' of ``Model.fit``, the
request tracer's and the flight recorder's); each is
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
# -- fleet router (paddle_tpu_torch.serving.router) ------------------------
define_flag("FLAGS_router_probe_interval_s", 0.5,
            "seconds between router health probes of each replica's "
            "/healthz")
define_flag("FLAGS_router_dead_after", 3,
            "consecutive failed health probes before a replica is routed "
            "around (429 backpressure never counts as a failure)")
define_flag("FLAGS_router_healthy_after", 2,
            "consecutive successful probes before a dead replica is "
            "marked healthy again (flap damping; a single lucky probe "
            "must not re-admit a sick replica)")
define_flag("FLAGS_router_retry_budget_ratio", 0.1,
            "retry-budget deposit per successful request: retries are "
            "capped at this fraction of recent successful traffic so a "
            "sick fleet degrades to fast 503s instead of a retry storm")
define_flag("FLAGS_router_retry_budget_min", 5.0,
            "retry-budget floor (and initial balance): a cold or "
            "low-traffic router can still retry this many times")
define_flag("FLAGS_router_breaker_threshold", 3,
            "consecutive request failures that trip a replica's circuit "
            "breaker (dispatch stops before the health probe catches up)")
define_flag("FLAGS_router_breaker_cooldown_s", 2.0,
            "seconds a tripped circuit breaker holds before one trial "
            "request may probe the replica again")
define_flag("FLAGS_router_hedge_floor_ms", 0.0,
            "hedged dispatch for non-streaming requests: when > 0, a "
            "duplicate is sent to a second replica once the first has "
            "been outstanding max(this floor, observed p99 latency); "
            "first answer wins, the loser is discarded; 0 disables")
define_flag("FLAGS_router_replica_slots", 4,
            "per-replica concurrent-decode lanes the deadline-aware "
            "admission estimator assumes when computing queue wait")
define_flag("FLAGS_fleet_respawn_backoff_s", 0.5,
            "base delay before the replica supervisor respawns a "
            "crashed replica (jittered to 0.5-1.5x this)")
define_flag("FLAGS_fleet_membership_poll_s", 0.1,
            "router poll interval against the fleet coordinator's "
            "membership epoch; an epoch delta evicts dead replicas "
            "faster than the probe timeout")
# -- runtime telemetry (monitor/flightrec.py) ------------------------------
define_flag("FLAGS_telemetry_dir", "",
            "directory the crash flight recorder writes "
            "flightrec-<pid>.json into; '' = the working directory")
define_flag("FLAGS_flightrec_records", 512,
            "bounded ring of recent events the flight recorder "
            "(monitor/flightrec.py) dumps to "
            "FLAGS_telemetry_dir/flightrec-<pid>.json")

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
