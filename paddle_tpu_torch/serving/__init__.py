"""paddle_tpu_torch.serving — adaptive-batching serving on the card (port
of paddle_tpu/serving; the router and fleet come in a later slice,
ROADMAP.md A6(b)).

Concurrent requests are coalesced into padded fixed-shape batches drawn
from a finite bucket grid, every bucket is captured as one CUDA graph at
startup so steady-state serving never captures, and a dependency-free
HTTP front end exposes /predict, /generate (JSON or SSE), /healthz and
Prometheus /metrics with graceful SIGTERM drain.

    from paddle_tpu_torch import serving
    engine = serving.ServingEngine(net, buckets="1,2,4,8x64,128",
                                   input_specs=[((-1, -1), "int64")])
    with serving.ServingServer(engine, port=8866) as srv:
        srv.wait()          # until SIGTERM → drain → clean exit

Autoregressive traffic runs through the continuous-batching
GenerationEngine (serving/generation.py), mounted on the same HTTP server
as streaming POST /generate:

    gen = serving.GenerationEngine(model, max_slots=8)
    with serving.ServingServer(None, gen_engine=gen, port=8866) as srv:
        srv.wait()

or one-shot from the high-level API: ``paddle_tpu_torch.Model(net)
.serve(...)`` / ``.serve_generate(...)``.
"""
from .engine import (BucketSpec, DeadlineExceededError,  # noqa: F401
                     EngineStoppedError, QueueFullError, ServingEngine)
from .generation import GenerationEngine, GenerationHandle  # noqa: F401
from .metrics import GenerationMetrics, ServingMetrics  # noqa: F401

__all__ = ["ServingEngine", "ServingServer", "ServingClient", "BucketSpec",
           "ServingMetrics", "GenerationMetrics", "GenerationEngine",
           "GenerationHandle", "CacheGeometry", "SlotScheduler",
           "PrefixCache", "QueueFullError", "DeadlineExceededError",
           "EngineStoppedError"]


def __getattr__(name):  # lazy: keeps `python -m paddle_tpu_torch.serving
    if name == "ServingServer":     # .server` / .client runnable without
        from .server import ServingServer   # runpy's double-import warning
        return ServingServer
    if name == "ServingClient":
        from .client import ServingClient
        return ServingClient
    if name == "CacheGeometry":
        from .kv_cache import CacheGeometry
        return CacheGeometry
    if name == "SlotScheduler":
        from .scheduler import SlotScheduler
        return SlotScheduler
    if name == "PrefixCache":
        from .prefix_cache import PrefixCache
        return PrefixCache
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
