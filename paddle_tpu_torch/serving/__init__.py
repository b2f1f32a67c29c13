"""paddle_tpu_torch.serving — adaptive-batching and generation serving on
the card, and the fleet that runs several replicas behind one endpoint
(port of paddle_tpu/serving).

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

Several replicas (each ``python -m paddle_tpu_torch.serving.generation``,
one process with its own engine, page pool and prefix cache) run under a
``ReplicaSupervisor`` (serving/fleet.py: spawn, heartbeats, respawn) behind
a ``FleetRouter`` (serving/router.py: prefix affinity, health and epoch
failover, journaled mid-stream resume, retry budget, circuit breaker,
deadline admission, hedging):

    python -m paddle_tpu_torch.serving.fleet --world 2 -- \\
        python -m paddle_tpu_torch.serving.generation --port 0
    python -m paddle_tpu_torch.serving.router --coord HOST:PORT
"""
from .engine import (BucketSpec, DeadlineExceededError,  # noqa: F401
                     EngineStoppedError, QueueFullError, ServingEngine)
from .metrics import (GenerationMetrics, RouterMetrics,  # noqa: F401
                      ServingMetrics)

__all__ = ["ServingEngine", "ServingServer", "ServingClient", "BucketSpec",
           "ServingMetrics", "GenerationMetrics", "RouterMetrics",
           "GenerationEngine", "GenerationHandle", "CacheGeometry",
           "SlotScheduler", "PrefixCache", "FleetRouter", "RetryBudget",
           "ReplicaSupervisor", "QueueFullError", "DeadlineExceededError",
           "EngineStoppedError"]


def __getattr__(name):  # lazy: keeps `python -m paddle_tpu_torch.serving
    if name == "ServingServer":     # .server` / .client / .generation /
        from .server import ServingServer   # .router / .fleet runnable
        return ServingServer                # without runpy's double-
    if name == "ServingClient":             # import warning
        from .client import ServingClient
        return ServingClient
    if name in ("GenerationEngine", "GenerationHandle"):
        from . import generation
        return getattr(generation, name)
    if name in ("FleetRouter", "RetryBudget"):
        from . import router
        return getattr(router, name)
    if name == "ReplicaSupervisor":
        from .fleet import ReplicaSupervisor
        return ReplicaSupervisor
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
