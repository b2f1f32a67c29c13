"""Distributed training, the single-process part (port of
paddle_tpu/distributed): durable checkpoints (``checkpoint``) and the
fault-tolerant runtime's pieces (``resilience``).  Process groups,
meshes and the multi-process checkpoint paths are not ported yet
(ROADMAP.md A9)."""
from .resilience import (DURABILITY_EXIT_CODE,  # noqa: F401
                         PREEMPTED_EXIT_CODE)
