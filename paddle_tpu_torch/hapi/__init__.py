"""High-level API (port of paddle_tpu/hapi: ``Model`` and its training
engine)."""
from .model import Model  # noqa: F401
