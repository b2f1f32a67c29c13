"""High-level API (port of paddle_tpu/hapi: ``Model``, its engines, the
callbacks and the logger)."""
from . import callbacks, logger  # noqa: F401
from .callbacks import (Callback, EarlyStopping, LRScheduler,  # noqa: F401
                        ModelCheckpoint, ProgBarLogger, VisualDL)
from .model import Model  # noqa: F401
