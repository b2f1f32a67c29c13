"""High-level API (port of paddle_tpu/hapi: ``Model``, its engines, the
callbacks, the logger, ``summary`` and ``flops``)."""
from . import callbacks, logger  # noqa: F401
from .callbacks import (Callback, EarlyStopping, LRScheduler,  # noqa: F401
                        ModelCheckpoint, ProgBarLogger, VisualDL)
from .model import Model, flops, summary  # noqa: F401

from . import model_summary  # noqa: F401,E402
