"""paddle.vision of the port (port of paddle_tpu/vision: ``models`` and
``datasets``; transforms, ops and the image backends are not ported yet,
ROADMAP.md A11)."""
from . import datasets, models  # noqa: F401
