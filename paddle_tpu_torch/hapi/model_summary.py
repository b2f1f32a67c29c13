"""hapi.model_summary: the module ``paddle.summary`` lives in upstream
(port of paddle_tpu/hapi/model_summary.py), re-exported from
hapi/model.py."""
from .model import summary  # noqa: F401

__all__ = ["summary"]
