"""nn core of the port (Layer, initializers, the GPT path's layers)."""
from . import clip, functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .layer import Dropout, Embedding, LayerNorm, Linear  # noqa: F401
from .layer_base import Layer, ParamAttr  # noqa: F401
