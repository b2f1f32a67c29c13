"""nn of the port: Layer, initializers, the layers of the GPT, BERT and
Transformer paths, and (conv, pooling, batch norm, activations, losses,
containers) those of the vision models."""
from . import clip, functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .layer import *  # noqa: F401,F403
from .layer_base import Layer, ParamAttr  # noqa: F401
