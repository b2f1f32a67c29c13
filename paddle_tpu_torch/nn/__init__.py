"""nn of the port: Layer, initializers, the layers of the GPT, BERT and
Transformer paths, (conv, pooling, batch norm, activations, losses,
containers) those of the vision models, and beam-search decoding
(``BeamSearchDecoder``, ``dynamic_decode``)."""
from . import clip, decode, functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .decode import (BeamSearchDecoder, Decoder,  # noqa: F401
                     dynamic_decode)
from .layer import *  # noqa: F401,F403
from .layer_base import Layer, Parameter, ParamAttr  # noqa: F401
