"""nn core of the port (Layer, initializers, the GPT and BERT paths'
layers, the encoder-decoder Transformer)."""
from . import clip, functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .layer import (Dropout, Embedding, LayerList, LayerNorm,  # noqa: F401
                    Linear, MultiHeadAttention, Transformer,
                    TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)
from .layer_base import Layer, ParamAttr  # noqa: F401
