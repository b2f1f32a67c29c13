from .activation import (CELU, ELU, GELU, GLU, PReLU, SELU,  # noqa: F401
                         Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
                         LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish,
                         ReLU, ReLU6, Sigmoid, Silu, Softmax, Softplus,
                         Softshrink, Softsign, Swish, Tanh, Tanhshrink,
                         ThresholdedReLU)
from .common import Dropout, Embedding, Flatten, Identity, Linear  # noqa: F401
from .container import (LayerDict, LayerList, ParameterList,  # noqa: F401
                        Sequential)
from .conv import (Conv1D, Conv1DTranspose, Conv2D,  # noqa: F401
                   Conv2DTranspose, Conv3D, Conv3DTranspose)
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,  # noqa: F401
                   CrossEntropyLoss, CTCLoss, HingeEmbeddingLoss, KLDivLoss,
                   L1Loss, MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   BatchNorm3D, GroupNorm, InstanceNorm1D, InstanceNorm2D,
                   InstanceNorm3D, LayerNorm, LocalResponseNorm,
                   SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                      AdaptiveMaxPool2D, AvgPool1D, AvgPool2D, AvgPool3D,
                      MaxPool1D, MaxPool2D, MaxPool3D)
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
