"""Layers of the port (counterpart of paddle_tpu/nn/layer)."""

from .activation import (ELU, GELU, SELU, Hardshrink,  # noqa: F401
                         Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                         LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
                         Sigmoid, Silu, Softmax, Softplus, Softshrink, Swish,
                         Tanh, Tanhshrink, ThresholdedReLU)
from .common import (Bilinear, CosineSimilarity, Dropout,  # noqa: F401
                     Dropout2D, Embedding, Flatten, Linear, Pad1D, Pad2D,
                     Pad3D, PixelShuffle, Upsample, UpsamplingBilinear2D,
                     UpsamplingNearest2D)
from .container import LayerList, ParameterList, Sequential  # noqa: F401
from .conv import Conv1D, Conv2D, Conv2DTranspose, Conv3D  # noqa: F401
from .layers import Layer, Parameter  # noqa: F401
from .loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss,  # noqa
                   KLDivLoss, L1Loss, MarginRankingLoss, MSELoss, NLLLoss,
                   SmoothL1Loss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   BatchNorm3D, GroupNorm, InstanceNorm1D, InstanceNorm2D,
                   InstanceNorm3D, LayerNorm, LocalResponseNorm,
                   SpectralNorm, SyncBatchNorm)
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell,  # noqa: F401
                  RNNCellBase, SimpleRNN, SimpleRNNCell)
from .pooling import (AdaptiveAvgPool2D, AdaptiveMaxPool2D,  # noqa: F401
                      AvgPool1D, AvgPool2D, MaxPool1D, MaxPool2D)
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from .extra_layers import (AdaptiveAvgPool1D,  # noqa: F401
                           AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                           AdaptiveMaxPool3D, AlphaDropout, AvgPool3D,
                           BilinearTensorProduct, Conv1DTranspose,
                           Conv3DTranspose, CTCLoss, Dropout3D,
                           HSigmoidLoss, LogSigmoid, MaxPool3D,
                           PairwiseDistance, Pool2D, RowConv, Softsign)

__all__ = [n for n in dir() if n[:1].isupper()]
