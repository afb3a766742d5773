"""Layers of the port (counterpart of paddle_tpu/nn/layer)."""

from .activation import GELU, ReLU, ReLU6, Tanh  # noqa: F401
from .common import Dropout, Embedding, Flatten, Linear  # noqa: F401
from .container import Sequential  # noqa: F401
from .conv import Conv2D  # noqa: F401
from .layers import Layer, Parameter  # noqa: F401
from .loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss,  # noqa
                   KLDivLoss, L1Loss, MarginRankingLoss, MSELoss, NLLLoss,
                   SmoothL1Loss)
from .norm import BatchNorm, BatchNorm1D, BatchNorm2D, LayerNorm  # noqa: F401
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell,  # noqa: F401
                  RNNCellBase, SimpleRNN, SimpleRNNCell)
from .pooling import (AdaptiveAvgPool2D, AdaptiveMaxPool2D,  # noqa: F401
                      AvgPool2D, MaxPool2D)
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
