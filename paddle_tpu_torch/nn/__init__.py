"""paddle_tpu_torch.nn — the nn surface of the port (counterpart of
paddle_tpu.nn): `Layer` and its layers, the recurrent layers, losses,
functional ops and the decode API."""

from . import functional, initializer  # noqa: F401
from .layer import (GELU, AdaptiveAvgPool2D,  # noqa: F401
                    AdaptiveMaxPool2D, AvgPool2D, BatchNorm, BatchNorm1D,
                    BatchNorm2D, BCELoss, BCEWithLogitsLoss, Conv2D,
                    CrossEntropyLoss, Dropout, Embedding, Flatten,
                    KLDivLoss, L1Loss, Layer, LayerNorm, Linear,
                    MarginRankingLoss, MaxPool2D, MSELoss,
                    MultiHeadAttention, NLLLoss, Parameter, ReLU, ReLU6,
                    Sequential, SmoothL1Loss, Tanh, Transformer,
                    TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)
from .layer import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell,  # noqa: F401
                    RNNCellBase, SimpleRNN, SimpleRNNCell)
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa
