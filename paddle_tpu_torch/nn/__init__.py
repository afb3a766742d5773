"""paddle_tpu_torch.nn — the nn surface BERT, the WMT Transformer and the
vision models need (counterpart of paddle_tpu.nn), as torch.nn.Modules."""

from . import functional, initializer  # noqa: F401
from .layer import (GELU, AdaptiveAvgPool2D,  # noqa: F401
                    AdaptiveMaxPool2D, AvgPool2D, BatchNorm, BatchNorm1D,
                    BatchNorm2D, Conv2D, Dropout, Embedding, Flatten,
                    LayerNorm, Linear, MaxPool2D, MultiHeadAttention, ReLU,
                    ReLU6, Sequential, Tanh, Transformer,
                    TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)
