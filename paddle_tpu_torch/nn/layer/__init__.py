"""Layers of the port (counterpart of paddle_tpu/nn/layer)."""

from .activation import GELU, ReLU, Tanh  # noqa: F401
from .common import Dropout, Embedding, Linear  # noqa: F401
from .norm import LayerNorm  # noqa: F401
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
