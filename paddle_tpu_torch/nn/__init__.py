"""paddle_tpu_torch.nn — the nn surface BERT needs (counterpart of
paddle_tpu.nn), as torch.nn.Modules."""

from . import functional, initializer  # noqa: F401
from .layer import (GELU, Dropout, Embedding, LayerNorm,  # noqa: F401
                    Linear, MultiHeadAttention, ReLU, Tanh,
                    TransformerEncoder, TransformerEncoderLayer)
