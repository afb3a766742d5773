"""Transformer encoder layers (counterpart of
paddle_tpu/nn/layer/transformer.py).

The attention core routes through the flash-attention kernel
(ops/kernels/attention.py) and the dense FFN through the fused FFN kernel
(ops/kernels/ffn.py).  Layout is (batch, seq, d_model) throughout,
(batch, seq, heads, head_dim) inside attention, as in Paddle's 2.x API.
No KV cache in this slice: `cache` arguments belong to the decode path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import functional as F
from ..initializer import Initializer
from .activation import GELU, ReLU
from .common import Dropout, Linear
from .norm import LayerNorm


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 weight_init: Optional[Initializer] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.generator = generator
        kw = dict(weight_init=weight_init, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, generator=self.generator)
        out = out.reshape(out.shape[0], out.shape[1], self.embed_dim)
        return self.out_proj(out)


def _dense_ffn_block(layer, x):
    """linear2(dropout(act(linear1(x)))) through F.fused_feedforward: one
    launch of the fused FFN kernel on the card."""
    act = layer.activation
    act_name = "relu" if isinstance(act, ReLU) else (
        "gelu_tanh" if act.approximate else "gelu")
    return F.fused_feedforward(
        x, layer.linear1.weight, layer.linear1.bias, layer.linear2.weight,
        layer.linear2.bias, activation=act_name,
        act_dropout=layer.dropout.p, training=layer.training,
        generator=layer.dropout.generator)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (Paddle's normalize_before=False, the form
    BERT uses)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 weight_init: Optional[Initializer] = None,
                 moe_experts: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if moe_experts:
            raise NotImplementedError(
                "Switch-MoE encoder layers (moe_experts > 0) are not "
                "ported yet")
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_init=weight_init,
            generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, weight_init,
                              generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, weight_init,
                              generator=generator)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.activation = GELU() if activation == "gelu" else ReLU()

    def forward(self, src, src_mask=None):
        src = self.norm1(src + self.dropout1(
            self.self_attn(src, src, src, src_mask)))
        return self.norm2(src + self.dropout2(_dense_ffn_block(self, src)))


class TransformerEncoder(nn.Module):
    """`num_layers` encoder layers, each built by `layer_fn()` (a fresh,
    independently initialized layer per call, where Paddle clones one
    layer's constructor config)."""

    def __init__(self, layer_fn, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(layer_fn() for _ in range(num_layers))
        self.num_layers = num_layers

    def forward(self, src, src_mask=None):
        for layer in self.layers:
            src = layer(src, src_mask)
        return src
