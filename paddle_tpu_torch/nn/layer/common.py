"""Common layers (counterpart of paddle_tpu/nn/layer/common.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import functional as F
from ..initializer import Constant, Initializer, Normal, Xavier


class Linear(nn.Module):
    """y = x @ W + b with W (in_features, out_features) — Paddle's layout,
    so parameter names and shapes match paddle_tpu one to one."""

    def __init__(self, in_features: int, out_features: int,
                 weight_init: Optional[Initializer] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter((weight_init or Xavier())(
            (in_features, out_features), generator))
        self.bias = nn.Parameter(Constant(0.0)((out_features,)))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_init: Optional[Initializer] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter((weight_init or Normal(0.0, 1.0))(
            (num_embeddings, embedding_dim), generator))

    def forward(self, x):
        return F.embedding(x, self.weight)


class Dropout(nn.Module):
    """upscale_in_train dropout; the identity in eval mode."""

    def __init__(self, p: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training,
                         generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Flatten(nn.Module):
    """Flatten dims start_axis..stop_axis into one."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)
