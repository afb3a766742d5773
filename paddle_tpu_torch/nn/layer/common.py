"""Common layers (counterpart of paddle_tpu/nn/layer/common.py)."""

from __future__ import annotations

from typing import Optional

import torch

from .. import functional as F
from ..initializer import Initializer, Normal, Xavier
from .layers import Layer


class Linear(Layer):
    """y = x @ W + b with W (in_features, out_features) — Paddle's layout,
    so parameter names and shapes match paddle_tpu one to one.
    `weight_attr` may be an initializer (as `weight_init`)."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 weight_init: Optional[Initializer] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], weight_init or weight_attr,
            default_initializer=Xavier(), generator=generator)
        self.bias = self.create_parameter(
            [out_features], bias_attr, is_bias=True, generator=generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse=False, weight_attr=None, name=None,
                 *, weight_init: Optional[Initializer] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding_idx is not None:
            raise NotImplementedError("padding_idx is not supported")
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], weight_init or weight_attr,
            default_initializer=Normal(0.0, 1.0), generator=generator)

    def forward(self, x):
        return F.embedding(x, self.weight)


class Dropout(Layer):
    """upscale_in_train dropout; the identity in eval mode."""

    def __init__(self, p: float = 0.5, axis=None, mode="upscale_in_train",
                 name=None, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        if axis is not None or mode != "upscale_in_train":
            raise NotImplementedError("only element-wise upscale_in_train")
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training,
                         generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Flatten(Layer):
    """Flatten dims start_axis..stop_axis into one."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)
