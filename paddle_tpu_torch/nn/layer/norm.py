"""Normalization layers (counterpart of paddle_tpu/nn/layer/norm.py)."""

from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import Constant
from .layers import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            self.normalized_shape, weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter(self.normalized_shape, bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class BatchNorm(Layer):
    """Batch norm with paddle_tpu's parameters and buffers: `weight` (ones)
    and `bias` (zeros), and the float32 running statistics `_mean`
    (zeros) and `_variance` (ones), the reference's names, so state keys
    such as `layer1.0.bn1._mean` line up.  Training updates them in place
    with paddle_tpu's momentum rule (see `functional.batch_norm`)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], weight_attr, default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], bias_attr,
                                          is_bias=True)
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm1D(BatchNorm):
    pass


class BatchNorm2D(BatchNorm):
    pass
