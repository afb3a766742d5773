"""Normalization layers (counterpart of paddle_tpu/nn/layer/norm.py)."""

from __future__ import annotations

import math

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


class SyncBatchNorm(BatchNorm):
    """Batch norm whose training statistics are the whole process
    group's (reference nn/layer/norm.py:64): each rank sums its batch in
    float32 and one differentiable all-reduce adds the sums up
    (F._sync_batch_norm_train), so every rank normalises by the global
    batch's mean and variance and updates the same running statistics.
    With no group, or a group of one, it is BatchNorm."""

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats,
                            sync_group=True)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every BatchNorm under it replaced by a
        SyncBatchNorm that shares its parameters and statistics."""
        if isinstance(layer, BatchNorm) and not isinstance(
                layer, SyncBatchNorm):
            new = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format,
                                use_global_stats=layer._use_global_stats)
            new.weight = layer.weight
            new.bias = layer.bias
            new._mean = layer._mean
            new._variance = layer._variance
            new.train(layer.training)
            return new
        for name, sub in list(layer._modules.items()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return layer


class BatchNorm3D(BatchNorm):
    """Batch norm over NCDHW, channel axis 1 (the reference passes NCHW
    on whatever data_format is given)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW", use_global_stats, name)


class InstanceNorm2D(Layer):
    """The instance_norm op; `scale` (ones) and `bias` (zeros) unless
    `weight_attr` or `bias_attr` is False, which leaves out both, as the
    reference does."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False or bias_attr is False:
            self.scale = None
            self.bias = None
        else:
            self.scale = self.create_parameter(
                [num_features], weight_attr,
                default_initializer=Constant(1.0))
            self.bias = self.create_parameter([num_features], bias_attr,
                                              is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups, self._epsilon = num_groups, epsilon
        self.weight = self.create_parameter(
            [num_channels], weight_attr, default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_channels], bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


class SpectralNorm(Layer):
    """x / sigma, sigma from `power_iters` rounds of power iteration on x
    with `dim` first, from the vectors `weight_u` [h] and `weight_v` [w]
    (parameters, Xavier, as the reference makes them).  Each forward
    writes the refined vectors back into them, outside autograd."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__()
        self._dim, self._power_iters, self._eps = dim, power_iters, eps
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        self.weight_u = self.create_parameter([h])
        self.weight_v = self.create_parameter([w])

    def forward(self, x):
        dim = self._dim
        perm = [dim] + [i for i in range(x.ndim) if i != dim]
        wm = x.permute(perm).reshape(x.shape[dim], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v = wm.T @ u
            v = v / (torch.linalg.vector_norm(v) + self._eps)
            u = wm @ v
            u = u / (torch.linalg.vector_norm(u) + self._eps)
        out = x / (u @ wm @ v)
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        return out
