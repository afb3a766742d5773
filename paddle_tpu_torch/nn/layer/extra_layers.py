"""The tail of the 2.x layers (counterpart of
paddle_tpu/nn/layer/extra_layers.py): wrappers over the functional
tail, the 1-D and 3-D convolution and pooling variants, and the legacy
fluid.dygraph Pool2D."""

from __future__ import annotations

from typing import Optional

import torch

from .. import functional as F
from .conv import _ConvNd
from .layers import Layer


class LogSigmoid(Layer):
    def forward(self, x):
        return F.log_sigmoid(x)


class Softsign(Layer):
    def forward(self, x):
        return F.softsign(x)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training,
                               generator=self.generator)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.data_format = p, data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class PairwiseDistance(Layer):
    """The p-norm of x - y + epsilon along axis 1."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return torch.linalg.vector_norm(x - y + self.epsilon, ord=self.p,
                                        dim=1, keepdim=self.keepdim)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over the default complete binary tree (or a
    custom one given to forward): `weight` [num_classes - 1,
    feature_size], `bias` [num_classes - 1, 1]."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        self.num_classes = num_classes
        self.weight = self.create_parameter([num_classes - 1, feature_size],
                                            weight_attr)
        self.bias = self.create_parameter([num_classes - 1, 1], bias_attr,
                                          is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               bias=self.bias, path_table=path_table,
                               path_code=path_code)


class BilinearTensorProduct(Layer):
    """The bilinear_tensor_product op: `weight` [output_dim, input1_dim,
    input2_dim], `bias` [output_dim]."""

    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        self.weight = self.create_parameter(
            [output_dim, input1_dim, input2_dim], weight_attr)
        self.bias = self.create_parameter([output_dim], bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear_tensor_product(x1, x2, self.weight, self.bias)


class RowConv(Layer):
    def __init__(self, num_channels, future_context_size, param_attr=None,
                 act=None):
        super().__init__()
        self.act = act
        self.weight = self.create_parameter(
            [future_context_size + 1, num_channels], param_attr)

    def forward(self, x):
        return F.row_conv(x, self.weight, act=self.act)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 1, transposed=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation,
            output_size, self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 3, transposed=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation,
            output_size, self._data_format)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode)
        self.return_mask = return_mask

    def forward(self, x):
        k, s, p, cm = self.args
        return F.max_pool3d(x, k, s, p, self.return_mask, cm)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 ceil_mode=False, exclusive=True, divisor_override=None,
                 data_format="NCDHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode)
        self.exclusive, self.divisor_override = exclusive, divisor_override

    def forward(self, x):
        k, s, p, cm = self.args
        return F.avg_pool3d(x, k, s, p, cm, self.exclusive,
                            self.divisor_override)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)


class Pool2D(Layer):
    """The legacy fluid.dygraph Pool2D: global pooling reduces the
    spatial axes, else max_pool2d / avg_pool2d (exclusive: the reference
    passes no `exclusive`, so False raises for an average pool)."""

    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, use_cudnn=True,
                 ceil_mode=False, exclusive=True, data_format="NCHW"):
        super().__init__()
        if pool_type != "max" and not exclusive and not global_pooling:
            raise NotImplementedError(
                "Pool2D: the reference pools exclusive whatever `exclusive`")
        self.cfg = (pool_size, pool_type, pool_stride, pool_padding,
                    global_pooling, ceil_mode, data_format)

    def forward(self, x):
        ks, pt, st, pd, gp, cm, df = self.cfg
        if gp:
            red = (2, 3) if df == "NCHW" else (1, 2)
            if pt == "max":
                return torch.amax(x, dim=red, keepdim=True)
            return torch.mean(x, dim=red, keepdim=True)
        f = F.max_pool2d if pt == "max" else F.avg_pool2d
        return f(x, ks, stride=st, padding=pd, ceil_mode=cm, data_format=df)
