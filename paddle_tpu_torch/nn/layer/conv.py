"""Convolution layers (counterpart of paddle_tpu/nn/layer/conv.py)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import functional as F
from ..initializer import MSRA
from .layers import Layer


def _ntuple(v, n):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


class _ConvNd(Layer):
    """The reference's parameters: `weight` [out, in / groups, *k] (or
    [in, out / groups, *k] transposed), MSRA-uniform with fan-in (in /
    groups) prod(k) either way, and a zero-initialised `bias` [out]
    unless `bias_attr` is False.  The reference reads no `padding_mode`:
    another than 'zeros' raises."""

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, dims, transposed=False,
                 output_padding=0, generator=None):
        super().__init__()
        if in_channels % groups:
            raise ValueError(f"in_channels {in_channels} is not a multiple "
                             f"of groups {groups}")
        if padding_mode != "zeros":
            raise NotImplementedError(f"padding_mode {padding_mode!r}")
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _ntuple(kernel_size, dims)
        self._stride = _ntuple(stride, dims)
        self._padding = padding
        self._dilation = _ntuple(dilation, dims)
        self._groups = groups
        self._data_format = data_format
        self._output_padding = output_padding
        shape = ([in_channels, out_channels // groups] if transposed else
                 [out_channels, in_channels // groups]) + self._kernel_size
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        self.weight = self.create_parameter(
            shape, weight_attr, default_initializer=MSRA(fan_in=fan_in),
            generator=generator)
        self.bias = self.create_parameter(
            [out_channels], bias_attr, is_bias=True, generator=generator)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv2D(_ConvNd):
    """2-D convolution; `padding` takes Paddle's forms (see
    `functional.conv2d`)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 2,
                         generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 2, transposed=True,
                         output_padding=output_padding, generator=generator)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._dilation, self._groups,
            output_size, self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 3,
                         generator=generator)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1D(_ConvNd):
    """(B, C, L) convolution as conv2d over (B, C, 1, L), weight [out, in
    / groups, k]."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 1,
                         generator=generator)

    def forward(self, x):
        pad = self._padding
        pad2 = [0, pad] if isinstance(pad, int) else [0] + list(pad)
        out = F.conv2d(x.unsqueeze(2), self.weight.unsqueeze(2), self.bias,
                       [1] + self._stride, pad2, [1] + self._dilation,
                       self._groups)
        return out.squeeze(2)
