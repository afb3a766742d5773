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


class Conv2D(Layer):
    """2-D convolution with paddle_tpu's parameters: `weight` [out_channels,
    in_channels / groups, kh, kw], MSRA-uniform with that fan-in, and a
    zero-initialised `bias` [out_channels] unless `bias_attr` is False.
    `padding` takes Paddle's forms (see `functional.conv2d`)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if in_channels % groups:
            raise ValueError(f"in_channels {in_channels} is not a multiple "
                             f"of groups {groups}")
        if padding_mode != "zeros":
            raise NotImplementedError(f"padding_mode {padding_mode!r}")
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _ntuple(kernel_size, 2)
        self._stride = _ntuple(stride, 2)
        self._padding = padding
        self._dilation = _ntuple(dilation, 2)
        self._groups = groups
        self._data_format = data_format
        shape = [out_channels, in_channels // groups] + self._kernel_size
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        self.weight = self.create_parameter(
            shape, weight_attr, default_initializer=MSRA(fan_in=fan_in),
            generator=generator)
        self.bias = self.create_parameter(
            [out_channels], bias_attr, is_bias=True, generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
