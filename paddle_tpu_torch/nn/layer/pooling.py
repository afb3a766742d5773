"""Pooling layers (counterpart of paddle_tpu/nn/layer/pooling.py)."""

from __future__ import annotations

from .. import functional as F
from .layers import Layer


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        self.ksize, self.stride, self.padding = kernel_size, stride, padding
        self.return_mask, self.ceil_mode = return_mask, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.ksize, self.stride, self.padding,
                            self.ceil_mode, self.return_mask,
                            self.data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.ksize, self.stride, self.padding = kernel_size, stride, padding
        self.ceil_mode, self.exclusive = ceil_mode, exclusive
        self.divisor_override = divisor_override
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.ksize, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override, self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)


class MaxPool1D(Layer):
    """max_pool2d over (B, C, 1, L); the stride defaults to the kernel."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__()
        self.ksize, self.stride = kernel_size, stride or kernel_size
        self.padding, self.ceil_mode = padding, ceil_mode
        self.return_mask = return_mask

    def forward(self, x):
        return F.max_pool1d(x, self.ksize, self.stride, self.padding,
                            self.return_mask, self.ceil_mode)


class AvgPool1D(Layer):
    """avg_pool2d over (B, C, 1, L), exclusive (the reference passes no
    `exclusive`: False raises)."""

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.ksize, self.stride = kernel_size, stride or kernel_size
        self.padding, self.ceil_mode = padding, ceil_mode
        self.exclusive = exclusive

    def forward(self, x):
        return F.avg_pool1d(x, self.ksize, self.stride, self.padding,
                            self.exclusive, self.ceil_mode)
