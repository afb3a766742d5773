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
    """Rows of `weight` (num_embeddings, embedding_dim), N(0, 1); with
    `padding_idx`, that row is zeroed at construction (a negative index
    counts from the end, as the reference's numpy write does) and ids
    equal to it read zeros."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse=False, weight_attr=None, name=None,
                 *, weight_init: Optional[Initializer] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], weight_init or weight_attr,
            default_initializer=Normal(0.0, 1.0), generator=generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Dropout(Layer):
    """`F.dropout` with the layer's p, mode and training flag; the mask
    from the layer's generator (or the `rng_scope`'s)."""

    def __init__(self, p: float = 0.5, axis=None, mode="upscale_in_train",
                 name=None, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode,
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


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.data_format = p, data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout2d(x, self.p, self.training, self.data_format,
                           generator=self.generator)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest",
                         data_format=data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", align_corners=True,
                         data_format=data_format)


class Pad1D(Layer):
    """`F.pad` with the layer's padding, mode and value (the reference
    passes no data_format)."""

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor)


class CosineSimilarity(Layer):
    """sum(x1 x2) / max(|x1| |x2|, eps) along `axis`."""

    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        dot = torch.sum(x1 * x2, dim=self.axis)
        na = torch.linalg.vector_norm(x1, dim=self.axis)
        nb = torch.linalg.vector_norm(x2, dim=self.axis)
        return dot / torch.clamp(na * nb, min=self.eps)


class Bilinear(Layer):
    """out[b, o] = x1[b] W[o] x2[b] + bias[0, o], W (out, in1, in2)
    Xavier, bias (1, out)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], weight_attr,
            default_initializer=Xavier())
        self.bias = self.create_parameter([1, out_features], bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        out = torch.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        return out if self.bias is None else out + self.bias
