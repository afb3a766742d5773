"""Parameter initializers as ops (counterpart of
paddle_tpu/fluid/initializer.py).

Each initializer appends a fill or random op for its parameter to the
*startup program*, so initialization is itself a Program the Executor runs
once, as in the reference: ConstantInitializer (fill_constant),
UniformInitializer (uniform_random), NormalInitializer (gaussian_random),
TruncatedNormalInitializer (truncated_gaussian_random), XavierInitializer
and MSRAInitializer, which size a uniform or normal draw from the fan-in
and fan-out, and NumpyArrayInitializer and BilinearInitializer (the
upsampling kernel), which write their values by assign_value.
"""

from __future__ import annotations

import math

import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            "fill_constant", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)},
            infer_shape=False)


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            "uniform_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": float(self.low), "max": float(self.high),
                   "seed": self.seed},
            infer_shape=False)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": float(self.loc), "std": float(self.scale),
                   "seed": self.seed},
            infer_shape=False)


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "truncated_gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": float(self.loc), "std": float(self.scale),
                   "seed": self.seed},
            infer_shape=False)


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels (out_c, in_c, kh, kw)
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0,
                 negative_slope=0.0, nonlinearity="relu"):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """The bilinear upsampling kernel of a transposed convolution."""

    @staticmethod
    def _weight(shape):
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype="float32")
        size = shape[3]
        for i in range(np.prod(shape)):
            x = i % size
            y = (i // size) % size
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return weight

    def __call__(self, var, block):
        NumpyArrayInitializer(self._weight(var.shape))(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op(
            "assign_value", outputs={"Out": [var.name]},
            attrs={"shape": list(self.value.shape), "dtype": var.dtype,
                   "values": self.value},
            infer_shape=False)


# Public aliases matching fluid.initializer
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
NumpyArray = NumpyArrayInitializer


_GLOBAL_WEIGHT_INIT = [None]
_GLOBAL_BIAS_INIT = [None]


def set_global_initializer(weight_init, bias_init=None):
    """The default initializer create_parameter uses when neither the
    ParamAttr nor the layer supplies one.  Pass None to clear."""
    _GLOBAL_WEIGHT_INIT[0] = weight_init
    _GLOBAL_BIAS_INIT[0] = bias_init


def _global_initializer(is_bias):
    return _GLOBAL_BIAS_INIT[0] if is_bias else _GLOBAL_WEIGHT_INIT[0]
