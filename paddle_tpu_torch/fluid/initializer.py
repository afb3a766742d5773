"""Parameter initializers as ops (counterpart of
paddle_tpu/fluid/initializer.py).

Each initializer appends a fill or random op for its parameter to the
*startup program*, so initialization is itself a Program the Executor runs
once, as in the reference: ConstantInitializer (fill_constant),
UniformInitializer (uniform_random), NormalInitializer (gaussian_random),
and XavierInitializer, which sizes a uniform or normal draw from the
fan-in and fan-out.
"""

from __future__ import annotations

import math


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


# Public aliases matching fluid.initializer
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer


_GLOBAL_WEIGHT_INIT = [None]
_GLOBAL_BIAS_INIT = [None]


def set_global_initializer(weight_init, bias_init=None):
    """The default initializer create_parameter uses when neither the
    ParamAttr nor the layer supplies one.  Pass None to clear."""
    _GLOBAL_WEIGHT_INIT[0] = weight_init
    _GLOBAL_BIAS_INIT[0] = bias_init


def _global_initializer(is_bias):
    return _GLOBAL_BIAS_INIT[0] if is_bias else _GLOBAL_WEIGHT_INIT[0]
