"""Parameter initializers BERT and the vision models use (counterpart of
paddle_tpu/fluid/initializer.py).  Each draws from the torch.Generator it
is given, in float32 on the CPU, so a seed gives the same weights on
every device.  The reference's twelve 2.x names are here: the four
above, and Assign, Bilinear, KaimingNormal / KaimingUniform,
MSRAInitializer, XavierInitializer, XavierNormal / XavierUniform over
the fluid initializers (paddle_tpu/nn/initializer/__init__.py)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


class Initializer:
    def __call__(self, shape: Sequence[int],
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def __call__(self, shape, generator=None):
        return torch.full(tuple(shape), self.value, dtype=torch.float32)


class Uniform(Initializer):
    """Uniform on [low, high)."""

    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self.low, self.high = float(low), float(high)

    def __call__(self, shape, generator=None):
        t = torch.empty(tuple(shape), dtype=torch.float32)
        return t.uniform_(self.low, self.high, generator=generator)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, shape, generator=None):
        t = torch.empty(tuple(shape), dtype=torch.float32)
        return t.normal_(self.mean, self.std, generator=generator)


class TruncatedNormal(Initializer):
    """Normal(mean, std) redrawn outside mean +- 2 std (Paddle's
    truncated_gaussian_random)."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, shape, generator=None):
        t = torch.empty(tuple(shape), dtype=torch.float32)
        return torch.nn.init.trunc_normal_(
            t, self.mean, self.std, a=self.mean - 2 * self.std,
            b=self.mean + 2 * self.std, generator=generator)


class Xavier(Initializer):
    """Glorot uniform over (fan_in, fan_out) = shape[0], shape[1] of a
    Paddle (in, out) weight."""

    def __call__(self, shape, generator=None):
        fan_in, fan_out = (shape[0], shape[1]) if len(shape) >= 2 \
            else (shape[0], shape[0])
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        t = torch.empty(tuple(shape), dtype=torch.float32)
        return t.uniform_(-limit, limit, generator=generator)


def _fan_in(shape) -> int:
    """paddle_tpu's `_fan_in_out` fan-in: shape[0] of a (in, out) weight,
    in_c x receptive field of an (out_c, in_c, kh, kw) kernel."""
    if len(shape) == 0:
        return 1
    if len(shape) <= 2:
        return shape[0]
    return shape[1] * math.prod(shape[2:])


class MSRA(Initializer):
    """Kaiming (MSRAInitializer, paddle_tpu/fluid/initializer.py:167):
    uniform in +-sqrt(6 / fan_in), or normal with std sqrt(2 / fan_in);
    `fan_in` defaults to the shape's."""

    def __init__(self, uniform: bool = True, fan_in: Optional[int] = None):
        self.uniform, self.fan_in = uniform, fan_in

    def __call__(self, shape, generator=None):
        fan_in = self.fan_in if self.fan_in is not None else _fan_in(shape)
        t = torch.empty(tuple(shape), dtype=torch.float32)
        if self.uniform:
            limit = math.sqrt(6.0 / fan_in)
            return t.uniform_(-limit, limit, generator=generator)
        return t.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


# -- the 2.x names over the fluid initializers (paddle_tpu/nn/initializer/
# __init__.py:6-33): each is the fluid class, so a static program's
# ParamAttr appends its startup op, and a Layer draws it eagerly here
# from the same fans (fluid.initializer._fan_in_out)

from ..fluid import initializer as _fluid


def _fans(shape):
    class _Shape:  # _fan_in_out reads `.shape` only
        pass

    s = _Shape()
    s.shape = list(shape)
    return _fluid._fan_in_out(s)


class _Eager(Initializer):
    """A fluid initializer a Layer can call with (shape, generator); a
    call with (var, block) appends the fluid class's startup op."""

    def __call__(self, shape, generator=None):
        if not isinstance(shape, (list, tuple, torch.Size)):
            return self._startup(shape, generator)
        return self._draw([int(s) for s in shape], generator)

    def _startup(self, var, block):
        for base in type(self).__mro__:
            if base.__module__ == _fluid.__name__:
                return base.__call__(self, var, block)
        raise TypeError(f"{type(self).__name__} has no fluid initializer")


def _uniform(shape, limit, generator):
    t = torch.empty(tuple(shape), dtype=torch.float32)
    return t.uniform_(-limit, limit, generator=generator)


def _normal(shape, std, generator):
    t = torch.empty(tuple(shape), dtype=torch.float32)
    return t.normal_(0.0, std, generator=generator)


class XavierInitializer(_Eager, _fluid.XavierInitializer):
    """Glorot: uniform in +-sqrt(6 / (fan_in + fan_out)), or normal with
    std sqrt(2 / (fan_in + fan_out)); fans from the shape unless given."""

    def _draw(self, shape, generator):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            return _uniform(shape, math.sqrt(6.0 / (fi + fo)), generator)
        return _normal(shape, math.sqrt(2.0 / (fi + fo)), generator)


class MSRAInitializer(_Eager, _fluid.MSRAInitializer):
    """Kaiming: uniform in +-sqrt(6 / fan_in), or normal with std
    sqrt(2 / fan_in); fan_in from the shape unless given."""

    def _draw(self, shape, generator):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        if self.uniform:
            return _uniform(shape, math.sqrt(6.0 / fi), generator)
        return _normal(shape, math.sqrt(2.0 / fi), generator)


class XavierNormal(XavierInitializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        super().__init__(uniform=False, fan_in=fan_in, fan_out=fan_out)


class XavierUniform(XavierInitializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        super().__init__(uniform=True, fan_in=fan_in, fan_out=fan_out)


class KaimingNormal(MSRAInitializer):
    def __init__(self, fan_in=None, name=None):
        super().__init__(uniform=False, fan_in=fan_in)


class KaimingUniform(MSRAInitializer):
    def __init__(self, fan_in=None, name=None):
        super().__init__(uniform=True, fan_in=fan_in)


class Bilinear(_Eager, _fluid.BilinearInitializer):
    """The bilinear upsampling kernel of a transposed convolution."""

    def _draw(self, shape, generator):
        return torch.from_numpy(self._weight(shape))


class Assign(_Eager, _fluid.NumpyArrayInitializer):
    """The given values (a shape of the same size takes them reshaped)."""

    def _draw(self, shape, generator):
        value = np.asarray(self.value, dtype=np.float32)
        if value.size != math.prod(shape):
            raise ValueError(f"Assign: {value.shape} values for a parameter "
                             f"of shape {shape}")
        return torch.from_numpy(value.reshape(shape).copy())
