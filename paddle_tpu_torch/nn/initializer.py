"""Parameter initializers BERT uses (counterpart of
paddle_tpu/fluid/initializer.py).  Each draws from the torch.Generator it
is given, in float32 on the CPU, so a seed gives the same weights on
every device."""

from __future__ import annotations

import math
from typing import Optional, Sequence

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
