"""Tensor creation (counterpart of paddle_tpu/tensor/__init__.py:36-200).

Each function makes a `torch.Tensor` on the current device (that of
`device.get_device()`: cuda unless set otherwise) with Paddle's
signature and defaults: float32 for float data and creation without a
dtype, int64 for arange and the integer draws.  Random draws use
torch's generators, which `seed` seeds; their values differ from the
JAX package's, whose keys are its own.  The rest of the 2.x tensor API
is still to be ported (ROADMAP module 4).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from ..fluid import core

__all__ = ["to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
           "full_like", "arange", "linspace", "eye", "rand", "randn",
           "randint", "randperm", "uniform", "normal", "seed"]


def _dt(dtype, default="float32"):
    return core.torch_dtype(dtype or default)


def _dev(place=None):
    return _device.resolve(place)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """data (numpy, a list, a scalar or a tensor) as a tensor on `place`
    (default: the current device).  Python floats become float32 and
    arrays keep their dtype, as in the reference; `stop_gradient=False`
    makes a leaf that requires grad."""
    if isinstance(data, torch.Tensor):
        out = data.detach().to(_dev(place))
    else:
        arr = np.asarray(data)
        if dtype is None and not hasattr(data, "dtype") \
                and arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        out = torch.as_tensor(arr, device=_dev(place))
    if dtype is not None:
        out = out.to(_dt(dtype))
    if not stop_gradient:
        out = out.clone().requires_grad_(True)
    return out


def zeros(shape, dtype=None, name=None):
    return torch.zeros(list(shape), dtype=_dt(dtype), device=_dev())


def ones(shape, dtype=None, name=None):
    return torch.ones(list(shape), dtype=_dt(dtype), device=_dev())


def full(shape, fill_value, dtype=None, name=None):
    return torch.full(list(shape), float(fill_value), dtype=_dt(dtype),
                      device=_dev())


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=None if dtype is None else _dt(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=None if dtype is None else _dt(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, float(fill_value),
                           dtype=None if dtype is None else _dt(dtype))


def arange(start=0, end=None, step=1, dtype="int64", name=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=_dt(dtype), device=_dev())


def linspace(start, stop, num, dtype="float32", name=None):
    return torch.linspace(start, stop, int(num), dtype=_dt(dtype),
                          device=_dev())


def eye(num_rows, num_columns=None, dtype="float32", name=None):
    return torch.eye(num_rows, num_columns or num_rows, dtype=_dt(dtype),
                     device=_dev())


def rand(shape, dtype="float32", name=None):
    return torch.rand(list(shape), dtype=_dt(dtype), device=_dev())


def randn(shape, dtype="float32", name=None):
    return torch.randn(list(shape), dtype=_dt(dtype), device=_dev())


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None):
    gen = None
    if seed:
        gen = torch.Generator(device=_dev()).manual_seed(int(seed))
    out = torch.empty(list(shape), dtype=_dt(dtype), device=_dev())
    return out.uniform_(float(min), float(max), generator=gen)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    out = torch.empty(list(shape), dtype=torch.float32, device=_dev())
    return out.normal_(float(mean), float(std))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return torch.randint(low, high, list(shape), dtype=_dt(dtype),
                         device=_dev())


def randperm(n, dtype="int64", name=None):
    return torch.randperm(n, dtype=_dt(dtype), device=_dev())


def seed(value):
    """Seed torch's generators (every device's), which the draws above
    and layers made without a generator of their own use."""
    torch.manual_seed(int(value))
