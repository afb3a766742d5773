"""The Paddle-named methods of the eager Tensor (counterpart of
paddle_tpu/fluid/dygraph/varbase.py).

The port's eager Tensor is `torch.Tensor` itself, so a method added here
is added for the whole process.  The rule (ROADMAP queue 1 item 7):

- Names torch lacks are added: `astype`, `cast`, `clear_gradient` and
  `clear_grad`, `gradient`, `set_value`, and the properties
  `stop_gradient` (over `requires_grad`), `place` and `persistable`.
- `numpy()` is the one torch name overridden.  Where torch answers (a
  CPU tensor with no grad, no conjugate or negative bit) the result is
  torch's own array, sharing memory; where torch would raise (a CUDA
  tensor, one that requires grad) it detaches and copies to the host,
  as the reference's `numpy()` works on any tensor (varbase.py:90).
  torch's `__array__` calls `numpy()`, so `np.asarray(t)` of such a
  tensor copies too, where it raised before.
- Every other name torch has keeps torch's meaning, and those whose
  Paddle meaning differs are reached as functions:
  `paddle_tpu_torch.tensor.<name>(x, ...)`.  `shape` (a list in
  Paddle), `size` (an int property), `dtype` (a string), `transpose`
  (a permutation), `reshape`, `squeeze`, `flatten`, `sum` / `mean` /
  `max` / `min` / `argmax` (Paddle's axis, keepdim and dtype order;
  torch's max(dim) gives values and indices), `pow`, `detach`, `clone`,
  `item`, `tolist`, `numel`, `backward`, `grad`, `is_leaf`,
  `register_hook`, `copy_`, `fill_`, `zero_`, `cuda`, `cpu`,
  `pin_memory` (the reference's are no-ops; torch's move the tensor)
  and the operators.

`Tensor` and `VarBase` name `torch.Tensor`.  `install()` runs once, at
the import of `fluid.dygraph`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import core

Tensor = torch.Tensor
VarBase = torch.Tensor

_TORCH_NUMPY = torch.Tensor.numpy


def numpy(self, *, force=False):
    """The values as a numpy array: torch's own where torch answers,
    else a detached host copy."""
    if force or self.device.type != "cpu" or self.requires_grad \
            or self.is_conj() or self.is_neg():
        return _TORCH_NUMPY(self, force=True)
    return _TORCH_NUMPY(self)


def astype(self, dtype):
    """A copy cast to `dtype` (a Paddle dtype name, numpy or torch
    dtype); differentiable, as the reference's `cast` op."""
    return self.to(core.torch_dtype(dtype))


def clear_gradient(self, set_to_zero=False):
    """Drop the gradient, or with `set_to_zero` put a new zero tensor in
    its place (as the reference rebinds a new zero array): an array that
    `gradient()` gave keeps its values."""
    if set_to_zero and self.grad is not None:
        self.grad = torch.zeros_like(self.grad)
    else:
        self.grad = None


def gradient(self):
    """The gradient as a numpy array on the host, None when there is
    none: a copy, which neither a later backward's accumulation nor
    `clear_gradient` changes (the reference's is a snapshot)."""
    g = self.grad
    if g is None:
        return None
    out = numpy(g)
    return out.copy() if g.device.type == "cpu" else out


def set_value(self, value):
    """Replace the values in place by `value` (numpy, a list or a
    tensor) of the same shape, cast to this tensor's dtype."""
    src = value if isinstance(value, torch.Tensor) \
        else torch.as_tensor(np.asarray(value))
    if tuple(src.shape) != tuple(self.shape):
        raise ValueError(f"set_value shape mismatch: {list(src.shape)} vs "
                         f"{list(self.shape)}")
    with torch.no_grad():
        self.copy_(src.to(device=self.device, dtype=self.dtype))


def _get_stop_gradient(self):
    return not self.requires_grad


def _set_stop_gradient(self, value):
    self.requires_grad_(not value)


def _place(self):
    return f"{self.device.type}:{self.device.index or 0}"


def _get_persistable(self):
    return self.__dict__.get("_persistable",
                             isinstance(self, torch.nn.Parameter))


def _set_persistable(self, value):
    self.__dict__["_persistable"] = bool(value)


# name -> what is installed: names torch.Tensor lacks
METHODS = {
    "astype": astype,
    "cast": astype,
    "clear_gradient": clear_gradient,
    "clear_grad": clear_gradient,
    "gradient": gradient,
    "set_value": set_value,
    "stop_gradient": property(_get_stop_gradient, _set_stop_gradient),
    "place": property(_place),
    "persistable": property(_get_persistable, _set_persistable),
}

def add_method(name, fn):
    """torch.Tensor.<name> = fn, for a name torch itself lacks (raises
    otherwise); adding the same fn again is a no-op."""
    own = torch.Tensor.__dict__.get(name)
    if own is not fn and (own is not None
                          or hasattr(torch._C.TensorBase, name)):
        raise RuntimeError(f"torch.Tensor already has {name!r}")
    setattr(torch.Tensor, name, fn)


def install():
    """Add METHODS to torch.Tensor and override `numpy` (idempotent)."""
    for name, fn in METHODS.items():
        add_method(name, fn)
    torch.Tensor.numpy = numpy
