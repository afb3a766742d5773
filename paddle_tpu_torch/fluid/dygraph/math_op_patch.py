"""The reference's eager Tensor methods and operators
(paddle_tpu/fluid/dygraph/math_op_patch.py:79-196) that torch does not
already answer the same way, on `torch.Tensor`.

Installed:
- `scale(scale=1.0, bias=0.0)`: x * scale + bias (torch has no `scale`);
- `matmul(y, transpose_x=False, transpose_y=False)`: torch's `matmul`,
  extended by the two flags; a call torch accepts gets torch's answer;
- `unsqueeze(axis)` with a list or tuple of axes, positions of the
  output (negative ones counted from its end), as the reference's
  `unsqueeze2`; an int (or `dim=`) gets torch's answer.

Left out, with the reason:
- the operators (`+ - * / // % **`, their reflected forms, `@`, unary
  `-` and `abs`, the six comparisons): torch answers the same, and a
  Python scalar takes a float tensor's dtype in both;
- `exp`, `log`, `sqrt`, `rsqrt`, `tanh`, `abs`, `square`, `pow`: the
  same in torch;
- `mean(axis, keepdim)`, `argmax(axis, keepdim)`, `flatten(start_axis,
  stop_axis)`, `squeeze(axis)` (an int, a list or None): torch takes the
  same positional arguments (and `axis=`) to the same answer;
- `reshape(shape)`: torch's does not read Paddle's 0 (copy the input's
  dim); `transpose(perm)`: torch's swaps two dims; `sum(axis, dtype,
  keepdim)`: torch's second argument is keepdim; `max(axis, keepdim)` and
  `min(axis, keepdim)`: torch's give (values, indices) for a dim.  Torch
  keeps its meaning for these four; the Paddle forms are the functions
  `paddle_tpu_torch.tensor.reshape / transpose / sum / max / min`.
"""

from __future__ import annotations

import torch

from .varbase import add_method

_TORCH_MATMUL = torch.Tensor.matmul
_TORCH_UNSQUEEZE = torch.Tensor.unsqueeze


def scale(self, scale=1.0, bias=0.0):
    return self * scale + bias


def matmul(self, other, transpose_x=False, transpose_y=False):
    if transpose_x and self.ndim > 1:
        self = self.transpose(-1, -2)
    if transpose_y and other.ndim > 1:
        other = other.transpose(-1, -2)
    return _TORCH_MATMUL(self, other)


def unsqueeze(self, axis=None, *, dim=None):
    axis = dim if axis is None else axis
    if not isinstance(axis, (list, tuple)):
        return _TORCH_UNSQUEEZE(self, axis)
    n = self.ndim + len(axis)
    out = self
    for a in sorted(a if a >= 0 else a + n for a in axis):
        out = _TORCH_UNSQUEEZE(out, a)
    return out


ADDED = {"scale": scale}
EXTENDED = {"matmul": matmul, "unsqueeze": unsqueeze}


def install():
    for name, fn in ADDED.items():
        add_method(name, fn)
    for name, fn in EXTENDED.items():
        setattr(torch.Tensor, name, fn)
