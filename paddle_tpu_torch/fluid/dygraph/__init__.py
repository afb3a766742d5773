"""Eager mode (counterpart of paddle_tpu/fluid/dygraph: base.py's
guard, enable_dygraph / disable_dygraph and to_variable, tracer.py's
no_grad, enable_grad and manual_seed, engine.py's grad).

The port's eager Tensor is `torch.Tensor` and its tape is torch
autograd: the reference's VarBase and op tracer have no counterpart
here.  `guard()` only switches `fluid.framework.in_dygraph_mode()`,
which is what chooses hapi.Model's adapter, as in the reference.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ... import device as _device
from .. import core, framework


def enabled() -> bool:
    return framework.in_dygraph_mode()


def enable_dygraph(place=None):
    framework._DYGRAPH[0] = True


def disable_dygraph():
    framework._DYGRAPH[0] = False


@contextlib.contextmanager
def guard(place=None):
    """Eager mode inside the block."""
    old = framework._DYGRAPH[0]
    framework._DYGRAPH[0] = True
    try:
        yield
    finally:
        framework._DYGRAPH[0] = old


def to_variable(value, name=None, zero_copy=None, dtype=None):
    """numpy, a list or a tensor as a tensor on the current device (that
    of `device.get_device()`), gradient-free."""
    if isinstance(value, torch.Tensor):
        return value if dtype is None else value.to(core.torch_dtype(dtype))
    out = torch.as_tensor(np.asarray(value), device=_device.get_device())
    return out if dtype is None else out.to(core.torch_dtype(dtype))


no_grad = torch.no_grad
enable_grad = torch.enable_grad


def manual_seed(seed):
    torch.manual_seed(int(seed))


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """Gradients of `outputs` with respect to `inputs`, as a list,
    without touching `.grad` (reference: engine.py grad)."""
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is not None and not isinstance(grad_outputs,
                                                   (list, tuple)):
        grad_outputs = [grad_outputs]
    if retain_graph is None:
        retain_graph = create_graph
    res = torch.autograd.grad(outputs, inputs, grad_outputs,
                              retain_graph=retain_graph,
                              create_graph=create_graph,
                              allow_unused=True)
    if not allow_unused and any(g is None for g in res):
        raise RuntimeError("one of the inputs has no gradient path to "
                           "outputs; set allow_unused=True to return None "
                           "for it")
    return list(res)


# the 2.x classes the reference also gives under fluid.dygraph, resolved
# on first use (nn imports fluid, so an import here would cycle)
_NN_ALIASES = {"GRUCell": "GRUCell", "LSTMCell": "LSTMCell"}


def __getattr__(name):
    if name in _NN_ALIASES:
        from ... import nn
        return getattr(nn, _NN_ALIASES[name])
    raise AttributeError(name)
