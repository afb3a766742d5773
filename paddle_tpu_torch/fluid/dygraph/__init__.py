"""Eager mode (counterpart of paddle_tpu/fluid/dygraph: base.py's
guard, enable_dygraph / disable_dygraph and to_variable, tracer.py's
no_grad, enable_grad, manual_seed and trace_op, engine.py's grad,
save_dygraph / load_dygraph, and the 1.x layer and LR classes of nn.py).

The port's eager Tensor is `torch.Tensor` and its tape is torch
autograd: the reference's op tracer has no counterpart here.
`varbase.py` gives torch.Tensor the Paddle-named methods torch lacks
and a `numpy()` that works on any tensor, `math_op_patch.py` the few
methods torch answers otherwise; both install at this import
(ROADMAP queue 1 item 7 says which names and why).  `guard()` only
switches `fluid.framework.in_dygraph_mode()`, which is what chooses
hapi.Model's adapter, as in the reference.

`DataParallel`, `ParallelEnv` and `prepare_context` are the data-parallel
names (parallel.py, over distributed/).  Not ported: the jit names
`declarative`, `dygraph_to_static_func`,
`set_code_level`, `set_verbosity`, `TracedLayer`, `TranslatedLayer` and
`ProgramTranslator` (queue 1 item 12), which raise NotImplementedError.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ... import device as _device
from .. import core, framework
from . import math_op_patch, varbase
from .varbase import Tensor, VarBase  # noqa: F401
from ...framework_io import load, save  # noqa: F401

varbase.install()
math_op_patch.install()


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
no_grad_ = no_grad_decorator = torch.no_grad
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


def run_backward(tensors, grad_tensors=None, retain_graph=False):
    """Backward from `tensors` (with `grad_tensors` as their cotangents),
    accumulating into the leaves' `.grad` (reference: engine.py)."""
    torch.autograd.backward(list(tensors), grad_tensors,
                            retain_graph=retain_graph)


def trace_op(op_type, inputs, attrs=None, multi_out=False):
    """Run the registry's rule of `op_type` once, eagerly, on `inputs`
    (slot -> tensor or list; reference: tracer.py:251).  Returns the one
    output tensor when the rule gives one, else {slot: [tensors]}."""
    from ... import tensor as _tensor

    outs = _tensor._run(op_type, inputs, attrs)
    if not multi_out:
        filled = [vs for vs in outs.values() if vs]
        if len(filled) == 1 and len(filled[0]) == 1:
            return filled[0][0]
    return outs


def save_dygraph(state_dict, model_path):
    """A state dict to `<model_path>.pdparams`, or to `.pdopt` for an
    optimizer's (it carries the "global_step" or "LR_Scheduler" key, which
    no layer's parameter names give; reference: dygraph/__init__.py:85)."""
    is_opt = "global_step" in state_dict or "LR_Scheduler" in state_dict
    save(state_dict, model_path + (".pdopt" if is_opt else ".pdparams"))


def load_dygraph(model_path):
    """(parameter dict, optimizer dict) from `<model_path>.pdparams` and
    `.pdopt`, None for a file that is not there; a bare `model_path`
    file is read as the parameters."""
    import os

    params = opt = None
    if os.path.exists(model_path + ".pdparams"):
        params = load(model_path + ".pdparams")
    if os.path.exists(model_path + ".pdopt"):
        opt = load(model_path + ".pdopt")
    if params is None and opt is None and os.path.exists(model_path):
        params = load(model_path)
    return params, opt


def _not_ported(name, item):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"fluid.dygraph.{name} is not ported: ROADMAP queue 1 item "
            f"{item}")

    fn.__name__ = name
    return fn


declarative = _not_ported("declarative", 12)
dygraph_to_static_func = _not_ported("dygraph_to_static_func", 12)
set_code_level = _not_ported("set_code_level", 12)
set_verbosity = _not_ported("set_verbosity", 12)
TracedLayer = _not_ported("TracedLayer", 12)
TranslatedLayer = _not_ported("TranslatedLayer", 12)
ProgramTranslator = _not_ported("ProgramTranslator", 12)
from ...distributed.parallel import ParallelEnv, prepare_context  # noqa
from .parallel import DataParallel  # noqa: F401

# names resolved on first use (nn imports fluid, so an import here would
# cycle): module, attribute
_NN_ALIASES = {
    "GroupNorm": ("nn", "GroupNorm"),
    "LayerNorm": ("nn", "LayerNorm"),
    "LayerList": ("nn", "LayerList"),
    "ParameterList": ("nn", "ParameterList"),
    "Sequential": ("nn", "Sequential"),
    "SpectralNorm": ("nn", "SpectralNorm"),
    "InstanceNorm": ("nn", "InstanceNorm2D"),
    "Layer": ("nn.layer.layers", "Layer"),
    "GRUCell": ("nn.layer.rnn", "GRUCell"),
    "LSTMCell": ("nn.layer.rnn", "LSTMCell"),
    # the 1.x signatures of five decays live in .nn; the others alias
    # the 2.x classes, whose arguments are the same
    "CosineDecay": ("fluid.dygraph.nn", "CosineDecay"),
    "ExponentialDecay": ("fluid.dygraph.nn", "ExponentialDecay"),
    "InverseTimeDecay": ("fluid.dygraph.nn", "InverseTimeDecay"),
    "NaturalExpDecay": ("fluid.dygraph.nn", "NaturalExpDecay"),
    "PiecewiseDecay": ("fluid.dygraph.nn", "PiecewiseDecay"),
    "LambdaDecay": ("optimizer.lr", "LambdaDecay"),
    "LinearLrWarmup": ("optimizer.lr", "LinearWarmup"),
    "MultiStepDecay": ("optimizer.lr", "MultiStepDecay"),
    "NoamDecay": ("optimizer.lr", "NoamDecay"),
    "PolynomialDecay": ("optimizer.lr", "PolynomialDecay"),
    "ReduceLROnPlateau": ("optimizer.lr", "ReduceOnPlateau"),
    "StepDecay": ("optimizer.lr", "StepDecay"),
    "amp_guard": ("amp", "auto_cast"),
    "AmpScaler": ("amp", "GradScaler"),
}
_NN_ALIASES.update({n: ("fluid.dygraph.nn", n) for n in (
    "BatchNorm", "BilinearTensorProduct", "Conv2D", "Conv2DTranspose",
    "Conv3D", "Conv3DTranspose", "Dropout", "Embedding", "Flatten",
    "GRUUnit", "Linear", "NCE", "Pool2D", "PRelu", "TreeConv")})


def __getattr__(name):
    if name in _NN_ALIASES:
        import importlib

        path, attr = _NN_ALIASES[name]
        obj = getattr(importlib.import_module(
            f"{__name__.rsplit('.', 2)[0]}.{path}"), attr)
        globals()[name] = obj
        return obj
    raise AttributeError(name)
