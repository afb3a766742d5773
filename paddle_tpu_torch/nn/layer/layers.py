"""`paddle.nn.Layer` and its `Parameter` (counterpart of
paddle_tpu/nn/layer/layers.py:28-363).

`Layer` is a `torch.nn.Module` that also carries Paddle's names: a
`full_name()` from `fluid.unique_name`, parameters made by
`create_parameter` and named `{full_name}.w_N` / `.b_N` as the
reference names them, buffers that may stay out of `state_dict`
(`persistable=False`), `sublayers`, `state_dict` with structured keys
(every parameter first, then every persistable buffer, as the
reference orders them) and `set_state_dict`, which takes tensors or
numpy arrays and returns `(missing, unexpected)`.  Autograd is torch's:
a Parameter's gradient is its `.grad`, and `trainable` is
`requires_grad`.
"""

from __future__ import annotations

import copy
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from ...fluid import core, unique_name
from ...fluid.param_attr import ParamAttr
from ..initializer import Constant, Initializer, Xavier


def _torch_arg(v):
    """A Paddle device or dtype argument as torch takes it: 'gpu[:i]' is
    'cuda[:i]', a dtype name is its torch.dtype; anything else as is."""
    if isinstance(v, str):
        if v.startswith("gpu"):
            return "cuda" + v[3:]
        if v.lower() in core._DTYPE_ALIASES:
            return core.torch_dtype(v)
    elif isinstance(v, np.dtype):
        return core.torch_dtype(v)
    return v


class Parameter(nn.Parameter):
    """A parameter with the reference's attributes (its dygraph
    ParamBase): `name`, `trainable` (requires_grad), `optimize_attr`
    (the learning-rate multiplier), `regularizer` and `need_clip`.
    Arithmetic on it gives plain tensors, as on any nn.Parameter."""

    def __new__(cls, value, name=None, trainable=True, optimize_attr=None,
                regularizer=None, need_clip=True):
        p = super().__new__(cls, value, requires_grad=bool(trainable))
        p._name = name or unique_name.generate("param")
        p.optimize_attr = dict(optimize_attr or {"learning_rate": 1.0})
        p.regularizer = regularizer
        p.need_clip = need_clip
        return p

    @property
    def name(self):
        return self._name

    @name.setter
    def name(self, value):
        self._name = value

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = Parameter(self.data.clone(memory_format=torch.preserve_format),
                        self._name, self.requires_grad,
                        copy.deepcopy(self.optimize_attr, memo),
                        self.regularizer, self.need_clip)
        memo[id(self)] = out
        return out


class Layer(nn.Module):
    """Base class of the port's layers (reference: layers.py:60)."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        if name_scope is None:
            name_scope = self.__class__.__name__.lower()
        self._full_name = unique_name.generate(name_scope)
        self._dtype = dtype

    def full_name(self):
        return self._full_name

    # -- parameters and buffers ---------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, generator=None):
        """A new Parameter of `shape`, made on the CPU from `generator`
        (None: torch's default generator) by the attr's initializer, else
        `default_initializer`, else zeros for a bias and Xavier for a
        weight.  `attr` is a ParamAttr, a name, an initializer, or False
        (no parameter: returns None)."""
        if isinstance(attr, Initializer):
            attr = ParamAttr(initializer=attr)
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer or default_initializer or (
            Constant(0.0) if is_bias else Xavier())
        if not isinstance(init, Initializer):
            raise TypeError(f"{type(init).__name__} appends startup ops; "
                            "a Layer takes the initializers of "
                            "paddle_tpu_torch.nn.initializer")
        value = init([int(s) for s in shape], generator).to(
            core.torch_dtype(dtype or self._dtype))
        name = attr.name or unique_name.generate(
            f"{self._full_name}.{'b' if is_bias else 'w'}")
        return Parameter(value, name=name, trainable=attr.trainable,
                         optimize_attr={"learning_rate": attr.learning_rate},
                         regularizer=attr.regularizer,
                         need_clip=attr.need_clip)

    def create_variable(self, name=None, persistable=False, dtype=None):
        """A zero tensor of shape [1] in `dtype` (default: the layer's),
        with `persistable` set, as the reference's (layers.py:105); `name`
        is not kept (a torch tensor has none)."""
        t = torch.zeros([1], dtype=core.torch_dtype(dtype or self._dtype))
        t.persistable = persistable
        return t

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """A state tensor that is not a parameter (BN's running
        statistics); with `persistable=False` it stays out of
        state_dict.  Takes numpy too; returns the tensor."""
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=keep)
        return tensor

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    # -- traversal -------------------------------------------------------------
    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        memo = set() if layers_set is None else layers_set
        for name, layer in self.named_modules(memo=memo, prefix=prefix):
            if layer is self and not include_self:
                continue
            yield name, layer

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def parameters(self, include_sublayers=True, recurse=None):
        return list(super().parameters(
            include_sublayers if recurse is None else recurse))

    def clear_gradients(self, set_to_zero=False):
        for p in self.parameters():
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad = torch.zeros_like(p.grad)
            else:
                p.grad = None

    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, outputs) -> None or new outputs."""
        return self.register_forward_hook(hook)

    # -- state ------------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, **torch_kw):
        """{structured name: live tensor}: every parameter, then every
        persistable buffer (reference: layers.py:267).  Called with
        torch's keywords (prefix, keep_vars), it is torch's."""
        if torch_kw:
            return super().state_dict(destination=destination, **torch_kw)
        out = OrderedDict() if destination is None else destination
        prefix = structured_name_prefix.rstrip(".")
        for name, p in self.named_parameters(prefix=prefix,
                                             recurse=include_sublayers):
            out[name] = p
        layers = (self.named_sublayers(prefix=prefix, include_self=True)
                  if include_sublayers else [(prefix, self)])
        seen = set()
        for lp, layer in layers:
            for name, b in layer._buffers.items():
                if b is None or id(b) in seen \
                        or name in layer._non_persistent_buffers_set:
                    continue
                seen.add(id(b))
                out[lp + ("." if lp else "") + name] = b
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy `state_dict`'s values (tensors or numpy) into the live
        parameters and buffers of the same names, each cast to its
        target's dtype and device.  Returns (missing, unexpected) names;
        raises ValueError on a shape mismatch."""
        own = self.state_dict()
        unexpected = [k for k in state_dict if k not in own]
        missing = [k for k in own if k not in state_dict]
        with torch.no_grad():
            for name, value in state_dict.items():
                if name not in own:
                    continue
                target = own[name]
                src = value if isinstance(value, torch.Tensor) \
                    else torch.as_tensor(np.asarray(value))
                if tuple(src.shape) != tuple(target.shape):
                    raise ValueError(f"{name}: shape {list(src.shape)} vs "
                                     f"{list(target.shape)}")
                target.copy_(src.to(target.device, target.dtype))
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- dtype and device -------------------------------------------------------
    def to(self, *args, **kwargs):
        """torch's `to`, taking Paddle's forms too: to(device='gpu:0',
        dtype='bfloat16', blocking=False)."""
        blocking = kwargs.pop("blocking", None)
        if blocking is not None:
            kwargs["non_blocking"] = not blocking
        args = [_torch_arg(a) for a in args]
        kwargs = {k: _torch_arg(v) for k, v in kwargs.items()}
        if kwargs.get("device", 0) is None:
            del kwargs["device"]
        if kwargs.get("dtype", 0) is None:
            del kwargs["dtype"]
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        self._dtype = core.convert_dtype(dtype)
        return self.to(dtype=core.torch_dtype(dtype))
