"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package `paddle_tpu` stays beside this one as the reference each
part of the port is held against (tests/test_torch_*.py).  This package
imports torch and numpy only: never jax, never paddle_tpu.

Its front ends: BERT served through `serving.Engine` and decoded through
`serving.AutoregressiveEngine` (the hand-written CUDA kernels under
`csrc/`), the Fluid static graph (`fluid`: Program, Executor), and the
2.x eager API below, whose Tensor is `torch.Tensor` and whose tape is
torch autograd:

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import LeNet

    model = paddle.Model(LeNet())
    model.prepare(paddle.optimizer.Adam(learning_rate=1e-3,
                                        parameters=model.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    model.fit(dataset, batch_size=64, epochs=1)

Entry points run on `cuda` unless the caller passes `device="cpu"` (or
calls `set_device("cpu")`); with no GPU and no device given they raise.
"""

import torch

from .device import get_device, set_device  # noqa: F401
from . import amp, fluid, hapi, io, metric, nn, optimizer, tensor  # noqa
from . import vision  # noqa: F401
from .fluid.dygraph import (disable_dygraph, enable_dygraph, grad,  # noqa
                            no_grad, to_variable)
from .fluid.framework import in_dygraph_mode  # noqa: F401
from .fluid.param_attr import ParamAttr  # noqa: F401
from .framework_io import load, save  # noqa: F401
from .hapi import Model, summary  # noqa: F401
from .nn import Layer  # noqa: F401
from .tensor import (arange, eye, full, full_like, linspace,  # noqa: F401
                     normal, ones, ones_like, rand, randint, randn,
                     randperm, seed, to_tensor, uniform, zeros, zeros_like)

Tensor = torch.Tensor


def enable_static():
    disable_dygraph()


def disable_static(place=None):
    enable_dygraph(place)
