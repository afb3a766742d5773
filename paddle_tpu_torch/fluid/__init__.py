"""paddle_tpu_torch.fluid: the Fluid static-graph front end on PyTorch
(counterpart of paddle_tpu/fluid).

    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 4], "float32")
        y = fluid.data("y", [-1, 1], "float32")
        loss = fluid.layers.mean(fluid.layers.loss.square_error_cost(
            fluid.layers.fc(x, 1), y))
        fluid.optimizer.SGD(0.01).minimize(loss)
    exe = fluid.Executor()          # the card; fluid.CPUPlace() for the host
    exe.run(startup)
    exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])

Programs serialize to the same JSON as the reference's (`to_dict`), so one
built by either package runs in both Executors.
"""

from __future__ import annotations

from . import core, unique_name
from .core import CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPlace
from .framework import (Program, Variable, Parameter, OpRole,
                        default_main_program, default_startup_program,
                        program_guard, in_dygraph_mode, name_scope)
from .executor import (Executor, LazyFetch, Scope, global_scope,
                       scope_guard)
from .backward import append_backward, gradients
from . import initializer, regularizer, clip
from .param_attr import ParamAttr, WeightNormParamAttr
from . import layers
from . import optimizer
from . import dygraph
from .layers.tensor import data
from . import contrib, metrics  # noqa: E402,F401


def cpu_places(device_count=1):
    return [CPUPlace() for _ in range(device_count)]


def cuda_places(device_ids=None):
    """A CUDAPlace for each id given, else for each visible card."""
    import torch

    ids = device_ids if device_ids is not None \
        else range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in ids]
