"""paddle.static, the 2.x static-graph namespace (counterpart of
paddle_tpu/static/__init__.py): aliases over the port's `fluid`.

CompiledProgram, BuildStrategy, ExecutionStrategy and the
ParallelExecutor shim run on one card (fluid/compiler.py); save / load
and load_program_state come from `fluid.io`; save_inference_model /
load_inference_model are the 2.x `inference` forms, as in the reference.
"""

from ..fluid import (  # noqa: F401
    Executor, Program, Scope, append_backward, cpu_places, cuda_places,
    default_main_program, default_startup_program, global_scope,
    gradients, program_guard, scope_guard,
)
from ..fluid.compiler import (BuildStrategy, CompiledProgram,  # noqa
                              ExecutionStrategy)
from ..fluid.framework import Variable, name_scope  # noqa: F401
from ..fluid.io import load, save  # noqa: F401
from ..fluid.layers import (Print, create_global_var,  # noqa: F401
                            create_parameter, py_func)
from ..fluid.layers.tensor import data  # noqa: F401
from ..fluid.param_attr import WeightNormParamAttr  # noqa: F401
from ..inference import (load_inference_model,  # noqa: F401
                         save_inference_model)
from . import nn  # noqa: F401


class InputSpec:
    """An input's signature: shape, dtype and name (Paddle's
    static/input.py InputSpec)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, str(tensor.dtype).replace("torch.", ""),
                   name or getattr(tensor, "name", None))

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype!r}, "
                f"name={self.name!r})")


def load_program_state(path):
    """The {name: ndarray} dict that `save` wrote at `path`."""
    state = load(path)
    return dict(state) if isinstance(state, dict) else state


def set_program_state(program, state):
    """Bind arrays into the global scope by variable name; a key that
    names no variable of `program` raises (a typo would leave the
    initial weights in place)."""
    import torch

    known = {v.name for blk in program.blocks for v in blk.vars.values()}
    unknown = sorted(set(state) - known)
    if unknown:
        raise ValueError(
            f"set_program_state: {len(unknown)} state keys not in the "
            f"program: {unknown[:5]}{'...' if len(unknown) > 5 else ''}")
    scope = global_scope()
    for name, value in state.items():
        scope.set(name, value if isinstance(value, torch.Tensor)
                  else torch.as_tensor(value))


class ParallelExecutor:
    """The reference's shim (paddle_tpu/static/__init__.py:89-116):
    `ParallelExecutor(use_cuda, loss_name=...)` runs the program through
    a CompiledProgram and an Executor on one card (the CPU without
    `use_cuda`).  More than one trainer raises (ROADMAP queue 1 item
    10)."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        from ..fluid import CPUPlace

        if num_trainers != 1 or trainer_id != 0:
            raise NotImplementedError(
                f"ParallelExecutor num_trainers={num_trainers}: more than "
                "one trainer waits for ROADMAP queue 1 item 10")
        self._program = main_program or default_main_program()
        self._compiled = CompiledProgram(self._program).with_data_parallel(
            loss_name=loss_name, exec_strategy=exec_strategy,
            build_strategy=build_strategy,
            share_vars_from=getattr(share_vars_from, "_compiled", None))
        self._scope = scope
        self._exe = Executor(None if use_cuda else CPUPlace())

    def run(self, fetch_list=None, feed=None, feed_dict=None,
            return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._exe.run(self._compiled, feed=feed,
                             fetch_list=fetch_list, scope=self._scope,
                             return_numpy=return_numpy)


__all__ = [
    "append_backward", "gradients", "Executor", "global_scope",
    "scope_guard", "name_scope", "program_guard", "WeightNormParamAttr",
    "default_main_program", "default_startup_program", "Program", "data",
    "InputSpec", "set_program_state", "cpu_places", "cuda_places",
    "Variable", "Scope", "nn", "create_global_var", "create_parameter",
    "Print", "BuildStrategy", "CompiledProgram", "ExecutionStrategy",
    "ParallelExecutor", "save", "load", "load_program_state",
]
