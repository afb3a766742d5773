"""paddle.static, the 2.x static-graph namespace (counterpart of
paddle_tpu/static/__init__.py): aliases over the port's `fluid`.

Left out until their modules are ported (ROADMAP queue 1 items 8 and
11): CompiledProgram, BuildStrategy, ExecutionStrategy and
ParallelExecutor (data-parallel compilation), save / load and
load_program_state (`fluid.io`), save_inference_model /
load_inference_model (`inference`).
"""

from ..fluid import (  # noqa: F401
    Executor, Program, Scope, append_backward, cpu_places, cuda_places,
    default_main_program, default_startup_program, global_scope,
    gradients, program_guard, scope_guard,
)
from ..fluid.framework import Variable, name_scope  # noqa: F401
from ..fluid.layers import (Print, create_global_var,  # noqa: F401
                            create_parameter, py_func)
from ..fluid.layers.tensor import data  # noqa: F401
from ..fluid.param_attr import WeightNormParamAttr  # noqa: F401
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


__all__ = [
    "append_backward", "gradients", "Executor", "global_scope",
    "scope_guard", "name_scope", "program_guard", "WeightNormParamAttr",
    "default_main_program", "default_startup_program", "Program", "data",
    "InputSpec", "set_program_state", "cpu_places", "cuda_places",
    "Variable", "Scope", "nn", "create_global_var", "create_parameter",
    "Print",
]
