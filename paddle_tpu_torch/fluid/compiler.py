"""fluid.compiler — the CompiledProgram of parallel/compiler.py
(counterpart of paddle_tpu/fluid/compiler.py)."""

from ..parallel.compiler import (BuildStrategy, CompiledProgram,  # noqa
                                 ExecutionStrategy)
