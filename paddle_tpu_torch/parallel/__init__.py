"""Data parallelism over the process group (counterpart of
paddle_tpu/parallel): the mesh and the data arm of the compiler.  The
model-parallel modules (spec rules and layouts, pipeline, ring and
Ulysses attention, MoE, LocalSGD's step, quantized collectives) wait for
ROADMAP queue 1 item 10b."""

from .compiler import CompiledProgram  # noqa: F401
from .mesh import (DATA_AXIS, FSDP_AXIS, MODEL_AXIS, PIPE_AXIS,  # noqa
                   SEQ_AXIS, TP_AXIS, Mesh, batch_spec, current_mesh,
                   global_mesh, make_mesh, set_current_mesh,
                   shard_host_batch)
