"""Data and model parallelism over the process group (counterpart of
paddle_tpu/parallel): the mesh over data x fsdp x tp, the spec rules and
layouts, and the compiler's arms.  Pipeline, ring and Ulysses attention,
MoE, LocalSGD's step and quantized collectives wait for ROADMAP queue 1
item 10b (ii)-(iv)."""

from . import spec_layout, spec_rules  # noqa: F401
from .compiler import CompiledProgram  # noqa: F401
from .mesh import (DATA_AXIS, FSDP_AXIS, MODEL_AXIS, PIPE_AXIS,  # noqa
                   SEQ_AXIS, TP_AXIS, Mesh, axis_group, axis_rank,
                   batch_spec, current_mesh, global_mesh, make_mesh,
                   set_current_mesh, shard_host_batch)
from .spec_layout import (DEFAULT_LAYOUT, PartitionSpec, SpecLayout,  # noqa
                          clear_specs, mesh_axes_dict, placements,
                          register_spec, registered_specs, spec_for,
                          spec_from_json, spec_to_json, validate_spec)
