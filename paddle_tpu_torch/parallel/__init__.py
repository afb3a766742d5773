"""Data and model parallelism over the process group (counterpart of
paddle_tpu/parallel): the mesh over data x fsdp x tp x seq, the spec
rules and layouts, the compiler's arms, the int8 quantized collectives,
and ring and Ulysses attention.  Pipeline, MoE and LocalSGD's step wait
for ROADMAP queue 1 item 10b (iv)."""

from . import quant_collectives, spec_layout, spec_rules  # noqa: F401
from .compiler import CompiledProgram  # noqa: F401
from .mesh import (DATA_AXIS, FSDP_AXIS, MODEL_AXIS, PIPE_AXIS,  # noqa
                   SEQ_AXIS, TP_AXIS, Mesh, axis_group, axis_rank,
                   batch_spec, current_mesh, global_mesh, make_mesh,
                   seq_axis, set_current_mesh, shard_host_batch)
from .ring_attention import ring_attention, ring_attention_local  # noqa
from .ulysses import ulysses_attention, ulysses_attention_local  # noqa
from .spec_layout import (DEFAULT_LAYOUT, PartitionSpec, SpecLayout,  # noqa
                          clear_specs, mesh_axes_dict, placements,
                          register_spec, registered_specs, spec_for,
                          spec_from_json, spec_to_json, validate_spec)
