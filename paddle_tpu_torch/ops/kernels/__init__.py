"""Hand-written Hopper kernels (counterparts of paddle_tpu/ops/pallas and
of the layout probe tools/kernel4d_probe.py).

Each module holds a kernel's wrapper, its plain PyTorch version and its
launch counter; the CUDA sources are under paddle_tpu_torch/csrc and are
built on first use (build.py).
"""

from .attention import FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD, RAGGED_PAGED
from .ffn import (FFN_ACT_BWD, FFN_ACT_FWD, FFN_BWD_DW, FFN_BWD_DX,
                  FFN_FWD)
from .probe import PROBE_4D, PROBE_FOLD3D, PROBE_MERGED

# every kernel's launch counter, by kernel name
COUNTERS = {c.name: c for c in (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ,
                                FFN_FWD, FFN_BWD_DW, FFN_BWD_DX,
                                RAGGED_PAGED, PROBE_4D, PROBE_FOLD3D,
                                PROBE_MERGED, FFN_ACT_FWD, FFN_ACT_BWD)}
