"""Hand-written Hopper kernels (counterparts of paddle_tpu/ops/pallas).

Each module holds a kernel's wrapper, its plain PyTorch version and its
launch counter; the CUDA sources are under paddle_tpu_torch/csrc and are
built on first use (build.py).
"""

from .attention import FLASH_FWD
from .ffn import FFN_FWD

# every kernel's launch counter, by kernel name
COUNTERS = {c.name: c for c in (FLASH_FWD, FFN_FWD)}
