"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package `paddle_tpu` stays beside this one as the reference each
part of the port is held against (tests/test_torch_*.py).  This package
imports torch and numpy only: never jax, never paddle_tpu.

First slice: BERT-base served through `serving.Engine`, with the two
Pallas kernels on that path (flash-attention forward, fused FFN
forward) rewritten by hand in CUDA C++ under `csrc/`.

    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import bert

    model = bert.BertModel(bert.BertConfig.base(), dtype=torch.bfloat16)
    engine = serving.Engine(fn, serving.EngineConfig(max_batch_size=32))

Entry points run on `cuda` unless the caller passes `device="cpu"`; with
no GPU and no device given they raise.
"""

from .device import get_device, set_device  # noqa: F401

__all__ = ["get_device", "set_device"]
