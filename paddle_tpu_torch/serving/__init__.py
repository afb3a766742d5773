"""paddle_tpu_torch.serving — continuous-batching inference engine
(counterpart of paddle_tpu.serving, default-model path).

    from paddle_tpu_torch import serving

    engine = serving.Engine(fn, serving.EngineConfig(max_batch_size=32))
    resp = engine.submit([ids, types, mask])    # bounded admission
    encoded, pooled = resp.result(timeout=5.0)  # numpy, at the boundary

Pipeline: submit() -> DynamicBatcher (coalesce by signature, bounded
queue, EngineOverloaded at the bound) -> dispatch loop (warm buckets
only; new buckets park with the off-path warm-up thread) -> completer
(the ONE device->host boundary, after the batch's CUDA event).
"""

from .admission import (AdmissionController, EngineClosed,
                        EngineOverloaded, RequestCancelled)
from .batcher import DynamicBatcher, Request, Response
from .bucketing import (BucketedRunner, bucket_for, bucket_ladder,
                        input_signature, pad_batch)
from .engine import Engine, EngineConfig
from .metrics import latency_stats, mean_occupancy, reset_latency

__all__ = [
    "AdmissionController",
    "BucketedRunner",
    "DynamicBatcher",
    "Engine",
    "EngineClosed",
    "EngineConfig",
    "EngineOverloaded",
    "Request",
    "RequestCancelled",
    "Response",
    "bucket_for",
    "bucket_ladder",
    "input_signature",
    "latency_stats",
    "mean_occupancy",
    "pad_batch",
    "reset_latency",
]
