"""paddle_tpu_torch.serving — continuous-batching inference engine
(counterpart of paddle_tpu.serving).

    from paddle_tpu_torch import serving

    engine = serving.Engine(fn, serving.EngineConfig(max_batch_size=32))
    resp = engine.submit([ids, types, mask])    # bounded admission
    encoded, pooled = resp.result(timeout=5.0)  # numpy, at the boundary

Pipeline: submit() -> DynamicBatcher (coalesce by signature, bounded
queue, EngineOverloaded at the bound) -> dispatch loop (warm buckets
only; new buckets park with the off-path warm-up thread) -> completer
(the ONE device->host boundary, after the batch's CUDA event).

Several models on one card (per-tenant quota and priority, live
register / unregister / weight reload):

    reg = serving.ModelRegistry(serving.EngineConfig(max_batch_size=32))
    reg.register("bert", predictor, quota=16, priority=1.0)
    reg.register("ctr", serving.ProgramModel(exe, prog, feeds, fetches,
                                             scope=scope), quota=64)
    out = reg.infer("ctr", batch)
    reg.reload_weights("ctr", "ckpt_root")   # newest checkpoint, live

Token generation over paged KV state:

    eng = serving.AutoregressiveEngine(model=serving.LayeredDecoder(
        embed, [(qkv, merge), ...], unembed), num_heads=12, head_dim=64)
    tokens = eng.generate(prompt, max_new_tokens=32)   # numpy int32
"""

from .admission import (AdmissionController, EngineClosed,
                        EngineOverloaded, RequestCancelled)
from .batcher import DynamicBatcher, Request, Response
from .bucketing import (BucketedRunner, bucket_for, bucket_ladder,
                        input_signature, pad_batch)
from .engine import (AutoregressiveEngine, Engine, EngineConfig,
                     LayeredDecoder, ProgramModel)
from .kv_cache import PagedKVCache, PageTable
from .metrics import (latency_stats, mean_occupancy, reset_latency,
                      tenant_stat)
from .registry import ModelRegistry, active_tenants

__all__ = [
    "AdmissionController",
    "AutoregressiveEngine",
    "BucketedRunner",
    "DynamicBatcher",
    "Engine",
    "EngineClosed",
    "EngineConfig",
    "EngineOverloaded",
    "LayeredDecoder",
    "ModelRegistry",
    "PageTable",
    "PagedKVCache",
    "ProgramModel",
    "Request",
    "RequestCancelled",
    "Response",
    "active_tenants",
    "bucket_for",
    "bucket_ladder",
    "input_signature",
    "latency_stats",
    "mean_occupancy",
    "pad_batch",
    "reset_latency",
    "tenant_stat",
]
