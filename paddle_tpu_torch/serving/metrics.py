"""Serving observability: profiler-exported stats + latency percentiles
(copy of paddle_tpu/serving/metrics.py).

Int stats (profiler.get_int_stats):

| stat                          | meaning                                 |
|-------------------------------|-----------------------------------------|
| serving_requests_total        | requests admitted                       |
| serving_rejected_total        | requests refused with EngineOverloaded  |
| serving_cancelled_total       | requests cancelled before completion    |
| serving_completed_total       | requests answered                       |
| serving_batches_total         | batches dispatched                      |
| serving_batch_rows_total      | summed request rows over all batches    |
| serving_batch_requests_total  | summed request count over all batches   |
| serving_batch_occupancy_max   | largest per-batch request count seen    |
| serving_queue_depth           | gauge: requests currently queued        |
| serving_in_flight             | gauge: batches dispatched, not complete |
| serving_trace_count           | bucket warm-ups (first run of a shape)  |
| serving_pad_rows_total        | padding rows added by bucketing         |

AutoregressiveEngine adds:

| stat                          | meaning                                 |
|-------------------------------|-----------------------------------------|
| serving_decode_steps          | decode steps run                        |
| serving_prefill_count         | prompts whose prefill finished          |
| serving_prefill_chunks        | chunk steps of chunked prefills         |
| serving_kv_pages_in_use       | gauge: KV pages handed out              |
| serving_kv_pages_capacity     | gauge: KV pages in the pool             |
| serving_kv_bytes              | gauge: device bytes of handed-out pages |
| serving_kv_pages_extended     | pages added by lazy growth              |
| serving_kv_backpressure_total | extends refused for want of pages       |
| serving_kv_paused_total       | slots paused under pool pressure        |
| serving_kv_preempt_total      | slots preempted by the all-paused escape|

Per-tenant series (serving/registry.py): every registered model `<t>`
gets its own family, named by `tenant_stat(t, suffix)`
(`serving_tenant_<t>_<suffix>`):

| stat                                | meaning                              |
|-------------------------------------|--------------------------------------|
| serving_tenant_<t>_requests_total   | requests admitted for tenant t       |
| serving_tenant_<t>_rejected_total   | tenant-quota rejections for t        |
| serving_tenant_<t>_completed_total  | requests answered for tenant t       |
| serving_tenant_<t>_queued           | gauge: t's requests currently queued |
| serving_tenant_<t>_cache_evictions  | t's bucket-cache evictions           |

Per-tenant timers: `serving_tenant_<t>_request_ms` (summed submit ->
response latency; the same name feeds a latency reservoir for the
tenant's p50/p99 via `latency_stats`).

Time stats (profiler.get_time_stats, milliseconds):

| timer                | meaning                                        |
|----------------------|------------------------------------------------|
| serving_queue_ms     | summed request wait, submit -> dispatch        |
| serving_dispatch_ms  | host time to enqueue a batch (or a prefill,    |
|                      | chunk or decode step) on the device            |
| serving_compile_ms   | off-path bucket warm-ups (request parked); the |
|                      | first call of each decode-engine entry         |
| serving_response_ms  | device wait + device->host copy at the         |
|                      | response boundary                              |

Latency percentiles are host-side only: a bounded reservoir per metric
name (`serving_request_ms`, submit -> response; `serving_ttft_ms`, submit
-> first token; `serving_prefill_chunk_ms`, host time of one prefill or
chunk step), drained by `latency_stats()`.
"""

from __future__ import annotations

import re
import threading
from collections import deque
from typing import Dict, Optional

from ..profiler import stat_add, stat_set

_CAP = 8192
_LAT: Dict[str, deque] = {}
_LAT_LOCK = threading.Lock()


_TENANT_SAFE = re.compile(r"[^0-9A-Za-z_]")


def tenant_stat(tenant: str, suffix: str) -> str:
    """Stat name of one tenant's series: `serving_tenant_<t>_<suffix>`,
    the tenant's name cut to the identifier alphabet."""
    return f"serving_tenant_{_TENANT_SAFE.sub('_', str(tenant))}_{suffix}"


def record_latency(name: str, ms: float) -> None:
    """Append one request latency (milliseconds) to the bounded
    per-name reservoir."""
    with _LAT_LOCK:
        q = _LAT.get(name)
        if q is None:
            q = _LAT[name] = deque(maxlen=_CAP)
        q.append(float(ms))


def latency_stats(name: str = "serving_request_ms") -> Optional[dict]:
    """{count, mean_ms, p50_ms, p99_ms, max_ms} for `name`, or None if
    nothing was recorded."""
    with _LAT_LOCK:
        q = _LAT.get(name)
        vals = list(q) if q else None
    if not vals:
        return None
    vals.sort()

    def pct(p):
        i = min(len(vals) - 1, int(round(p / 100.0 * (len(vals) - 1))))
        return vals[i]

    return {
        "count": len(vals),
        "mean_ms": sum(vals) / len(vals),
        "p50_ms": pct(50.0),
        "p99_ms": pct(99.0),
        "max_ms": vals[-1],
    }


def reset_latency(name: str = None) -> None:
    with _LAT_LOCK:
        if name is None:
            _LAT.clear()
        else:
            _LAT.pop(name, None)


_OCC_LOCK = threading.Lock()
_OCC_MAX = [0]


def observe_batch(n_requests: int, rows: int, pad_rows: int) -> None:
    """Record one dispatched batch: occupancy counters + padding waste."""
    stat_add("serving_batches_total")
    stat_add("serving_batch_rows_total", rows)
    stat_add("serving_batch_requests_total", n_requests)
    if pad_rows:
        stat_add("serving_pad_rows_total", pad_rows)
    with _OCC_LOCK:
        if n_requests > _OCC_MAX[0]:
            _OCC_MAX[0] = n_requests
            stat_set("serving_batch_occupancy_max", n_requests)


def mean_occupancy(stats: dict) -> float:
    """Requests per batch, from a get_int_stats() snapshot."""
    batches = stats.get("serving_batches_total", 0)
    if not batches:
        return 0.0
    return stats.get("serving_batch_requests_total", 0) / batches
