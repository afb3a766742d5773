"""Multi-tenant model fleet: N named models, one device, one Engine
(counterpart of paddle_tpu/serving/registry.py).

`ModelRegistry` owns one continuous-batching `Engine` and serves any
number of named models through its one dispatch pipeline:

  * admission is per tenant first, global second: a tenant at its
    `quota` gets `EngineOverloaded` at once and never takes a slot of
    the shared queue;
  * scheduling is priority + aging: the batcher picks the queued request
    with the highest `priority + waited_ms / aging_ms`, so a
    low-priority tenant under a high-priority flood still wins once it
    has waited long enough;
  * batches never mix tenants (the batcher groups by (tenant,
    signature));
  * register / unregister / hot swap are live: batches already
    dispatched finish on the model they resolved, everything after sees
    the new one, and no other tenant drains or pauses;
  * a callable or Predictor tenant gets its own bounded bucket cache
    (`_TenantCache`), so one tenant's churn evicts only its own entries;
  * every tenant has its own `serving_tenant_<t>_*` series
    (serving/metrics.py).

Left out against the reference, each in ROADMAP queue 3: the tenant
caches count entries, where the reference charges each executable's
bytes to its memory ledger (which waits for queue 1 item 13's memprof);
`aot_token` is accepted and ignored (the persistent AOT cache is queue 1
item 11's).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

from ..fluid.compile_cache import CompileCache
from .engine import Engine, EngineConfig, _as_model, _RunnerModel

__all__ = ["ModelRegistry", "active_tenants"]

# the live registries, for `active_tenants`
_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Dict[int, "ModelRegistry"] = {}


def active_tenants() -> List[str]:
    """Sorted union of tenant names across live registries."""
    with _ACTIVE_LOCK:
        regs = list(_ACTIVE.values())
    names: set = set()
    for reg in regs:
        names.update(reg.model_names())
    return sorted(names)


class _TenantCache(CompileCache):
    """One tenant's bounded cache of warmed bucket entries.  An eviction
    (LRU overflow, or `drain` at unregister) counts in the tenant's
    `serving_tenant_<t>_cache_evictions`; the cache holds one tenant's
    entries only, so no tenant evicts another's.  It counts entries, not
    bytes (the reference's byte charge to its memory ledger waits for
    ROADMAP queue 1 item 13)."""

    def __init__(self, capacity: int, tenant: str):
        super().__init__(capacity, stat_prefix="serving",
                         on_evict=self._evicted)
        self._tenant = tenant

    def _evicted(self, key, value) -> None:
        from ..profiler import stat_add
        from . import metrics

        stat_add(metrics.tenant_stat(self._tenant, "cache_evictions"))

    def drain(self) -> None:
        """Release every entry (the tenant was unregistered or
        replaced)."""
        for key, value in self.items():
            self._evicted(key, value)
        self.clear()


class _Tenant:
    __slots__ = ("name", "model", "cache", "quota", "priority")

    def __init__(self, name, model, cache, quota, priority):
        self.name = name
        self.model = model
        self.cache = cache
        self.quota = quota
        self.priority = priority


class ModelRegistry:
    """N named models sharing one device through one Engine.

    >>> reg = ModelRegistry(EngineConfig(max_batch_size=32))
    >>> reg.register("ranker", fn_a, quota=8, priority=1.0)
    >>> reg.register("embedder", predictor, quota=32)
    >>> out = reg.infer("ranker", [x])
    >>> reg.register("ranker", fn_a_v2, quota=8)   # live hot swap
    >>> reg.unregister("embedder")

    Pass an existing `engine` to share it with a default (anonymous)
    model; otherwise the registry owns a model-less Engine and shuts it
    down in close().
    """

    def __init__(self, config: Optional[EngineConfig] = None,
                 engine: Optional[Engine] = None):
        self._engine = engine if engine is not None \
            else Engine(model=None, config=config)
        self._owns_engine = engine is None
        self._lock = threading.RLock()
        self._tenants: Dict[str, _Tenant] = {}
        self._closed = False
        with _ACTIVE_LOCK:
            _ACTIVE[id(self)] = self

    @property
    def engine(self) -> Engine:
        return self._engine

    # -- fleet membership --------------------------------------------------
    def register(self, name: str, model, quota: Optional[int] = None,
                 priority: float = 0.0,
                 cache_capacity: Optional[int] = None,
                 aot_token: Optional[str] = None):
        """Register (or hot-swap) a named model, live.

        quota           max queued requests of this tenant
                        (EngineOverloaded beyond it; None = up to the
                        engine's global queue bound)
        priority        base scheduling priority (aged by wait time)
        cache_capacity  this tenant's bucket-entry budget (callables and
                        Predictors; LRU beyond it)
        aot_token       accepted and ignored (no persistent AOT cache)
        """
        name = str(name)
        wrapped = _as_model(model, self._engine.config)
        cache = None
        if isinstance(wrapped, _RunnerModel):
            cap = int(cache_capacity) if cache_capacity else \
                wrapped.runner._cache.capacity
            cache = _TenantCache(cap, name)
            # a re-registered wrapped model keeps its warm entries
            for k, v in wrapped.runner._cache.items():
                cache.put(k, v)
            wrapped.runner._cache = cache
        with self._lock:
            if self._closed:
                raise RuntimeError("registry is closed")
            old = self._tenants.get(name)
            self._tenants[name] = _Tenant(name, wrapped, cache, quota,
                                          float(priority))
            self._engine.add_model(name, wrapped, quota=quota,
                                   priority=float(priority))
            self._gauge_models()
        if old is not None and old.cache is not None \
                and old.cache is not cache:
            old.cache.drain()
        return wrapped

    def unregister(self, name: str, cancel_queued: bool = True):
        """Remove a tenant: its queued requests are cancelled, its cache
        released; every other tenant keeps serving."""
        name = str(name)
        with self._lock:
            tenant = self._tenants.pop(name, None)
            self._engine.remove_model(name, cancel_queued=cancel_queued)
            self._gauge_models()
        if tenant is not None and tenant.cache is not None:
            tenant.cache.drain()
        return tenant.model if tenant is not None else None

    def model_names(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def __contains__(self, name) -> bool:
        with self._lock:
            return str(name) in self._tenants

    def __len__(self) -> int:
        with self._lock:
            return len(self._tenants)

    def _gauge_models(self) -> None:
        from ..profiler import stat_set

        stat_set("serving_fleet_models", len(self._tenants))

    # -- request surface ---------------------------------------------------
    def submit(self, name: str, inputs: Sequence[Any],
               priority: float = 0.0):
        """Queue one request for tenant `name` (see Engine.submit)."""
        return self._engine.submit(inputs, model=str(name),
                                   priority=priority)

    def infer(self, name: str, inputs: Sequence[Any],
              timeout: Optional[float] = None):
        return self._engine.infer(inputs, timeout=timeout,
                                  model=str(name))

    def reload_weights(self, name: str, path: str) -> int:
        """Swap one tenant's parameters from a checkpoint (ProgramModel
        tenants; see ProgramModel.reload_weights)."""
        with self._lock:
            tenant = self._tenants.get(str(name))
        if tenant is None:
            raise KeyError(f"model {name!r} is not registered")
        swap = getattr(tenant.model, "reload_weights", None)
        if swap is None:
            raise TypeError(
                f"model {name!r} bakes its weights into the traced "
                "computation; re-register it instead")
        return swap(path)

    # -- introspection -----------------------------------------------------
    def stats(self, name: str) -> dict:
        """One tenant's series, from the profiler's tables."""
        from ..profiler import get_int_stats, get_time_stats
        from . import metrics

        name = str(name)
        ints = get_int_stats()
        times = get_time_stats()
        out = {}
        for suffix in ("requests_total", "rejected_total",
                       "completed_total", "queued", "cache_evictions"):
            out[suffix] = ints.get(metrics.tenant_stat(name, suffix), 0)
        out["request_ms"] = times.get(
            metrics.tenant_stat(name, "request_ms"), 0.0)
        lat = metrics.latency_stats(metrics.tenant_stat(name,
                                                        "request_ms"))
        if lat is not None:
            out["latency"] = lat
        with self._lock:
            tenant = self._tenants.get(name)
        if tenant is not None and tenant.cache is not None:
            out["cache_entries"] = len(tenant.cache)
        return out

    def close(self, drain: bool = True) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            tenants = list(self._tenants.values())
            self._tenants.clear()
            self._gauge_models()
        with _ACTIVE_LOCK:
            _ACTIVE.pop(id(self), None)
        if self._owns_engine:
            self._engine.shutdown(drain=drain)
        else:
            for t in tenants:
                self._engine.remove_model(t.name, cancel_queued=not drain)
        for t in tenants:
            if t.cache is not None:
                t.cache.drain()

    def __enter__(self) -> "ModelRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)
