"""Request queue + dynamic batcher: coalesce requests into one dispatch
(copy of paddle_tpu/serving/batcher.py).

`submit()` is the bounded admission point; `next_batch()` is the
dispatch loop's pull.  Requests that share a tenant and an input
signature (trailing dims + dtype) coalesce along the batch dim up to
`max_batch_size` rows, waiting at most `max_queue_delay_ms` after the
first request arrives.  A zero delay means drain-what's-there: whatever
is queued RIGHT NOW forms the batch and nothing waits.  Per-tenant
admission (serving/registry.py): a tenant at its quota is refused with
`EngineOverloaded` before it takes a shared queue slot, and the head of
a batch is the queued request of the highest aged priority.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, Optional, Sequence

import numpy as np

from .admission import (AdmissionController, EngineClosed,
                        EngineOverloaded, RequestCancelled)
from .bucketing import input_signature


class Response:
    """Future-like handle for one submitted request."""

    def __init__(self, request: "Request"):
        self._request = request

    def done(self) -> bool:
        return self._request._event.is_set()

    def cancel(self) -> bool:
        """Best-effort cancel; True if the request will NOT produce a
        result (it may already be batched on device — the engine then
        discards its slice at the response boundary)."""
        return self._request.cancel()

    def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        req = self._request
        if not req._event.wait(timeout):
            raise TimeoutError(
                f"request {req.id}: no result within {timeout}s")
        if req._exc is not None:
            raise req._exc
        return req._result


class Request:
    """One inference request: `inputs` share a leading batch dim
    (`rows`); completion is delivered through the paired Response."""

    _ids = iter(range(1, 1 << 62))
    _ids_lock = threading.Lock()

    def __init__(self, inputs: Sequence[Any], tenant: Optional[str] = None,
                 priority: float = 0.0):
        from ..obs import TRACER

        with Request._ids_lock:
            self.id = next(Request._ids)
        self.inputs = list(inputs)
        self.rows = int(self.inputs[0].shape[0]) if self.inputs[0].shape \
            else 1
        self.sig = input_signature(self.inputs)
        # multi-tenant fleet (serving/registry.py): the model name this
        # request routes to (None = the engine's default model) and its
        # base scheduling priority — higher wins; waiting time ages the
        # effective priority up so low-priority tenants never starve
        self.tenant = tenant
        self.priority = float(priority)
        # flow id linking this request's spans (admit -> coalesce ->
        # dispatch -> complete) across the engine's threads
        self.flow = TRACER.new_flow() if TRACER.enabled else 0
        self.submitted_at = time.perf_counter()
        self._event = threading.Event()
        self._result: Optional[List[np.ndarray]] = None
        self._exc: Optional[BaseException] = None
        self._cancelled = False
        self._lock = threading.Lock()

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> bool:
        from ..profiler import stat_add

        with self._lock:
            if self._event.is_set():
                return False
            self._cancelled = True
            self._exc = RequestCancelled(
                f"request {self.id} cancelled")
            self._event.set()
            stat_add("serving_cancelled_total")
            return True

    def set_result(self, result: List[np.ndarray]) -> None:
        with self._lock:
            if self._cancelled or self._event.is_set():
                return  # cancelled mid-batch: discard the slice
            self._result = result
            self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._exc = exc
            self._event.set()


class DynamicBatcher:
    """Bounded request queue + signature-grouped coalescing.

    The queue bound counts REQUESTS (not rows): admission rejects with
    `EngineOverloaded` at `max_queue`.  `next_batch` is the only
    consumer."""

    def __init__(self, max_batch_size: int = 8,
                 max_queue_delay_ms: float = 2.0, max_queue: int = 64,
                 aging_ms: float = 100.0):
        self.max_batch_size = int(max_batch_size)
        self.max_queue_delay_ms = float(max_queue_delay_ms)
        # priority aging rate (multi-tenant fleet, serving/registry.py):
        # every aging_ms a queued request waits adds +1 to its effective
        # priority, so a starved low-priority tenant eventually outbids
        # any fixed high-priority tenant — aging-based starvation
        # freedom, not strict priority
        self.aging_ms = float(aging_ms)
        self._admission = AdmissionController(
            max_queue, resource="queue", gauge_stat="serving_queue_depth")
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        # per-tenant admission state (name -> {quota, priority, depth}):
        # an over-quota tenant is rejected at submit() while its queued
        # requests are still bounded by the quota — it can never
        # queue-squat the shared bound
        self._tenants: dict = {}
        # batches popped by next_batch but not yet registered by the
        # consumer (engine in-flight deque / compile queue): counted so
        # shutdown(drain=True) cannot observe a falsely idle engine in
        # the pop -> register window
        self._handed = 0

    @property
    def depth(self) -> int:
        return self._admission.depth

    # -- multi-tenant admission (serving/registry.py) ----------------------
    def set_tenant(self, name: str, quota: Optional[int] = None,
                   priority: float = 0.0) -> None:
        """Register/update one tenant's admission quota (None =
        unbounded within the shared queue bound) and base priority."""
        with self._cond:
            ent = self._tenants.setdefault(str(name), {"depth": 0})
            ent["quota"] = None if quota is None else int(quota)
            ent["priority"] = float(priority)

    def clear_tenant(self, name: str) -> None:
        with self._cond:
            self._tenants.pop(str(name), None)

    def tenant_depth(self, name: str) -> int:
        with self._cond:
            ent = self._tenants.get(str(name))
            return int(ent["depth"]) if ent else 0

    def cancel_tenant(self, name: str) -> int:
        """Cancel every queued request of one tenant (unregister path)
        without touching any other tenant's queue position."""
        with self._cond:
            mine = [r for r in self._q if r.tenant == name]
            for r in mine:
                self._q.remove(r)
        n = 0
        for req in mine:
            self._release(req)
            n += req.cancel()
        return n

    def _release(self, req: "Request") -> None:
        """One dequeue's accounting: the shared bound AND the request's
        tenant depth (+ its queue-depth gauge)."""
        self._admission.release()
        if req.tenant is None:
            return
        from . import metrics
        from ..profiler import stat_set

        with self._cond:
            ent = self._tenants.get(req.tenant)
            if ent is None:
                return
            ent["depth"] = max(0, ent["depth"] - 1)
            depth = ent["depth"]
        stat_set(metrics.tenant_stat(req.tenant, "queued"), depth)

    @property
    def handed(self) -> int:
        with self._cond:
            return self._handed

    def hand_done(self) -> None:
        """Consumer callback: the last popped batch is now registered
        (in flight, parked with the compiler, or discarded)."""
        with self._cond:
            self._handed = max(0, self._handed - 1)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def drain_cancel(self) -> int:
        """Cancel everything still queued (shutdown(drain=False))."""
        with self._cond:
            pending = list(self._q)
            self._q.clear()
        n = 0
        for req in pending:
            self._release(req)
            n += req.cancel()
        return n

    def submit(self, req: Request) -> Response:
        from . import metrics
        from ..obs import span as obs_span
        from ..profiler import stat_add, stat_set

        with obs_span("serving.admit", flow=req.flow):
            with self._cond:
                if self._closed:
                    raise EngineClosed("engine is shut down")
                if req.rows > self.max_batch_size:
                    # oversize requests are legal (the bucketed runner
                    # chunks them) but they occupy a whole batch
                    pass
                ent = self._tenants.get(req.tenant) \
                    if req.tenant is not None else None
                if ent is not None:
                    # per-tenant quota BEFORE the shared bound: an
                    # over-quota tenant is rejected here and never
                    # occupies shared queue slots (no queue-squatting)
                    quota = ent.get("quota")
                    if quota is not None and ent["depth"] >= quota:
                        stat_add("serving_rejected_total")
                        stat_add(metrics.tenant_stat(
                            req.tenant, "rejected_total"))
                        raise EngineOverloaded(
                            f"tenant:{req.tenant}", ent["depth"], quota,
                            detail="per-tenant admission quota")
                    if req.priority == 0.0:
                        req.priority = ent.get("priority", 0.0)
                self._admission.admit()  # raises EngineOverloaded at bound
                if ent is not None:
                    ent["depth"] += 1
                    stat_add(metrics.tenant_stat(req.tenant,
                                                 "requests_total"))
                    stat_set(metrics.tenant_stat(req.tenant, "queued"),
                             ent["depth"])
                self._q.append(req)
                stat_add("serving_requests_total")
                self._cond.notify()
        return Response(req)

    def _group_key(self, req: Request):
        """Batches never mix tenants (different models) or signatures."""
        return (req.tenant, req.sig)

    def _pop_matching(self, key, budget: int) -> Optional[Request]:
        """Dequeue the first live request with group key `key` that
        fits in the remaining row budget (None key = anything)."""
        for i, req in enumerate(self._q):
            if req.cancelled:
                continue
            if key is not None and self._group_key(req) != key:
                continue
            if req.rows > budget:
                continue
            del self._q[i]
            return req
        return None

    def _effective_priority(self, req: Request, now: float) -> float:
        """Base priority + waiting-time aging: +1 per aging_ms queued,
        so a starved low-priority request eventually outbids any fixed
        high-priority newcomer."""
        age = (now - req.submitted_at) * 1e3
        return req.priority + age / max(1e-9, self.aging_ms)

    def _pop_best(self, budget: int) -> Optional[Request]:
        """Dequeue the live request with the highest effective
        (aged) priority; FIFO between equals."""
        now = time.perf_counter()
        best_i, best_score = -1, None
        for i, req in enumerate(self._q):
            if req.cancelled or req.rows > budget:
                continue
            score = self._effective_priority(req, now)
            if best_score is None or score > best_score:
                best_i, best_score = i, score
        if best_i < 0:
            return None
        req = self._q[best_i]
        del self._q[best_i]
        return req

    def _sweep_cancelled(self) -> None:
        while self._q and self._q[0].cancelled:
            req = self._q.popleft()
            self._release(req)

    def next_batch(self, timeout: Optional[float] = None) \
            -> Optional[List[Request]]:
        """Coalesce the next batch.

        Blocks up to `timeout` seconds for the FIRST request, then up
        to `max_queue_delay_ms` more (0 = zero-timeout drain: take what
        is queued and go) while the batch has row budget.  Returns None
        on timeout or close-with-empty-queue."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._cond:
            while True:
                self._sweep_cancelled()
                # effective-priority (aged) selection: the head of the
                # batch is the best-scoring live request, not FIFO —
                # coalescing below still only joins its tenant+sig group
                first = self._pop_best(self.max_batch_size)
                if first is None and self._q:
                    # only oversize requests queued: serve one alone
                    # (the runner chunks it through the top bucket)
                    first = self._pop_best(1 << 60)
                if first is not None:
                    break
                if self._closed:
                    return None
                wait = None if deadline is None \
                    else deadline - time.perf_counter()
                if wait is not None and wait <= 0:
                    return None
                self._cond.wait(wait)
            batch = [first]
            # handed BEFORE the admission release: at every instant the
            # request is visible in depth, handed, or the consumer's
            # own accounting — never in none of them
            self._handed += 1
            self._release(first)
            rows = first.rows
            coalesce_until = time.perf_counter() \
                + self.max_queue_delay_ms / 1e3
            while rows < self.max_batch_size:
                req = self._pop_matching(self._group_key(first),
                                         self.max_batch_size - rows)
                if req is not None:
                    self._release(req)
                    batch.append(req)
                    rows += req.rows
                    continue
                remaining = coalesce_until - time.perf_counter()
                if remaining <= 0 or self._closed:
                    break  # zero-delay drain exits here immediately
                self._cond.wait(remaining)
        from ..profiler import time_add

        now = time.perf_counter()
        for req in batch:
            time_add("serving_queue_ms",
                     (now - req.submitted_at) * 1e3)
        return batch
