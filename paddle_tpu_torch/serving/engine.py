"""The serving Engine: request queue -> dynamic batcher -> dispatch loop
(counterpart of paddle_tpu/serving/engine.py, default-model path).

    submit()            bounded admission (EngineOverloaded at the bound)
      -> DynamicBatcher coalesce by signature, max_queue_delay_ms
      -> _dispatch_loop pull batch; warmed bucket? dispatch : park
      -> _compiler_loop off-path warm-up of new buckets (request parked,
                        the dispatch loop keeps serving warm buckets)
      -> _dispatch_batch pad to bucket, launch on the device, record a
                        CUDA event; <= max_in_flight batches in flight
      -> _completer_loop the ONE device->host boundary: wait on the
                        batch's event, copy to host, slice per request,
                        fulfill futures

The dispatch loop never waits on the device and never warms a bucket.
The model is any callable `fn(*tensors) -> tensor(s)` run on the engine's
device (cuda unless EngineConfig(device="cpu")).  Outputs come back as
numpy arrays; bf16 outputs are widened to float32 on the host, since
numpy has no bfloat16.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from . import metrics
from .admission import EngineClosed
from .batcher import DynamicBatcher, Request, Response
from .bucketing import BucketedRunner, bucket_ladder

_SENTINEL = object()


class EngineConfig:
    """Knobs for the continuous-batching engine.

    max_batch_size     rows coalesced into one dispatch
    max_queue_delay_ms wait for co-batchable requests after the first
                       (0 = zero-timeout drain: take what's queued)
    max_queue          bounded admission (EngineOverloaded beyond it)
    max_in_flight      batches dispatched but not yet completed; >= 2
                       keeps the device fed while the host copies and
                       slices responses
    buckets            batch-shape ladder; default: power-of-2 ladder
                       over [min_bucket, max_batch_size]
    device             where the model runs (default cuda; raises
                       without CUDA unless "cpu" is named)
    """

    def __init__(self, max_batch_size: int = 8,
                 max_queue_delay_ms: float = 2.0, max_queue: int = 64,
                 max_in_flight: int = 2,
                 buckets: Optional[Sequence[int]] = None,
                 min_bucket: int = 8, device=None):
        self.max_batch_size = int(max_batch_size)
        self.max_queue_delay_ms = float(max_queue_delay_ms)
        self.max_queue = int(max_queue)
        self.max_in_flight = max(1, int(max_in_flight))
        self.buckets = list(buckets) if buckets else bucket_ladder(
            self.max_batch_size, min_bucket=min_bucket)
        self.device = device


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class Engine:
    """Continuous-batching inference engine over one loaded model."""

    def __init__(self, model, config: Optional[EngineConfig] = None,
                 start: bool = True):
        self.config = config or EngineConfig()
        if not callable(model):
            raise TypeError(f"Engine model must be a callable; got "
                            f"{type(model).__name__}")
        # the engine drives the bucketed runner directly: plan /
        # is_compiled / ensure_compiled / run
        self.model = BucketedRunner(model, self.config.buckets,
                                    device=self.config.device)
        self._batcher = DynamicBatcher(
            max_batch_size=self.config.max_batch_size,
            max_queue_delay_ms=self.config.max_queue_delay_ms,
            max_queue=self.config.max_queue)
        self._inflight: deque = deque()
        self._inflight_cond = threading.Condition()
        self._compile_q: _queue.Queue = _queue.Queue()
        self._compiling = 0
        self._stop = threading.Event()
        self._closed = False
        self._threads: List[threading.Thread] = []
        self._started = False
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Engine":
        if self._started:
            return self
        self._started = True
        for name, target in (("serving-dispatch", self._dispatch_loop),
                             ("serving-compile", self._compiler_loop),
                             ("serving-complete", self._completer_loop)):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = 30.0) -> None:
        """Stop accepting work; `drain=True` completes everything
        already admitted (queued AND in flight) before stopping,
        `drain=False` cancels what is still queued."""
        self._closed = True
        self._batcher.close()
        if not drain:
            self._batcher.drain_cancel()
        if self._started:
            deadline = None if timeout is None \
                else time.perf_counter() + timeout
            while (self._batcher.depth or self._batcher.handed
                   or self._compiling or len(self._inflight)):
                if deadline is not None \
                        and time.perf_counter() > deadline:
                    break
                time.sleep(0.002)
        self._stop.set()
        self._compile_q.put(_SENTINEL)
        with self._inflight_cond:
            self._inflight_cond.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        # anything still unanswered (no-drain shutdown, stuck device)
        # must not hang its caller forever
        for item in list(self._inflight):
            for req in item[0]:
                req.set_exception(EngineClosed("engine shut down with "
                                               "request in flight"))

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    # -- client surface ----------------------------------------------------
    def submit(self, inputs: Sequence[Any], priority: float = 0.0) \
            -> Response:
        """Queue one request (inputs share a leading batch dim).  Raises
        EngineOverloaded at the queue bound, EngineClosed after
        shutdown."""
        if self._closed:
            raise EngineClosed("engine is shut down")
        arrays = []
        for a in inputs:
            a = a if isinstance(a, np.ndarray) else np.asarray(a)
            if a.ndim == 0:
                raise ValueError(
                    "engine inputs need a leading batch dim (got a "
                    "scalar); wrap single examples as shape (1, ...)")
            arrays.append(a)
        return self._batcher.submit(Request(arrays, priority=priority))

    def infer(self, inputs: Sequence[Any],
              timeout: Optional[float] = None) -> List[np.ndarray]:
        """Synchronous convenience: submit + wait."""
        return self.submit(inputs).result(timeout)

    # -- pipeline threads --------------------------------------------------
    def _dispatch_loop(self):
        """Hot path: pull coalesced batches and dispatch the warmed ones;
        park batches whose bucket is new with the compiler thread.
        Never warms up, never waits on the device, never transfers to
        the host."""
        from .. import obs

        while not self._stop.is_set():
            t0 = time.perf_counter()
            batch = self._batcher.next_batch(timeout=0.05)
            if batch is None:
                continue
            try:
                batch = [r for r in batch if not r.cancelled]
                if not batch:
                    continue
                # retroactive span: the coalesce wait only turns out to
                # be one once a batch actually formed
                obs.add_span("serving.coalesce", t0,
                             time.perf_counter() - t0,
                             flow=[r.flow for r in batch])
                inputs = self._concat(batch)
                if self.model.is_compiled(inputs):
                    self._dispatch_batch(batch, inputs)
                else:
                    with self._inflight_cond:
                        self._compiling += 1
                    self._compile_q.put((batch, inputs))
            except Exception as e:  # noqa: BLE001 - fail the batch, keep serving
                for req in batch:
                    req.set_exception(e)
            finally:
                # registered (in flight / parked / discarded): the
                # shutdown drain check may stop counting it as handed
                self._batcher.hand_done()

    def _compiler_loop(self):
        """Off-path warm-up: run the new bucket once with the batch
        parked, then dispatch it.  The dispatch loop keeps serving warm
        buckets meanwhile."""
        from .. import obs

        while True:
            item = self._compile_q.get()
            if item is _SENTINEL:
                return
            batch, inputs = item
            try:
                with obs.span("serving.compile",
                              flow=[r.flow for r in batch]):
                    self.model.ensure_compiled(inputs)
                self._dispatch_batch(batch, inputs)
            except Exception as e:  # noqa: BLE001 - fail the batch, keep serving
                for req in batch:
                    req.set_exception(e)
            finally:
                with self._inflight_cond:
                    self._compiling -= 1
                    self._inflight_cond.notify_all()

    def _concat(self, batch: List[Request]) -> List[np.ndarray]:
        if len(batch) == 1:
            return batch[0].inputs
        return [np.concatenate([r.inputs[i] for r in batch], axis=0)
                for i in range(len(batch[0].inputs))]

    def _dispatch_batch(self, batch: List[Request], inputs) -> None:
        """Launch one batch on the device without waiting for it, and
        record a CUDA event after it on this thread's stream; bounded
        dispatch-ahead: at most max_in_flight batches between here and
        the completer."""
        from .. import obs
        from ..profiler import stat_set, timed

        with self._inflight_cond:
            while (len(self._inflight) >= self.config.max_in_flight
                   and not self._stop.is_set()):
                self._inflight_cond.wait(0.05)
            if self._stop.is_set() and self._closed:
                for req in batch:
                    req.set_exception(
                        EngineClosed("engine stopped before dispatch"))
                return
        rows = inputs[0].shape[0]
        bucket, _sig = self.model.plan(inputs)
        with obs.span("serving.dispatch",
                      flow=[r.flow for r in batch]), \
                timed("serving_dispatch_ms"):
            outs = self.model.run(inputs)  # async: device tensors out
            done = None
            if self.model.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.model.device))
        metrics.observe_batch(len(batch), rows, max(0, bucket - rows))
        with self._inflight_cond:
            self._inflight.append((batch, outs, done))
            stat_set("serving_in_flight", len(self._inflight))
            self._inflight_cond.notify_all()

    def _completer_loop(self):
        """The sanctioned device->host boundary: wait on the oldest
        in-flight batch's event, copy its outputs to the host, slice per
        request, fulfill futures."""
        from .. import obs
        from ..profiler import count_sync, stat_add, stat_set, timed

        while True:
            with self._inflight_cond:
                while not self._inflight and not self._stop.is_set():
                    self._inflight_cond.wait(0.05)
                if not self._inflight:
                    if self._stop.is_set():
                        return
                    continue
                batch, outs, done = self._inflight.popleft()
                stat_set("serving_in_flight", len(self._inflight))
                self._inflight_cond.notify_all()
            try:
                with obs.span("serving.complete",
                              flow=[r.flow for r in batch]), \
                        timed("serving_response_ms"):
                    if done is not None:
                        done.synchronize()
                    count_sync(len(outs))
                    host = [_to_host(o) for o in outs]
            except Exception as e:  # noqa: BLE001 - fail the batch, keep serving
                for req in batch:
                    req.set_exception(e)
                continue
            total = sum(r.rows for r in batch)
            offset = 0
            now = time.perf_counter()
            for req in batch:
                sl = [h[offset:offset + req.rows]
                      if h.ndim >= 1 and h.shape[0] == total else h
                      for h in host]
                offset += req.rows
                req.set_result(sl)
                stat_add("serving_completed_total")
                metrics.record_latency("serving_request_ms",
                                       (now - req.submitted_at) * 1e3)
