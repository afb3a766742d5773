"""The serving Engine: request queue -> dynamic batcher -> dispatch loop
(counterpart of paddle_tpu/serving/engine.py).

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
A model is a callable `fn(*tensors) -> tensor(s)` run on the engine's
device (cuda unless EngineConfig(device="cpu")), an inference.Predictor
(on its own device), or a ProgramModel (an Executor and a Program, on
the executor's device); besides the default model, named models share
the pipeline as tenants (add_model, serving/registry.py).  Outputs come
back as numpy arrays; bf16 outputs are widened to float32 on the host,
since numpy has no bfloat16.

`AutoregressiveEngine` (second half of this module) is the token
generation engine: prefill/decode over a paged KV cache, chunked
prefill, lazy page growth with pause/preempt under pool pressure, and a
decode loop that never copies from the device to the host.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import device as _device
from . import metrics
from .admission import (AdmissionController, EngineClosed, EngineOverloaded,
                        RequestCancelled)
from .batcher import DynamicBatcher, Request, Response
from .bucketing import (BucketedRunner, bucket_for, bucket_ladder,
                        input_signature, pad_batch)

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
    donate             release each batch's padded feed on the device
                       right after the dispatch (inference
                       Config.enable_memory_optim; see BucketedRunner)
    bucketed           False = exact request shapes, no padding
                       (inference Config.switch_ir_optim(False))
    device             where callables run (default cuda; raises without
                       CUDA unless "cpu" is named)
    """

    def __init__(self, max_batch_size: int = 8,
                 max_queue_delay_ms: float = 2.0, max_queue: int = 64,
                 max_in_flight: int = 2,
                 buckets: Optional[Sequence[int]] = None,
                 min_bucket: int = 8, donate: bool = False,
                 bucketed: bool = True, device=None):
        self.max_batch_size = int(max_batch_size)
        self.max_queue_delay_ms = float(max_queue_delay_ms)
        self.max_queue = int(max_queue)
        self.max_in_flight = max(1, int(max_in_flight))
        self.buckets = list(buckets) if buckets else bucket_ladder(
            self.max_batch_size, min_bucket=min_bucket)
        self.donate = bool(donate)
        self.bucketed = bool(bucketed)
        self.device = device


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class _RunnerModel:
    """BucketedRunner-backed model (callables and Predictors)."""

    def __init__(self, runner: BucketedRunner):
        self.runner = runner
        self.buckets = runner.buckets
        self.device = runner.device

    def plan(self, inputs):
        return self.runner.plan(inputs)

    def is_compiled(self, inputs) -> bool:
        return self.runner.is_compiled(inputs)

    def ensure_compiled(self, inputs) -> None:
        self.runner.ensure_compiled(inputs)

    def run(self, inputs):
        return self.runner.run(inputs)

    def run_with_feed(self, inputs):
        return self.runner.run_with_feed(inputs)


class ProgramModel:
    """Engine model over an Executor and a Program (or CompiledProgram).

    Each batch is padded to its bucket and run by `executor.run` with
    lazy fetches; bucketing pins the feed signatures to the ladder, so
    the Executor's entry cache sees at most `len(buckets)` of them.  The
    first batch of a bucket builds its entry inline, in whichever engine
    thread runs it: the engine sends unseen buckets to its warm-up
    thread, so that happens off the dispatch loop with the batch parked.
    Runs on the executor's device."""

    def __init__(self, executor, program, feed_names: Sequence[str],
                 fetch_list: Sequence, scope=None,
                 buckets: Optional[Sequence[int]] = None,
                 bucketed: bool = True):
        self.executor = executor
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_list = list(fetch_list)
        self.scope = scope
        self.buckets = sorted(buckets) if buckets else bucket_ladder(8)
        self.bucketed = bucketed
        self.device = executor.device
        self._seen = set()
        # a batch runs on all old or all new weights, never a mix
        self._swap = threading.Lock()

    def plan(self, inputs):
        rows = inputs[0].shape[0]
        if self.bucketed:
            b = bucket_for(rows, self.buckets)
            bucket = b if b is not None else self.buckets[-1]
        else:
            bucket = rows
        return bucket, input_signature(inputs)

    def is_compiled(self, inputs) -> bool:
        return self.plan(inputs) in self._seen

    def ensure_compiled(self, inputs) -> None:
        pass  # the entry is built inside run(); see the class docstring

    def reload_weights(self, path: str) -> int:
        """Swap this model's parameters from a checkpoint (a ckpt dir or a
        checkpoint root: its newest complete one).  The new values are
        moved to the executor's device first, then committed to the scope
        together, between two batches: the Executor's const-state
        identity check takes them at the next dispatch, batches already
        dispatched finish on the old ones, and nothing drains.  Returns
        the number of parameters swapped."""
        from ..ckpt import read_state
        from ..fluid import core
        from ..fluid.executor import global_scope

        state, _ = read_state(path)
        scope = self.scope if self.scope is not None else global_scope()
        program = getattr(self.program, "_program", self.program)
        persist = {v.name: v for v in program.list_vars() if v.persistable}
        new = {name: self.executor._to_device(
                   val.to(core.torch_dtype(persist[name].dtype)))
               for name, val in state.items() if name in persist}
        with self._swap:
            for name, val in new.items():
                scope.set(name, val)
        return len(new)

    def run(self, inputs):
        rows = inputs[0].shape[0]
        top = self.buckets[-1]
        if self.bucketed and rows > top:
            parts = [self.run([a[lo:min(lo + top, rows)] for a in inputs])
                     for lo in range(0, rows, top)]
            return [torch.cat(vals, dim=0) for vals in zip(*parts)]
        bucket, sig = self.plan(inputs)
        padded = [pad_batch(a, bucket) for a in inputs]
        with self._swap:
            handles = self.executor.run(
                self.program, feed=dict(zip(self.feed_names, padded)),
                fetch_list=self.fetch_list, scope=self.scope,
                return_numpy=False)
        self._seen.add((bucket, sig))
        return [h.torch()[:rows] for h in handles]


def _as_model(model, config: EngineConfig):
    if isinstance(model, (_RunnerModel, ProgramModel)):
        return model
    if hasattr(model, "_traceable_fn"):  # inference.Predictor
        fn = model._traceable_fn()
        fixed = model._fixed_batch()
        buckets = [fixed] if fixed is not None else config.buckets
        # the predictor's inference.Config flags map onto the runner's
        # options: enable_memory_optim -> donate, switch_ir_optim(False)
        # -> exact shapes
        pcfg = getattr(model, "_config", None)
        donate = config.donate or bool(getattr(pcfg, "memory_optim",
                                               False))
        bucketed = config.bucketed and bool(getattr(pcfg, "ir_optim",
                                                    True))
        return _RunnerModel(BucketedRunner(
            fn, buckets, device=model.device, donate=donate,
            bucketed=bucketed if fixed is None else True))
    if callable(model):
        return _RunnerModel(BucketedRunner(
            model, config.buckets, device=config.device,
            donate=config.donate, bucketed=config.bucketed))
    raise TypeError(
        f"Engine model must be a Predictor, a callable, or a "
        f"ProgramModel; got {type(model).__name__}")


class Engine:
    """Continuous-batching inference engine over one loaded model — or,
    through `add_model` / `ModelRegistry` (serving/registry.py), a fleet
    of named models sharing this one pipeline.  `model` may be None when
    every request names a registered model."""

    def __init__(self, model=None, config: Optional[EngineConfig] = None,
                 start: bool = True):
        self.config = config or EngineConfig()
        self.model = _as_model(model, self.config) \
            if model is not None else None
        # named tenants: name -> wrapped model, changed live by
        # add_model / remove_model without draining; a batch resolves its
        # model at dispatch and never mixes tenants
        self._models: dict = {}
        self._models_lock = threading.Lock()
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

    # -- multi-tenant fleet (serving/registry.py) --------------------------
    def add_model(self, name: str, model, quota: Optional[int] = None,
                  priority: float = 0.0):
        """Register (or hot-swap) a named model live: batches already
        dispatched finish on the model they resolved, requests after this
        call see the new one.  `quota` bounds the tenant's queued
        requests (EngineOverloaded beyond it); `priority` is its base
        scheduling priority (aged by waiting time)."""
        wrapped = _as_model(model, self.config)
        with self._models_lock:
            self._models[str(name)] = wrapped
        self._batcher.set_tenant(str(name), quota=quota,
                                 priority=priority)
        return wrapped

    def remove_model(self, name: str, cancel_queued: bool = True):
        """Unregister a named model without draining the others; its
        queued requests are cancelled (batches in flight finish)."""
        with self._models_lock:
            wrapped = self._models.pop(str(name), None)
        if cancel_queued:
            self._batcher.cancel_tenant(str(name))
        self._batcher.clear_tenant(str(name))
        return wrapped

    def model_names(self) -> List[str]:
        with self._models_lock:
            return sorted(self._models)

    def _model_of(self, tenant: Optional[str]):
        if tenant is None:
            if self.model is None:
                raise EngineClosed(
                    "engine has no default model — submit with "
                    "model=<name> or register one via add_model")
            return self.model
        with self._models_lock:
            m = self._models.get(tenant)
        if m is None:
            raise EngineClosed(f"model {tenant!r} is not registered")
        return m

    # -- client surface ----------------------------------------------------
    def submit(self, inputs: Sequence[Any], model: Optional[str] = None,
               priority: float = 0.0) -> Response:
        """Queue one request (inputs share a leading batch dim).  `model`
        names a model registered by add_model (None = the default one).
        Raises EngineOverloaded at the queue bound or the tenant's quota,
        EngineClosed after shutdown."""
        if self._closed:
            raise EngineClosed("engine is shut down")
        if model is not None:
            self._model_of(str(model))  # an unknown tenant fails fast
        arrays = []
        for a in inputs:
            a = a if isinstance(a, np.ndarray) else np.asarray(a)
            if a.ndim == 0:
                raise ValueError(
                    "engine inputs need a leading batch dim (got a "
                    "scalar); wrap single examples as shape (1, ...)")
            arrays.append(a)
        return self._batcher.submit(Request(
            arrays, tenant=None if model is None else str(model),
            priority=priority))

    def infer(self, inputs: Sequence[Any],
              timeout: Optional[float] = None,
              model: Optional[str] = None) -> List[np.ndarray]:
        """Synchronous convenience: submit + wait."""
        return self.submit(inputs, model=model).result(timeout)

    def reload_weights(self, path: str) -> int:
        """Swap the default model's parameters from a ckpt checkpoint
        without draining (see ProgramModel.reload_weights).  Only a
        ProgramModel has the seam (its parameters live in the scope);
        callables and Predictors carry their weights in what they run,
        and raise TypeError: build a new Engine for them.  Returns the
        number of parameters swapped."""
        from .. import obs
        from ..profiler import stat_add

        swap = getattr(self.model, "reload_weights", None)
        if swap is None:
            raise TypeError(
                "reload_weights needs a ProgramModel-backed engine "
                "(parameters live in the scope); "
                f"{type(self.model).__name__} bakes its weights into "
                "the traced computation — rebuild the Engine to swap "
                "models")
        with obs.span("ckpt.reload"):
            count = swap(path)
        stat_add("ckpt_reload_count")
        return count

    # -- pipeline threads --------------------------------------------------
    def _dispatch_loop(self):
        """Hot path: pull coalesced batches and dispatch the warmed ones;
        park batches whose bucket is new with the warm-up thread.  Never
        warms up, never waits on the device, never transfers to the
        host."""
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
                model = self._model_of(batch[0].tenant)
                if model.is_compiled(inputs):
                    self._dispatch_batch(batch, inputs, model)
                else:
                    with self._inflight_cond:
                        self._compiling += 1
                    self._compile_q.put((batch, inputs, model))
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
            batch, inputs, model = item
            try:
                with obs.span("serving.compile",
                              flow=[r.flow for r in batch]):
                    model.ensure_compiled(inputs)
                self._dispatch_batch(batch, inputs, model)
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

    def _dispatch_batch(self, batch: List[Request], inputs, model) -> None:
        """Launch one batch on the device without waiting for it, and
        record a CUDA event after it on this thread's stream; bounded
        dispatch-ahead: at most max_in_flight batches between here and
        the completer.  The batch's device feed stays with it until its
        outputs reach the host, unless the model donates it."""
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
        bucket, _sig = model.plan(inputs)
        with obs.span("serving.dispatch",
                      flow=[r.flow for r in batch]), \
                timed("serving_dispatch_ms"):
            run_with_feed = getattr(model, "run_with_feed", None)
            outs, feed = run_with_feed(inputs) if run_with_feed \
                else (model.run(inputs), None)
            done = None
            if model.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(model.device))
        metrics.observe_batch(len(batch), rows, max(0, bucket - rows))
        with self._inflight_cond:
            self._inflight.append((batch, outs, done, feed))
            stat_set("serving_in_flight", len(self._inflight))
            self._inflight_cond.notify_all()

    def _completer_loop(self):
        """The sanctioned device->host boundary: wait on the oldest
        in-flight batch's event, copy its outputs to the host, slice per
        request, fulfill futures."""
        from .. import obs
        from ..profiler import (count_sync, stat_add, stat_set, time_add,
                                timed)

        while True:
            with self._inflight_cond:
                while not self._inflight and not self._stop.is_set():
                    self._inflight_cond.wait(0.05)
                if not self._inflight:
                    if self._stop.is_set():
                        return
                    continue
                batch, outs, done, feed = self._inflight.popleft()
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
            del feed  # the outputs are on the host: the feed may go
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
                latency_ms = (now - req.submitted_at) * 1e3
                metrics.record_latency("serving_request_ms", latency_ms)
                if req.tenant is not None:
                    stat_add(metrics.tenant_stat(req.tenant,
                                                 "completed_total"))
                    name = metrics.tenant_stat(req.tenant, "request_ms")
                    time_add(name, latency_ms)
                    metrics.record_latency(name, latency_ms)

    # -- introspection -----------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return self._batcher.depth

    @property
    def in_flight(self) -> int:
        with self._inflight_cond:
            return len(self._inflight)


# ---------------------------------------------------------------------------
# Autoregressive decode: prefill/decode split over paged KV state
# ---------------------------------------------------------------------------

def _tokens_to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of a token slice on the host: the slot's buffer is reused
    by the next request (on the CPU a plain .cpu() would alias it)."""
    return t.to("cpu", copy=True).numpy()


class _GenRequest:
    """One generation request: prompt -> up to max_new_tokens."""

    def __init__(self, prompt: np.ndarray, max_new_tokens: int):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.submitted_at = time.perf_counter()
        self._event = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._exc: Optional[BaseException] = None
        self._cancelled = False

    def cancel(self) -> bool:
        if self._event.is_set():
            return False
        self._cancelled = True
        return True

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("generation not finished")
        if self._exc is not None:
            raise self._exc
        return self._result

    def _finish(self, tokens=None, exc=None):
        if self._event.is_set():
            return
        self._result, self._exc = tokens, exc
        self._event.set()


class LayeredDecoder:
    """Multi-layer decoder contract for `AutoregressiveEngine`.

        embed(tokens, positions) -> x        # (B, T) int32 -> hidden
        layers: sequence of (qkv, merge) pairs, applied in order:
            qkv(x, positions) -> (q, k, v)   # each (B, T, H, D)
            merge(x, attn)    -> x           # residual / FFN half
        unembed(x) -> logits                 # (B, T, V)

    `x` is opaque: the engine only threads it through, so any hidden
    representation works.  All layers share one `PagedKVCache` pool with
    a leading layer dim (serving/kv_cache.py): one page allocation covers
    the whole stack, and one decode step runs the full depth."""

    def __init__(self, embed: Callable, layers: Sequence,
                 unembed: Callable):
        if not layers:
            raise ValueError("LayeredDecoder needs >= 1 layer")
        self.embed = embed
        self.layers = [tuple(layer) for layer in layers]
        self.unembed = unembed


def _classic_decoder(qkv_fn: Callable, out_fn: Callable) -> LayeredDecoder:
    """Adapt the single-layer contract (qkv_fn(tokens, positions),
    out_fn(attn)) onto LayeredDecoder: the 'hidden state' is just the
    (tokens, positions) pair."""
    return LayeredDecoder(
        embed=lambda tokens, positions: (tokens, positions),
        layers=[(lambda x, positions: qkv_fn(x[0], x[1]),
                 lambda x, attn: attn)],
        unembed=out_fn)


class _PrefillJob:
    """Host-side progress of one prompt through (chunked) prefill."""

    __slots__ = ("req", "slot", "chunks", "idx")

    def __init__(self, req: _GenRequest, slot: int, chunks: List):
        self.req = req
        self.slot = slot
        self.chunks = chunks  # [(padded_np, bucket, offset, chunk_len)]
        self.idx = 0


class _Entry:
    """One engine entry (single-shot prefill or chunk step of one bucket,
    or the decode step), built once per key.  Where the JAX engine
    AOT-compiles an entry, PyTorch runs eagerly: the entry's FIRST call is
    its warm-up (kernel builds, cuBLAS handles, the allocator's first
    blocks), timed into serving_compile_ms (synchronizing on CUDA so the
    time is the device's too) and counted in serving_trace_count, as
    BucketedRunner.ensure_compiled counts a bucket's warm-up.  Later calls
    are timed into serving_dispatch_ms (host enqueue time)."""

    def __init__(self, fn: Callable, device: torch.device):
        self.fn = fn
        self.device = device
        self.warm = False

    def __call__(self, *args):
        from ..profiler import stat_add, timed

        if self.warm:
            with timed("serving_dispatch_ms"):
                return self.fn(*args)
        with timed("serving_compile_ms"):
            out = self.fn(*args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        stat_add("serving_trace_count")
        self.warm = True
        return out


class AutoregressiveEngine:
    """Continuous-batching token generation over paged KV state
    (counterpart of paddle_tpu's AutoregressiveEngine).

    Model contract: either the single-layer pair

        qkv_fn(tokens, positions) -> (q, k, v)   # (B, T) -> (B, T, H, D)
        out_fn(attn)              -> logits      # (B, T, H, D) -> (B, T, V)

    or `model=LayeredDecoder(...)` for an N-layer decoder; every layer
    reads and writes its own plane of ONE multi-layer KV pool inside the
    same decode step.  The model's functions take and return torch
    tensors on the engine's `device` (default cuda; raises without CUDA
    unless device="cpu").

    Slots: `max_slots` sequences decode together in one step (greedy
    argmax), each reading and writing its own KV pages; free slots ride
    along masked.  Prompts longer than `prefill_chunk` tokens prefill in
    fixed-size CHUNKS, at most one chunk per engine step, interleaved with
    the decode batch.  Pages are allocated LAZILY: admission reserves
    `pages_needed(prompt_len) + page_slack` and decode extends page by
    page; pool exhaustion mid-decode PAUSES the starved slot (typed
    backpressure via EngineOverloaded("kv_pages")) until pages free up.
    Host bookkeeping mirrors lengths exactly, so the decode loop performs
    ZERO device->host transfers: tokens stay on the device and reach the
    host once, at retirement (counted by count_sync).  Host->device
    updates of the page rows go through pinned memory, non-blocking, so
    they do not synchronize the stream either.  The pools are written in
    place.

    Left out against the JAX engine: the telemetry auto-attach of
    `start()` (the port has no obs/telemetry yet).
    """

    def __init__(self, qkv_fn: Optional[Callable] = None,
                 out_fn: Optional[Callable] = None,
                 num_heads: int = None, head_dim: int = None, *,
                 model: Optional[LayeredDecoder] = None,
                 num_pages: int = 64,
                 page_size: int = 16, max_slots: int = 4,
                 max_pages_per_seq: int = 8, max_queue: int = 16,
                 prompt_buckets: Sequence[int] = (16, 32, 64),
                 dtype: Optional[torch.dtype] = None,
                 prefill_chunk: Optional[int] = None,
                 page_slack: int = 1, device=None):
        from .kv_cache import PagedKVCache

        if model is None:
            if qkv_fn is None or out_fn is None:
                raise ValueError("pass (qkv_fn, out_fn) or model=")
            model = _classic_decoder(qkv_fn, out_fn)
        self.model = model
        self.device = _device.resolve(device)
        self.num_layers = len(model.layers)
        self.max_slots = int(max_slots)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.prompt_buckets = sorted(prompt_buckets)
        # chunk budget: prompts longer than this prefill in chunks of this
        # many tokens; default = the top prompt bucket
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk \
            else self.prompt_buckets[-1]
        self.page_slack = max(0, int(page_slack))
        self.kv = PagedKVCache(num_pages, page_size, num_heads,
                               head_dim, dtype=dtype,
                               num_layers=self.num_layers,
                               device=self.device)
        self._admission = AdmissionController(
            max_queue, resource="queue",
            gauge_stat="serving_queue_depth")
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self._admitting = 0
        self._closed = False
        s, w = self.max_slots, self.max_pages_per_seq
        zeros = lambda *shape, dtype=torch.int32: torch.zeros(
            shape, dtype=dtype, device=self.device)
        self._state = {
            "kc": self.kv.k, "vc": self.kv.v,
            "page_rows": zeros(s, w),
            "lengths": zeros(s),
            "last_tok": zeros(s),
            "gen_counts": zeros(s),
            "active": zeros(s, dtype=torch.bool),
        }
        self._out_tokens_cap = 0
        self._slots: List[Optional[_GenRequest]] = [None] * s
        self._slot_gen: List[int] = [0] * s
        self._slot_len: List[int] = [0] * s
        self._slot_pages: List[int] = [0] * s
        self._paused: List[bool] = [False] * s
        self._prefilling: dict = {}  # slot -> _PrefillJob
        self._entries: Dict[tuple, _Entry] = {}
        self._decode_step = _Entry(self._decode_fn, self.device)
        self._serve_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- client surface ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16) -> _GenRequest:
        if self._closed:
            raise EngineClosed("engine is shut down")
        req = _GenRequest(prompt, max_new_tokens)
        total = len(req.prompt) + req.max_new_tokens - 1
        if self.kv.table.pages_needed(total) > self.max_pages_per_seq:
            raise EngineOverloaded(
                "kv_pages", self.kv.table.pages_needed(total),
                self.max_pages_per_seq,
                detail="request exceeds max_pages_per_seq")
        self._admission.admit()  # EngineOverloaded at the queue bound
        from ..profiler import stat_add

        stat_add("serving_requests_total")
        with self._lock:
            self._pending.append(req)
        return req

    def generate(self, prompt, max_new_tokens: int = 16,
                 timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous convenience: submit + step to completion."""
        req = self.submit(prompt, max_new_tokens)
        if self._serve_thread is None:
            deadline = None if timeout is None \
                else time.perf_counter() + timeout
            while not req.done():
                self.step()
                if deadline is not None \
                        and time.perf_counter() > deadline:
                    raise TimeoutError("generation not finished")
        return req.result(timeout)

    # -- engine loop -------------------------------------------------------
    def step(self) -> bool:
        """One engine iteration: admit -> one prefill chunk -> grow
        pages -> decode -> retire.  At most ONE prefill chunk runs per
        step, so in-flight decode slots stall by at most one chunk's
        step time no matter how long the incoming prompt is.  Returns
        True while there is (or may be) work left.  Runs under
        torch.inference_mode, which is thread-local: it is entered here,
        in the thread that steps."""
        with torch.inference_mode():
            self._admit()
            self._prefill_tick()
            self._ensure_pages()
            if any(req is not None and i not in self._prefilling
                   and not self._paused[i]
                   for i, req in enumerate(self._slots)):
                self._decode()
            self._retire()
        with self._lock:
            return bool(self._pending) or bool(self._admitting) \
                or any(s is not None for s in self._slots)

    def run_until_idle(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.step():
                return
        raise RuntimeError("run_until_idle: still busy after "
                           f"{max_steps} steps")

    def start(self) -> "AutoregressiveEngine":
        """Background serve loop (daemon mode); tests drive step()
        directly for determinism."""
        if self._serve_thread is not None:
            return self

        def loop():
            while not self._stop.is_set():
                if not self.step():
                    time.sleep(0.001)

        self._serve_thread = threading.Thread(
            target=loop, name="serving-decode", daemon=True)
        self._serve_thread.start()
        return self

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = 30.0) -> None:
        self._closed = True
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        if drain and self._serve_thread is not None:
            while True:
                with self._lock:
                    busy = bool(self._pending) or bool(self._admitting) \
                        or any(s is not None for s in self._slots)
                if not busy or (deadline is not None
                                and time.perf_counter() > deadline):
                    break
                time.sleep(0.002)
        elif drain:
            self.run_until_idle()
        self._stop.set()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5)
            self._serve_thread = None
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
        for req in pending:
            self._admission.release()
            req._finish(exc=EngineClosed("engine shut down"))

    # -- internals ---------------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without a host sync: on
        CUDA it is staged in pinned memory and copied non-blocking (a
        pageable copy would synchronize the stream)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _target_pages(self, n_tokens: int) -> int:
        """The lazy-growth invariant: a live sequence holding n_tokens
        owns pages_needed(n_tokens) + page_slack pages, capped at the
        row width."""
        return min(self.kv.table.pages_needed(n_tokens)
                   + self.page_slack, self.max_pages_per_seq)

    def _grow_to(self, req: _GenRequest, n_tokens: int) -> bool:
        """Extend-backpressure path: ensure `req` owns pages covering
        `n_tokens` (plus opportunistic slack).  Returns False on pool
        exhaustion: the caller pauses/stalls the ONE starved slot and
        retries next step; co-batched requests keep decoding.  Raises
        EngineOverloaded("kv_rows") only if the sequence can never fit
        its row (caller retires the slot early)."""
        from ..profiler import stat_add

        table = self.kv.table
        need = table.pages_needed(n_tokens)
        if need > self.max_pages_per_seq:
            raise EngineOverloaded(
                "kv_rows", need, self.max_pages_per_seq,
                detail="sequence outgrew its page row")
        owned = len(table.pages_of(id(req)))
        if owned < need:
            try:
                table.extend(id(req), need - owned)
                stat_add("serving_kv_pages_extended", need - owned)
                owned = need
            except EngineOverloaded:
                stat_add("serving_kv_backpressure_total")
                return False
        target = self._target_pages(n_tokens)
        if owned < target:
            # slack beyond the hard requirement is opportunistic: missing
            # it under pressure is not a reason to stall
            try:
                table.extend(id(req), target - owned)
                stat_add("serving_kv_pages_extended", target - owned)
            except EngineOverloaded:
                pass
        return True

    def _admit(self) -> None:
        from ..profiler import stat_add

        while True:
            free = [i for i in self._free_slots()
                    if i not in self._prefilling]
            if not free:
                return
            with self._lock:
                if not self._pending:
                    return
                req = self._pending[0]
                if req._cancelled:
                    self._pending.popleft()
                    self._admission.release()
                    stat_add("serving_cancelled_total")
                    req._finish(exc=RequestCancelled("cancelled"))
                    continue
                # LAZY reservation: pages for the prompt only (plus
                # slack), not the worst case prompt + max_new_tokens
                try:
                    self.kv.table.allocate(id(req), len(req.prompt))
                except EngineOverloaded:
                    return  # pool full: stay pending, retry next step
                extra = self._target_pages(len(req.prompt)) \
                    - len(self.kv.table.pages_of(id(req)))
                if extra > 0:
                    try:
                        self.kv.table.extend(id(req), extra)
                    except EngineOverloaded:
                        pass  # slack is opportunistic at admission too
                self._pending.popleft()
                self._admission.release()
                # visible to the shutdown drain check across the
                # pending -> slot window
                self._admitting += 1
            try:
                slot = free[0]
                self._slots[slot] = req
                self._slot_gen[slot] = 0
                self._slot_len[slot] = 0
                self._slot_pages[slot] = 0
                self._paused[slot] = False
                self._prefilling[slot] = _PrefillJob(
                    req, slot, self._plan_chunks(req))
            finally:
                with self._lock:
                    self._admitting -= 1

    def _ensure_token_buffer(self, max_new: int) -> None:
        if max_new <= self._out_tokens_cap:
            return
        cap = max(16, 1 << (max_new - 1).bit_length())
        buf = torch.zeros((self.max_slots, cap), dtype=torch.int32,
                          device=self.device)
        if self._out_tokens_cap:
            buf[:, :self._out_tokens_cap] = self._state["out_tokens"]
        self._state["out_tokens"] = buf
        self._out_tokens_cap = cap

    def _plan_chunks(self, req: _GenRequest) -> List:
        """Split a prompt into prefill chunks of <= prefill_chunk tokens,
        each padded up to a prompt bucket.  Prompts that fit one chunk
        stay single-shot (causal flash attention over the bucket); longer
        ones run the chunk entry per piece, interleaved with decode by
        _prefill_tick."""
        toks = req.prompt
        n = len(toks)
        chunks = []
        off = 0
        while True:
            clen = min(self.prefill_chunk, n - off)
            bucket = bucket_for(clen, self.prompt_buckets)
            if bucket is None:
                bucket = 1 << (max(1, clen) - 1).bit_length()
            padded = np.zeros((bucket,), np.int32)
            padded[:clen] = toks[off:off + clen]
            chunks.append((padded, bucket, off, clen))
            off += clen
            if off >= n:
                return chunks

    def _prefill_tick(self) -> None:
        """Chunk scheduler: advance AT MOST ONE prefill job by one chunk
        per engine step, the bound that keeps a long incoming prompt from
        head-of-line-blocking the decode batch.  A job whose next chunk
        cannot get pages stalls in place (typed backpressure) and retries
        next step."""
        from ..profiler import stat_add
        from .kv_cache import write_prefill

        for slot in sorted(self._prefilling):
            job = self._prefilling[slot]
            req = job.req
            if req._cancelled:
                self._abort_prefill(slot)
                continue
            padded, bucket, off, clen = job.chunks[job.idx]
            try:
                if not self._grow_to(req, off + clen):
                    continue  # pool pressure: job stalls, others may run
            except EngineOverloaded:
                # kv_rows: can never fit (the submit() precheck makes this
                # unreachable; kept for direct table use)
                self._abort_prefill(slot, exc=EngineOverloaded(
                    "kv_rows", self.kv.table.pages_needed(off + clen),
                    self.max_pages_per_seq,
                    detail="prompt outgrew its page row"))
                continue
            rows = self._to_device(
                self.kv.table.rows(id(req), self.max_pages_per_seq))
            tokens = self._to_device(padded)
            st = self._state
            t0 = time.perf_counter()
            if len(job.chunks) == 1:
                # single-shot: embed -> per-layer causal flash attention
                # -> first token, then one page scatter of every layer
                first_tok, k, v = self._prefill_entry(bucket)(tokens, clen)
                write_prefill(st["kc"], st["vc"], rows, clen, k, v)
            else:
                # chunk step: write this chunk's K/V into the pages, then
                # ragged paged attention over everything written so far
                # (causal within the chunk via q_positions)
                first_tok = self._chunk_entry(bucket)(
                    st["kc"], st["vc"], rows, off, clen, tokens)
                stat_add("serving_prefill_chunks")
            metrics.record_latency(
                "serving_prefill_chunk_ms",
                (time.perf_counter() - t0) * 1e3)
            job.idx += 1
            if job.idx >= len(job.chunks):
                stat_add("serving_prefill_count")
                self._finish_prefill(slot, first_tok, rows)
            return  # ONE chunk per engine step, by design

    def _finish_prefill(self, slot: int, first_tok, rows) -> None:
        job = self._prefilling.pop(slot)
        req = job.req
        n = len(req.prompt)
        st = self._state
        st["page_rows"][slot] = rows
        st["lengths"][slot] = n
        st["last_tok"][slot] = first_tok
        st["gen_counts"][slot] = 1
        self._ensure_token_buffer(req.max_new_tokens)
        st["out_tokens"][slot, 0] = first_tok
        st["active"][slot] = True
        self._slot_gen[slot] = 1
        self._slot_len[slot] = n
        self._slot_pages[slot] = len(self.kv.table.pages_of(id(req)))
        metrics.record_latency(
            "serving_ttft_ms",
            (time.perf_counter() - req.submitted_at) * 1e3)

    def _abort_prefill(self, slot: int, exc=None) -> None:
        from ..profiler import stat_add

        job = self._prefilling.pop(slot)
        req = job.req
        self.kv.table.free(id(req))
        self._slots[slot] = None
        if exc is None:
            stat_add("serving_cancelled_total")
            exc = RequestCancelled("cancelled")
        req._finish(exc=exc)

    def _ensure_pages(self) -> None:
        """Lazy growth, decode side: before the decode step appends at
        position lengths[i], make sure slot i's page row covers it.  Pool
        exhaustion PAUSES the slot (active=False; the step redirects its
        write to the scratch page and freezes its length) until extend
        succeeds; row-width overflow (EngineOverloaded("kv_rows")) retires
        the slot early with the tokens generated so far.  Either way,
        co-batched slots keep decoding."""
        from ..profiler import stat_add

        st = self._state
        table = self.kv.table
        for i, req in enumerate(self._slots):
            if req is None or i in self._prefilling:
                continue
            try:
                ok = self._grow_to(req, self._slot_len[i] + 1)
            except EngineOverloaded as e:
                self._early_retire(i, reason=e.resource)
                continue
            if ok:
                owned = len(table.pages_of(id(req)))
                if owned != self._slot_pages[i]:
                    st["page_rows"][i] = self._to_device(
                        table.rows(id(req), self.max_pages_per_seq))
                    self._slot_pages[i] = owned
                if self._paused[i]:
                    self._paused[i] = False
                    st["active"][i] = True
            elif not self._paused[i]:
                self._paused[i] = True
                st["active"][i] = False
                stat_add("serving_kv_paused_total")
        # livelock escape: every decoding slot paused and zero free pages
        # means nobody can ever extend; preempt (truncate) the slot with
        # the most tokens so the rest of the batch survives
        decoding = [i for i, r in enumerate(self._slots)
                    if r is not None and i not in self._prefilling]
        if decoding and all(self._paused[i] for i in decoding) \
                and table.available == 0:
            victim = max(decoding, key=lambda i: self._slot_gen[i])
            stat_add("serving_kv_preempt_total")
            self._early_retire(victim, reason="kv_preempt")

    def _early_retire(self, i: int, reason: str) -> None:
        """Finish slot i NOW with the tokens generated so far (a
        truncated but successful generation), freeing its pages for the
        co-batched slots.  Used for kv_rows overflow and the all-paused
        preemption escape."""
        from ..profiler import count_sync, stat_add

        req = self._slots[i]
        st = self._state
        count_sync()
        tokens = _tokens_to_host(st["out_tokens"][i, :self._slot_gen[i]])
        req._finish(tokens=tokens)
        stat_add("serving_completed_total")
        metrics.record_latency(
            "serving_request_ms",
            (time.perf_counter() - req.submitted_at) * 1e3)
        self.kv.table.free(id(req))
        st["active"][i] = False
        self._slots[i] = None
        self._slot_gen[i] = 0
        self._slot_len[i] = 0
        self._slot_pages[i] = 0
        self._paused[i] = False

    def _entry(self, key: tuple, build: Callable[[], Callable]) -> _Entry:
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(build(), self.device)
        return entry

    def _prefill_entry(self, bucket: int) -> _Entry:
        """Single-shot prefill for one prompt bucket: embed -> per-layer
        causal attention (the flash kernel, key-padding bias) ->
        first-token logits, plus the stacked (L, Tb, H, D) K/V."""
        model, dev = self.model, self.device

        def build():
            from ..ops.kernels.attention import (
                DEFAULT_MASK_VALUE, scaled_dot_product_attention)

            def prefill(tokens, length):
                tb = tokens.shape[0]
                pos = torch.arange(tb, dtype=torch.int32, device=dev)
                x = model.embed(tokens[None], pos[None])
                bias = torch.where(pos < length, 0.0,
                                   DEFAULT_MASK_VALUE)[None]
                ks, vs = [], []
                for qkv, merge in model.layers:
                    q, k, v = qkv(x, pos[None])
                    attn = scaled_dot_product_attention(
                        q, k, v, mask=bias[:, None, None, :],
                        is_causal=True)
                    x = merge(x, attn)
                    ks.append(k[0])
                    vs.append(v[0])
                logits = model.unembed(x)
                last = logits[0, length - 1]
                return (torch.argmax(last).to(torch.int32),
                        torch.stack(ks), torch.stack(vs))

            return prefill

        return self._entry(("prefill", bucket), build)

    def _chunk_entry(self, bucket: int) -> _Entry:
        """Prefill-CHUNK step for one chunk bucket: per layer, write the
        chunk's K/V into the sequence's pages at `offset` (in place), then
        ragged paged attention over everything written so far (causal
        within the chunk via q_positions).  The same entry serves every
        chunk of every long prompt at this bucket."""
        model, dev = self.model, self.device

        def build():
            from ..ops.kernels.attention import paged_attention
            from .kv_cache import write_prefill

            def chunk_step(kc, vc, rows, offset, clen, tokens):
                tb = tokens.shape[0]
                pos = offset + torch.arange(tb, dtype=torch.int32,
                                            device=dev)
                x = model.embed(tokens[None], pos[None])
                lengths = torch.full((1,), offset + clen,
                                     dtype=torch.int32, device=dev)
                for li, (qkv, merge) in enumerate(model.layers):
                    q, k, v = qkv(x, pos[None])
                    write_prefill(kc[li], vc[li], rows, clen, k[0], v[0],
                                  start=offset)
                    attn = paged_attention(q, kc[li], vc[li], rows[None],
                                           lengths, q_positions=pos[None])
                    x = merge(x, attn)
                logits = model.unembed(x)
                return torch.argmax(logits[0, clen - 1]).to(torch.int32)

            return chunk_step

        return self._entry(("chunk", bucket), build)

    def _decode_fn(self, st) -> None:
        """One decode step over every slot and every layer, updating the
        device state `st` in place: append each active slot's K/V, paged
        attention, greedy next token, lengths/last token/counts."""
        from ..ops.kernels.attention import paged_attention
        from .kv_cache import append_token

        pos = st["lengths"]
        kc, vc, rows, active = st["kc"], st["vc"], st["page_rows"], \
            st["active"]
        x = self.model.embed(st["last_tok"][:, None], pos[:, None])
        for li, (qkv, merge) in enumerate(self.model.layers):
            q, k, v = qkv(x, pos[:, None])
            append_token(kc[li], vc[li], rows, pos, k[:, 0], v[:, 0],
                         active)
            attn = paged_attention(q, kc[li], vc[li], rows, pos + 1)
            x = merge(x, attn)
        logits = self.model.unembed(x)[:, 0]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        gidx = torch.clamp(st["gen_counts"], max=self._out_tokens_cap - 1)
        gidx = gidx.long()[:, None]
        old = torch.gather(st["out_tokens"], 1, gidx)[:, 0]
        st["out_tokens"].scatter_(1, gidx,
                                  torch.where(active, nxt, old)[:, None])
        st["lengths"].copy_(torch.where(active, pos + 1, pos))
        st["last_tok"].copy_(torch.where(active, nxt, st["last_tok"]))
        st["gen_counts"].copy_(torch.where(active, st["gen_counts"] + 1,
                                           st["gen_counts"]))

    def _decode(self) -> None:
        from ..profiler import stat_add

        self._decode_step(self._state)
        stat_add("serving_decode_steps")
        for i, req in enumerate(self._slots):
            if req is not None and i not in self._prefilling \
                    and not self._paused[i]:
                self._slot_gen[i] += 1
                self._slot_len[i] += 1

    def _retire(self) -> None:
        from ..profiler import count_sync, stat_add, timed

        for i, req in enumerate(self._slots):
            if req is None or i in self._prefilling:
                continue  # prefilling cancels run in _prefill_tick
            done = self._slot_gen[i] >= req.max_new_tokens
            if not (done or req._cancelled):
                continue
            st = self._state
            if req._cancelled:
                stat_add("serving_cancelled_total")
                req._finish(exc=RequestCancelled("cancelled"))
            else:
                with timed("serving_response_ms"):
                    count_sync()
                    tokens = _tokens_to_host(
                        st["out_tokens"][i, :self._slot_gen[i]])
                req._finish(tokens=tokens)
                stat_add("serving_completed_total")
                metrics.record_latency(
                    "serving_request_ms",
                    (time.perf_counter() - req.submitted_at) * 1e3)
            self.kv.table.free(id(req))
            st["active"][i] = False
            self._slots[i] = None
            self._slot_gen[i] = 0
            self._slot_len[i] = 0
            self._slot_pages[i] = 0
            self._paused[i] = False
