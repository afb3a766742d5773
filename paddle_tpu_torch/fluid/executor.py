"""Executor + Scope of the port: run a Program block as one torch callable
(counterpart of paddle_tpu/fluid/executor.py).

`Executor(place).run(program, feed, fetch_list)` builds, once per (program
id and version, feed shapes and dtypes, fetch names, scope), a callable
that runs the block's op rules in order on the Executor's device
(ops/registry.lower_block), and keeps it in a bounded LRU
(`CACHE_CAPACITY`).  The block's state is split as the reference splits
it (`_analyze_block`): the scope vars it reads, and the persistable vars
it writes (parameters, velocities, moments, BN running statistics, beta
powers, the learning rate), which go back into the Scope after the step.
Each intermediate is dropped from the run's environment after its last
use, and each forward op's graph after its grad op has run.

The step makes no device->host sync but those of the control-flow
rules (a `while` reads its condition once an iteration, a
`conditional_block` its condition once; counted on
`control_flow_host_reads` and `executor_sync_count`): feeds staged on
the device pass through, state stays on the device between steps, and
with `return_numpy=False` fetches come back as `LazyFetch` handles,
whose `.numpy()` is the sanctioned sync point (counted on
`executor_sync_count`).  Counters: `executor_run_count`,
`executor_compile_count`, `executor_cache_hits`, `executor_op_count`
(ops run, each iteration of a sub-block counted) and the `dispatch_ms`
/ `host_feed_ms` / `sync_ms` timers.

`run` takes a `CompiledProgram` (parallel/compiler.py: this rank's block
over the process group) and `LoDTensor` feeds.  With `FLAGS_check_nan_inf` every run
computes one device-side non-finite flag per float output and state
array and copies them to pinned host memory behind an event
(`_NanMonitor`); a hit raises at the next `run()` entry whose flags have
arrived, at `sync()`, or at a dataset loop's exit, naming the first
variable.  `train_from_dataset` / `infer_from_dataset` drive a fluid
dataset through `dataset.feed_pipeline.FeedPipeline` (batches staged
ahead on a side stream) with the host at most `prefetch_depth` steps
ahead of the device; `train_from_dataset` checkpoints and resumes through
`_AutoCheckpoint` (paddle_tpu_torch.ckpt).

The callable runs eagerly, op by op: capturing it in a CUDA graph or
compiling it is not ported, nor are the AOT cache and numerics (ROADMAP
queue 1 items 11 and 13), or train_from_dataset's telemetry (item 13).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import profiler
from ..device import resolve
from ..ops import registry
from . import core, flags
from .compile_cache import CompileCache
from .framework import EMPTY_VAR_NAME, Program, Variable, \
    default_main_program


def dataset_np_dtype(var) -> np.dtype:
    """The numpy dtype a feed of `var` takes on the host (bfloat16 feeds
    stay float32 there)."""
    name = core.convert_dtype(var.dtype)
    return np.dtype("float32" if name == "bfloat16" else name)


class LazyFetch:
    """Future-like fetch handle (`run(..., return_numpy=False)`).

    Wraps the device tensor of one fetch target without copying it to the
    host.  `.numpy()` / `np.asarray(h)` / `float(h)` are the sanctioned
    sync points; each counts on `executor_sync_count` and `sync_ms`.
    `.torch()` hands back the tensor itself; shape and dtype are metadata
    reads and never sync."""

    __slots__ = ("_val", "_np", "name")

    def __init__(self, val, name: str = None):
        self._val = val
        self._np = None
        self.name = name

    @property
    def shape(self):
        return tuple(self._val.shape)

    @property
    def dtype(self):
        return np.dtype(core.convert_dtype(self._val.dtype))

    def torch(self):
        """The underlying device tensor; no transfer."""
        return self._val

    def numpy(self):
        if self._np is None:
            with profiler.timed("sync_ms"):
                profiler.count_sync()
                self._np = self._val.detach().cpu().numpy()
        return self._np

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(self.numpy())

    def __int__(self):
        return int(self.numpy())

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        state = "ready" if self._np is not None else "on device"
        return f"LazyFetch(name={self.name!r}, shape={self.shape}, {state})"


class _VarHolder:
    """LoDTensor-flavored handle for Scope API parity."""

    def __init__(self, scope: "Scope", name: str):
        self._scope = scope
        self._name = name

    def get_tensor(self):
        return self

    def set(self, value, place=None):
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value))
        self._scope.set(self._name, value)

    def numpy(self):
        val = self._scope.get(self._name)
        if isinstance(val, torch.Tensor):
            return val.detach().cpu().numpy()
        return np.asarray(val)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def shape(self):
        return list(self._scope.get(self._name).shape)


class Scope:
    """Name -> tensor store for persistable state (parameters, optimizer
    accumulators, running statistics).  Hierarchical: child scopes see
    their parents' vars.  Values the Executor commits stay on its
    device."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self.parent = parent

    def var(self, name: str) -> _VarHolder:
        if not self.has(name):
            self._vars[name] = None
        return _VarHolder(self, name)

    def find_var(self, name: str) -> Optional[_VarHolder]:
        return _VarHolder(self, name) if self.has(name) else None

    def has(self, name: str) -> bool:
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return True
            s = s.parent
        return False

    def get(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        raise KeyError(name)

    def set(self, name: str, value) -> None:
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                s._vars[name] = value
                return
            s = s.parent
        self._vars[name] = value

    def new_scope(self) -> "Scope":
        return Scope(self)

    def local_var_names(self) -> List[str]:
        return list(self._vars)


_scope_stack = [Scope()]


def global_scope() -> Scope:
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope: Scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


class _NanMonitor:
    """FLAGS_check_nan_inf without a sync a step: `submit` computes one
    device-side bool per array (non-finite anywhere), copies the flags to
    pinned host memory without blocking and records an event; `poll`
    reads the flags of the runs whose event has passed and raises on the
    first hit; `drain` waits for every event first."""

    def __init__(self):
        self._pending = collections.deque()

    def submit(self, names, arrays, step):
        """`arrays`: the run's float outputs and state, non-empty."""
        maxabs = torch._foreach_norm([a.detach() for a in arrays],
                                     float("inf"))
        bad = ~torch.isfinite(torch.stack([m.float() for m in maxabs]))
        event = None
        if bad.is_cuda:
            host = torch.empty(bad.shape, dtype=torch.bool,
                               pin_memory=True)
            host.copy_(bad, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            bad = host
        self._pending.append((bad, event, list(names), step))

    def _check(self, pending):
        bad, _, names, step = pending
        hits = [n for n, b in zip(names, bad.tolist()) if b]
        if hits:
            self._pending.clear()
            profiler.stat_add("nan_inf_hits_total", len(hits))
            raise RuntimeError(
                f"NaN/Inf detected in variable {hits[0]!r} after "
                f"Executor.run at step {step} (FLAGS_check_nan_inf is set; "
                f"async scan, all hits: {hits})")

    def poll(self):
        while self._pending and (self._pending[0][1] is None
                                 or self._pending[0][1].query()):
            self._check(self._pending.popleft())

    def drain(self):
        while self._pending:
            pending = self._pending.popleft()
            if pending[1] is not None:
                pending[1].synchronize()
            self._check(pending)


class FetchHandler:
    """`handler` receives {name: ndarray} snapshots of `var_dict`'s scope
    vars every `period_secs` while a dataset loop runs."""

    def __init__(self, var_dict=None, period_secs=60):
        assert var_dict is not None
        self.var_dict = var_dict
        self.period_secs = period_secs

    def handler(self, res_dict):
        import sys
        for key, val in res_dict.items():
            if isinstance(val, np.ndarray):
                sys.stdout.write(f"{key}[0]: {val.ravel()[:1]} ")
        sys.stdout.write("\n")


class FetchHandlerMonitor:
    """The thread that drives a FetchHandler: it copies the requested
    scope vars to the host every period and hands them to handler()."""

    def __init__(self, scope, handler):
        self._scope = scope
        self._handler = handler
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while not self._stop.wait(self._handler.period_secs):
            res = {}
            for key, var in self._handler.var_dict.items():
                name = getattr(var, "name", var)
                if self._scope.has(name):
                    val = self._scope.get(name)
                    if isinstance(val, torch.Tensor):
                        res[key] = val.detach().cpu().numpy()
                    elif val is not None:
                        res[key] = np.asarray(val)
            self._handler.handler(res)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


class _StagedFeed:
    """A batch staged for the card by the feed pipeline's producer: the
    feed's tensors are views of one device buffer, filled from one
    pinned host buffer on a side stream, and `done` follows that copy."""

    __slots__ = ("feed", "buffer", "done")

    def __init__(self, feed, buffer, done):
        self.feed, self.buffer, self.done = feed, buffer, done

    def arrive(self, device):
        from ..io import arrive

        arrive(self.buffer, self.done, device)
        return self.feed


def _pack(arrays):
    """One pinned uint8 buffer holding `arrays` (name -> contiguous numpy
    array) at 16-byte offsets: (buffer, [(name, offset, nbytes, dtype,
    shape)])."""
    layout, total = [], 0
    for name, a in arrays.items():
        layout.append((name, total, a.nbytes, a.dtype, a.shape))
        total += -(-a.nbytes // 16) * 16
    buf = torch.empty(max(total, 16), dtype=torch.uint8, pin_memory=True)
    for name, off, n, _, _ in layout:
        if n:
            buf[off:off + n].copy_(torch.from_numpy(
                arrays[name].reshape(-1).view(np.uint8)))
    return buf, layout


def _unpack(buf, layout):
    return {name: buf[off:off + n].view(
        core.torch_dtype(dtype)).reshape(shape)
        for name, off, n, dtype, shape in layout}


def _analyze_block(block, feed_names):
    """The scope vars the block reads before writing them (state inputs),
    and the persistable vars it writes (state outputs); a `while` or
    `conditional_block` op counts what its sub-block reads and writes,
    so a parameter read only inside a loop body is state too."""
    reads_before_write, writes = registry.block_reads_writes(block,
                                                             feed_names)
    persistable_writes = []
    for name in writes:
        try:
            v = block._var_recursive(name)
        except ValueError:
            continue
        if v.persistable:
            persistable_writes.append(name)
    return reads_before_write, persistable_writes


def _last_uses(block, keep) -> List[List[str]]:
    """frees[i]: the names whose last read or write is op i, outside
    `keep` (fetches and state outputs); the run drops them there.  A
    name a sub-block touches is in use until its op's end (an encoder
    output read by every iteration of a loop)."""
    last = {}
    for i, op in enumerate(block.ops):
        r, w = registry.op_reads_writes(op)
        for name in r + w:
            last[name] = i
    frees: List[List[str]] = [[] for _ in block.ops]
    for name, i in last.items():
        if name not in keep:
            frees[i].append(name)
    return frees


def _orphans(block, feed_names, fetch_names, scope) -> set:
    """Indices of the ops a run skips as dead code: an op (not one with
    a sub-block) that reads a var which is not persistable, not fed, not
    in the scope and written by no earlier op, and whose outputs are not
    persistable, not fetched and read by no later op.  In a for_test
    clone of an AMP-decorated program that is the `logical_not` of the
    overflow flag, whose backward writer the clone pruned; the
    reference's Executor drops it in its dead-code pass."""
    rw = [registry.op_reads_writes(op) for op in block.ops]
    written_before = set(feed_names)
    dropped = set()
    for i, op in enumerate(block.ops):
        reads, writes = rw[i]
        missing = op.type not in registry.SUB_BLOCK_OPS and any(
            n not in written_before and not _persistable(block, n)
            and not (scope.has(n) and scope.get(n) is not None)
            for n in reads)
        written_before.update(writes)
        if not missing:
            continue
        later = {n for r, _ in rw[i + 1:] for n in r} | set(fetch_names)
        if not any(n in later or _persistable(block, n) for n in writes):
            dropped.add(i)
    return dropped


def _persistable(block, name) -> bool:
    try:
        return block._var_recursive(name).persistable
    except ValueError:
        return False


class _LiveBlock:
    """A block with the ops a run skips taken out; everything else is
    the block's own."""

    def __init__(self, block, ops):
        self._block = block
        self.ops = ops

    def __getattr__(self, name):
        return getattr(self._block, name)


def run_ops(block, ops, env, seed, device, frees=None) -> None:
    """Run `ops`, a run of `block`'s ops in order, on `env` (var name ->
    tensor), as a step runs the whole block: the compiler's SPMD arm runs
    a step's forward and backward ops on one environment (gathered
    parameters, the rank's rows) and its optimize ops on a second one
    (shards).  `frees[i]` drops names after the i-th op of `ops`."""
    ctx = registry.LowerCtx(seed, device=device)
    with torch.no_grad():
        registry.lower_block(ctx, _LiveBlock(block, list(ops)), env, frees)
    profiler.stat_add("executor_op_count", ctx.ops_run)
    if ctx.host_reads:
        profiler.count_sync(ctx.host_reads)
        profiler.stat_add("control_flow_host_reads", ctx.host_reads)


class _AutoCheckpoint:
    """train_from_dataset's auto-checkpoint (the reference's
    executor.py:482-640): owns the CheckpointManager, the every-N-steps
    or -seconds cadence and the resume.

    Against the dataset's feed-epoch counter (a pass is one epoch):
    - the checkpoint's feed_epoch is this pass's: a mid-epoch resume
      (restore the state and the executor's step, re-deal the epoch,
      skip the consumed batches);
    - it is a later one: this pass ran before the preemption (restore,
      consume the epoch counter, `skip_pass`);
    - it is older than the live in-process state: ignored (a live job
      never moves backwards).

    On the SPMD arm (a CompiledProgram whose scope holds each rank's
    shards) a save names the sharded vars' specs, so the manager gathers
    them whole and records the layout; a resume of a checkpoint that
    records its mesh reads each rank's own shard file, the owners
    broadcast their vars, and every rank seats its slices (the
    reference's `_apply_state` and `_seat_state`)."""

    def __init__(self, exe, program, scope, dataset, manager,
                 every_steps: int, every_secs: float, compiled=None):
        self._exe = exe
        self._program = program
        self._compiled = compiled
        self._scope = scope
        self._dataset = dataset
        self.manager = manager
        self.every_steps = every_steps
        self.every_secs = every_secs
        self.epoch: Optional[int] = None
        self.step_in_epoch = 0
        self.skip_pass = False
        self.restored_from: Optional[str] = None
        self._steps_since_save = 0
        self._last_save_t = time.perf_counter()

    @staticmethod
    def setup(exe, program, scope, dataset, checkpoint_dir, every_steps,
              every_secs, keep, resume, compiled=None
              ) -> Optional["_AutoCheckpoint"]:
        if checkpoint_dir is None:
            checkpoint_dir = flags.flag("ckpt_dir", "") or None
        if not checkpoint_dir:
            return None
        from ..ckpt import CheckpointManager

        every_steps = int(flags.flag("ckpt_every_steps", 0)
                          if every_steps is None else every_steps)
        every_secs = float(flags.flag("ckpt_every_secs", 0.0)
                           if every_secs is None else every_secs)
        resume = bool(flags.flag("ckpt_resume", True)) if resume is None \
            else bool(resume)
        manager = CheckpointManager(checkpoint_dir, keep=keep)
        self = _AutoCheckpoint(exe, program, scope, dataset, manager,
                               every_steps, every_secs, compiled)
        if resume:
            self._try_resume()
        return self

    def _try_resume(self) -> None:
        import warnings

        path = self.manager.latest()
        if path is None:
            return
        manifest = self.manager.read_meta(path)
        meta = manifest.get("meta", {})
        feed_epoch = int(meta.get("feed_epoch", 0))
        ds_next = int(getattr(self._dataset, "_feed_epoch", -1)) + 1
        if feed_epoch < ds_next:
            return  # the live in-process state is ahead of the checkpoint
        state, _ = self.manager.restore(path)
        self._apply_state(state, manifest)
        self._exe._step = int(meta.get("executor_step", 0))
        saved_seed = meta.get("feed_seed")
        live_seed = int(getattr(self._dataset, "_seed", 0))
        if saved_seed is not None and int(saved_seed) != live_seed:
            warnings.warn(
                f"checkpoint {path} was written with feed seed "
                f"{saved_seed}, the dataset uses {live_seed}: the "
                f"resumed data order will NOT match the saved run")
        if feed_epoch > ds_next:
            # this pass ran before the preemption: consume its epoch
            self._dataset._feed_epoch = ds_next
            self.skip_pass = True
        else:
            self.epoch = feed_epoch
            self.step_in_epoch = int(meta.get("step_in_epoch", 0))
        self.restored_from = path
        profiler.stat_add("ckpt_resume_count")

    def _apply_state(self, state, manifest) -> None:
        """Each persistable var of the program that the checkpoint holds,
        in the var's dtype, onto the Executor's device.  An owned-only
        restore (a checkpoint that records its mesh, over several ranks)
        is exchanged first: each var broadcast from its owner, in the
        manifest's order; a var with a spec is seated as this rank's slice
        under the live mesh."""
        from ..parallel import compiler, mesh as mesh_lib, spec_layout

        var_meta = manifest.get("vars", {})
        mesh = mesh_lib.current_mesh()
        if manifest.get("mesh_axes") and len(state) < len(var_meta):
            from ..distributed import comm

            dev = self._exe.device
            for name in sorted(var_meta):
                m = var_meta[name]
                src = state.get(name)
                if src is None:
                    src = torch.zeros(m["shape"],
                                      dtype=getattr(torch, m["dtype"]))
                state[name] = comm.broadcast(src.to(dev), int(m["shard"]))
        persist = {v.name: v for v in self._program.list_vars()
                   if v.persistable}
        for name, val in state.items():
            var = persist.get(name)
            if var is None:
                continue
            val = self._exe._to_device(val.to(core.torch_dtype(var.dtype)))
            spec = var_meta.get(name, {}).get("spec")
            if spec and mesh is not None and manifest.get("mesh_axes"):
                val = compiler.shard_of(val, spec_layout.spec_from_json(spec),
                                        mesh)
            self._scope.set(name, val)

    def bind_epoch(self, dataset) -> None:
        """The feed epoch the pipeline opened."""
        if self.epoch is None:
            self.epoch = int(getattr(dataset, "_feed_epoch", 0) or 0)

    def on_step(self) -> None:
        self.step_in_epoch += 1
        self._steps_since_save += 1
        due = (self.every_steps > 0
               and self._steps_since_save >= self.every_steps)
        if not due and self.every_secs > 0:
            due = (time.perf_counter() - self._last_save_t
                   >= self.every_secs)
        if due:
            self._save_now()

    def on_pass_end(self) -> None:
        """The end-of-pass save; then the writer is drained and stopped,
        raising what it hit."""
        if self._steps_since_save > 0:
            self._save_now()
        self.manager.close()

    def abandon(self) -> None:
        """The loop failed: commit what was enqueued, then stop the
        writer; its errors stand behind the loop's own."""
        try:
            self.manager.close()
        except Exception:  # noqa: BLE001 - the loop's error propagates
            pass

    def _save_now(self) -> None:
        from .io import _persistable_names

        scope, state = self._scope, {}
        for name in _persistable_names(self._program):
            if scope.has(name) and scope.get(name) is not None:
                state[name] = scope.get(name)
        specs = {}
        if self._compiled is not None:
            from ..parallel import compiler

            specs = compiler.sharded_vars(self._compiled, scope)
        self.manager.save_async(state, step=self._exe._step, meta={
            "feed_epoch": int(self.epoch or 0),
            "step_in_epoch": self.step_in_epoch,
            "executor_step": int(self._exe._step),
            "feed_seed": int(getattr(self._dataset, "_seed", 0)),
        }, specs=specs)
        self._steps_since_save = 0
        self._last_save_t = time.perf_counter()


class _Entry:
    """One built block: the callable and the names it reads and writes.
    `program` and `scope` pin the originals, so the id()-based cache key
    can never match a recycled address."""

    __slots__ = ("fn", "mutable_in_names", "const_in_names",
                 "fetch_names", "program", "scope", "const_src",
                 "const_dev")


def _place_device(place) -> torch.device:
    """The Executor's device: the card unless the place names the CPU;
    raises when it names the card and CUDA is absent."""
    if place is None or isinstance(place, (str, torch.device)):
        return resolve(place)
    return resolve(place.device())


class Executor:
    """`Executor(place).run(program, feed, fetch_list)`.  With no place
    it runs on `cuda` (and raises without CUDA); `Executor(CPUPlace())`
    runs on the CPU.  `run`'s `use_program_cache` is accepted, as the
    reference accepts it; every run goes through the cache."""

    CACHE_CAPACITY = 64

    def __init__(self, place=None):
        self.place = place
        self.device = _place_device(place)
        self._cache: CompileCache = CompileCache(
            self.CACHE_CAPACITY, stat_prefix="executor",
            on_evict=self._on_entry_evict)
        self._nan_monitor = _NanMonitor()
        self._copy_stream = None  # the dataset loops' side stream
        self._step = 0
        self._seed_rank = 0  # set by CompiledProgram for its runs

    @staticmethod
    def _on_entry_evict(key, entry: _Entry) -> None:
        entry.const_dev.clear()
        entry.const_src.clear()
        entry.fn = None

    # -- public API --------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True):
        from .compiler import CompiledProgram

        if isinstance(program, CompiledProgram):
            return program._run(self, feed, fetch_list, scope,
                                return_numpy=return_numpy)
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        profiler.stat_add("executor_run_count")
        # a non-finite value of an earlier run whose flags have arrived
        self._nan_monitor.poll()
        feed_arrays = self._normalize_feed(program, feed or {})
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        entry = self._prepare(program, feed_arrays, fetch_names, scope)
        fetches = self._dispatch(entry, scope, feed_arrays)
        return self._finish(fetches, entry, return_numpy)

    def _next_seed(self, program) -> int:
        """The step seed (the reference's `_next_seed`): reproducible
        across runs of a script with a fixed program.random_seed, and
        advancing per step."""
        if program.random_seed:
            base = (program.random_seed * 1000003 + self._step) & 0xFFFFFFFF
        else:
            base = (self._step * 2 + 1) & 0xFFFFFFFF
        self._step += 1
        if self._seed_rank:
            # a data-parallel run (CompiledProgram): each rank draws its
            # own masks, as the reference folds the data-axis index into
            # each shard's key; rank 0 keeps the one-process seed
            base = (base ^ (self._seed_rank * 0x9E3779B1)) & 0xFFFFFFFF
        return base

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type == self.device.type and self.device.index in (
                None, t.device.index):
            return t
        if self.device.type == "cuda" and t.device.type == "cpu":
            # staged through pinned memory: an asynchronous copy
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _normalize_feed(self, program, feed) -> Dict[str, torch.Tensor]:
        with profiler.timed("host_feed_ms"):
            out = {}
            block = program.global_block()
            for name, val in feed.items():
                if isinstance(val, core.LoDTensor):
                    val = val._array
                if isinstance(val, (_VarHolder, LazyFetch)):
                    val = val.numpy()
                if not isinstance(val, torch.Tensor):
                    val = torch.from_numpy(np.ascontiguousarray(val))
                self._check_feed_shape(block, name, tuple(val.shape))
                if block.has_var(name):
                    want = core.torch_dtype(block.var(name).dtype)
                    if val.dtype != want:
                        val = val.to(want)
                out[name] = self._to_device(val)
            return out

    @staticmethod
    def _check_feed_shape(block, name, shape):
        """Rank and shape against the declared var (-1 = any)."""
        if not block.has_var(name):
            return
        declared = list(block.var(name).shape or [])
        if declared and len(declared) != len(shape):
            raise ValueError(
                f"feed {name!r}: rank mismatch — variable declared with "
                f"shape {declared} (rank {len(declared)}), fed array has "
                f"shape {list(shape)} (rank {len(shape)})")
        if declared and any(d != -1 and d != s
                            for d, s in zip(declared, shape)):
            raise ValueError(
                f"feed {name!r}: shape mismatch — variable declared "
                f"{declared} (-1 = any), fed {list(shape)}")

    def _prepare(self, program: Program, feed_arrays, fetch_names,
                 scope: Scope) -> _Entry:
        feed_sig = tuple(sorted((n, tuple(a.shape), str(a.dtype))
                                for n, a in feed_arrays.items()))
        key = (id(program), program.version, feed_sig, tuple(fetch_names),
               id(scope))
        entry = self._cache.get(key)
        if entry is None:
            profiler.stat_add("executor_compile_count")
            entry = self._build(program, feed_arrays, fetch_names, scope)
            self._cache.put(key, entry)
        return entry

    def _build(self, program: Program, feed_arrays, fetch_names,
               scope: Scope) -> _Entry:
        flags.check_unported(flags.COMPILE_FLAGS)
        block = program.global_block()
        dead = _orphans(block, feed_arrays.keys(), fetch_names, scope)
        if dead:
            block = _LiveBlock(block, [op for i, op in enumerate(block.ops)
                                       if i not in dead])
        reads, persistable_writes = _analyze_block(block, feed_arrays.keys())
        for name in reads:
            if not scope.has(name) or scope.get(name) is None:
                raise RuntimeError(
                    f"variable {name!r} is read by the program but is "
                    f"neither fed nor initialized in the scope (did you "
                    f"run the startup program?)")
        writes = set(persistable_writes)
        mutable_out = sorted(writes)
        frees = _last_uses(block, set(fetch_names) | writes)
        device = self.device

        def step_fn(mutable_state, const_state, feeds, seed):
            env: Dict[str, Any] = {}
            env.update(const_state)
            env.update(mutable_state)
            env.update(feeds)
            run_ops(block, block.ops, env, seed, device, frees)
            fetches = [env[n] for n in fetch_names]
            new_state = {n: env[n] for n in mutable_out if n in env}
            return fetches, new_state

        entry = _Entry()
        entry.fn = step_fn
        entry.program = program
        entry.scope = scope
        entry.mutable_in_names = sorted(n for n in reads if n in writes)
        entry.const_in_names = sorted(n for n in reads if n not in writes)
        entry.fetch_names = list(fetch_names)
        entry.const_src = {}
        entry.const_dev = {}
        return entry

    def _as_device_tensor(self, v) -> torch.Tensor:
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v))
        return self._to_device(v)

    def _const_state(self, entry: _Entry, scope: Scope):
        """Vars the program reads but never writes, moved to the device
        once per entry and reused by identity; a new value committed to
        the scope refreshes the device copy."""
        src, dev = entry.const_src, entry.const_dev
        for n in entry.const_in_names:
            v = scope.get(n)
            if src.get(n) is not v:
                src[n] = v
                dev[n] = self._as_device_tensor(v)
        return dev

    def _dispatch(self, entry: _Entry, scope: Scope, feed_arrays):
        """Gather the state, run the step, commit the new state.  Never
        reads a device value back."""
        t0 = time.perf_counter()
        mutable_state = {n: self._as_device_tensor(scope.get(n))
                         for n in entry.mutable_in_names}
        const_state = self._const_state(entry, scope)
        step = self._step
        seed = self._next_seed(entry.program)
        fetches, new_state = entry.fn(mutable_state, const_state,
                                      feed_arrays, seed)
        if flags.flag("check_nan_inf"):
            # the reference's order: the state written, then the fetches
            checked = [(n, v) for n, v in list(new_state.items())
                       + list(zip(entry.fetch_names, fetches))
                       if v.is_floating_point() and v.numel()]
            if checked:
                self._nan_monitor.submit([n for n, _ in checked],
                                         [v for _, v in checked], step)
        for name, val in new_state.items():
            scope.set(name, val)
        profiler.time_add("dispatch_ms", (time.perf_counter() - t0) * 1e3)
        return fetches

    def _finish(self, fetches, entry: _Entry, return_numpy):
        if return_numpy:
            with profiler.timed("sync_ms"):
                profiler.count_sync(len(fetches))
                return [f.detach().cpu().numpy() for f in fetches]
        return [LazyFetch(f, n) for n, f in zip(entry.fetch_names, fetches)]

    def sync(self):
        """Wait for the non-finite flags of every run so far and raise on
        a hit; fetches are not read."""
        self._nan_monitor.drain()

    def close(self):
        self._nan_monitor.drain()
        self._cache.clear()

    # -- the dataset loops ---------------------------------------------------
    def _stage_feed(self, program, feed):
        """A host batch made ready for `run` on the producer thread: each
        array checked against its var and cast to its dtype on the host;
        for the card, all of them packed into one pinned buffer and copied
        with one non-blocking copy on `self._copy_stream`."""
        with profiler.timed("host_feed_ms"):
            block = program.global_block()
            host = {}
            for name, val in feed.items():
                a = np.asarray(val)
                self._check_feed_shape(block, name, a.shape)
                if block.has_var(name):
                    a = a.astype(dataset_np_dtype(block.var(name)),
                                 copy=False)
                host[name] = np.ascontiguousarray(a)
            if self.device.type != "cuda":
                return {n: torch.from_numpy(a) for n, a in host.items()}
            from ..io import copy_ahead

            buf, layout = _pack(host)
            dev_buf, done = copy_ahead(buf, self.device, self._copy_stream)
            return _StagedFeed(_unpack(dev_buf, layout), dev_buf, done)

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None, prefetch_depth=None,
                           checkpoint_dir=None,
                           checkpoint_every_steps=None,
                           checkpoint_every_secs=None,
                           checkpoint_keep=None, resume=None,
                           step_callback=None):
        """Run `program` (or a CompiledProgram) once a batch over one pass
        of `dataset` (the reference's executor.py:900-1060).

        A FeedPipeline stages batch N+1..N+K while step N runs; `thread`
        sizes the dataset's parser pool.  Each step dispatches with lazy
        fetches and records a CUDA event; once more than
        `prefetch_depth` (default PADDLE_PREFETCH_DEPTH, 2) steps are in
        flight, the host waits on the oldest step's event (no device to
        host read).  With `debug`, the fetches are read and printed
        every `print_period` steps; `fetch_handler` (a FetchHandler) gets
        scope snapshots on its own thread; `step_callback(step,
        step_in_epoch, fetches)` runs after each step with LazyFetch
        handles.  The NaN monitor is drained at the loop's exit.  Returns
        the last step's fetches as numpy (None for an empty pass).

        Auto-checkpointing: with `checkpoint_dir` (or FLAGS_ckpt_dir /
        PADDLE_CKPT_DIR) the loop saves async checkpoints at step
        boundaries, every `checkpoint_every_steps` steps and/or
        `checkpoint_every_secs` seconds and once at the pass's end, keeps
        `checkpoint_keep` of them, and with `resume` (default on) first
        restores the newest: the scope's persistables, the executor's
        step, and the feed order's place (the manifest's feed_epoch and
        step_in_epoch; the consumed batches are skipped), so a run killed
        at a step boundary and resumed gives the uninterrupted run's
        losses.  `step_callback`'s second argument is then the step in
        the epoch.  The telemetry flags (FLAGS_obs_*) wait for ROADMAP
        queue 1 item 13."""
        flags.check_unported(flags.LOOP_FLAGS)
        return self._dataset_loop(program, dataset, scope, thread, debug,
                                  fetch_list, fetch_info, print_period,
                                  fetch_handler, prefetch_depth,
                                  step_callback, dict(
                                      checkpoint_dir=checkpoint_dir,
                                      every_steps=checkpoint_every_steps,
                                      every_secs=checkpoint_every_secs,
                                      keep=checkpoint_keep, resume=resume))

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None, prefetch_depth=None,
                           step_callback=None):
        """train_from_dataset's loop over a program without optimizer ops
        (the reference's infer_from_dataset takes the first eight
        arguments; the port also takes the loop's last three)."""
        return self._dataset_loop(program, dataset, scope, thread, debug,
                                  fetch_list, fetch_info, print_period,
                                  fetch_handler, prefetch_depth,
                                  step_callback)

    def _dataset_loop(self, program, dataset, scope, thread, debug,
                      fetch_list, fetch_info, print_period, fetch_handler,
                      prefetch_depth, step_callback, checkpoint=None):
        from ..dataset.feed_pipeline import DEFAULT_PREFETCH_DEPTH, \
            FeedPipeline
        from .compiler import CompiledProgram

        if dataset is None:
            raise ValueError("train_from_dataset needs a dataset")
        if thread:
            dataset.set_thread(thread)
        fetch_list = fetch_list or []
        fetch_info = fetch_info or [getattr(v, "name", str(v))
                                    for v in fetch_list]
        depth = DEFAULT_PREFETCH_DEPTH if prefetch_depth is None \
            else max(1, int(prefetch_depth))
        program = program if program is not None else \
            default_main_program()
        block_program = program._program if isinstance(
            program, CompiledProgram) else program
        scope = scope if scope is not None else global_scope()
        ckpt = None if checkpoint is None else _AutoCheckpoint.setup(
            self, block_program, scope, dataset, **checkpoint,
            compiled=program if isinstance(program, CompiledProgram)
            else None)
        if ckpt is not None and ckpt.skip_pass:
            ckpt.manager.close()
            return None  # this pass ran before the checkpoint was taken
        cuda = self.device.type == "cuda"
        if cuda and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        monitor = None
        if fetch_handler is not None:
            monitor = FetchHandlerMonitor(scope, fetch_handler)
            monitor.start()
        step, last = 0, None
        in_flight = collections.deque()
        batches = iter(FeedPipeline(
            lambda f: self._stage_feed(block_program, f), dataset,
            depth=depth, epoch=None if ckpt is None else ckpt.epoch,
            skip_batches=0 if ckpt is None else ckpt.step_in_epoch))
        if ckpt is not None:
            ckpt.bind_epoch(dataset)
        try:
            for staged in batches:
                feed = staged.arrive(self.device) if isinstance(
                    staged, _StagedFeed) else staged
                outs = self.run(program, feed=feed, fetch_list=fetch_list,
                                scope=scope, return_numpy=False)
                last = outs
                step += 1
                if cuda:
                    done = torch.cuda.Event()
                    done.record()
                    in_flight.append(done)
                    profiler.stat_set("in_flight_steps", len(in_flight))
                    profiler.stat_max("in_flight_steps_max", len(in_flight))
                    if len(in_flight) > depth:
                        # the host runs at most `depth` steps ahead
                        in_flight.popleft().synchronize()
                if ckpt is not None:
                    ckpt.on_step()
                if step_callback is not None:
                    step_callback(self._step, step if ckpt is None
                                  else ckpt.step_in_epoch, outs)
                if debug and fetch_list and step % print_period == 0:
                    msg = ", ".join(f"{n}={o.numpy().ravel()[:1]}"
                                    for n, o in zip(fetch_info, outs))
                    print(f"[train_from_dataset] step {step}: {msg}")
        except BaseException:
            if ckpt is not None:
                ckpt.abandon()
            raise
        finally:
            batches.close()  # stops the producer, on an error too
            profiler.stat_set("in_flight_steps", 0)
            if monitor is not None:
                monitor.stop()
        if ckpt is not None:
            ckpt.on_pass_end()
        self._nan_monitor.drain()
        return None if last is None else [h.numpy() for h in last]
