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

The callable runs eagerly, op by op: capturing it in a CUDA graph or
compiling it is not ported, nor are train_from_dataset, the AOT cache,
the NaN monitor, numerics and CompiledProgram.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import profiler
from ..device import resolve
from ..ops import registry
from . import core
from .compile_cache import CompileCache
from .framework import EMPTY_VAR_NAME, Program, Variable, \
    default_main_program


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
        self._step = 0

    @staticmethod
    def _on_entry_evict(key, entry: _Entry) -> None:
        entry.const_dev.clear()
        entry.const_src.clear()
        entry.fn = None

    # -- public API --------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True):
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        profiler.stat_add("executor_run_count")
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
            ctx = registry.LowerCtx(seed, device=device)
            with torch.no_grad():
                registry.lower_block(ctx, block, env, frees)
            profiler.stat_add("executor_op_count", ctx.ops_run)
            if ctx.host_reads:
                profiler.count_sync(ctx.host_reads)
                profiler.stat_add("control_flow_host_reads", ctx.host_reads)
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
        seed = self._next_seed(entry.program)
        fetches, new_state = entry.fn(mutable_state, const_state,
                                      feed_arrays, seed)
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

    def close(self):
        self._cache.clear()
