"""CheckpointManager: snapshot-consistent, async checkpoints (counterpart
of paddle_tpu/ckpt/manager.py).

The save path is split across two threads so that checkpointing overlaps
training:

* **Training thread** (`save_async`): snapshot the state and hand it to
  the `WriterPool`.  A CUDA tensor's snapshot is a copy into pinned host
  memory on the manager's side stream: the side stream first waits for
  the current stream (the copy sees the finished step), the copies are
  enqueued without blocking, an event is recorded after them, and the
  current stream waits on that event, so the next step's work (an
  optimizer's in-place `_foreach_*` update too) is ordered after the
  copy.  The host does not wait: the step returns after the enqueue.
  A CPU tensor or array is cloned on the spot.  The only stall the loop
  sees is this enqueue, plus backpressure when `max_in_flight` snapshots
  are pending (`ckpt_stall_ms`).
* **Writer thread** (`_write_job`): wait on the snapshot's event, write
  `shard_00000.npz`, fsync, write the manifest last, fsync, and publish
  the tmp dir with one atomic rename (`ckpt.manifest`).  Then remove
  checkpoints older than `keep` and any tmp dirs a killed run left.
  The pinned buffers come from PyTorch's caching host allocator, which
  keeps them when a write is done, so a steady cadence allocates no new
  pinned memory.

Counters: `ckpt_stall_ms` (the training thread's enqueue and
backpressure), `ckpt_copy_ms` (the device time of the snapshots' copies,
between two timed events on the side stream), `ckpt_save_ms` (the writer
thread a job), `ckpt_snapshot_bytes` (bytes copied but not yet written),
`ckpt_snapshots_total`, `ckpt_saves_total`, `ckpt_gc_count`,
`ckpt_restore_count`.

One process: `process_count` above 1 raises NotImplementedError until
ROADMAP queue 1 item 10b (ii) brings per-host shards and their barrier, so
the rendezvous before the commit has nothing to wait for, and the
manifest records no mesh axes.  Restore returns `(state, manifest)` with every value a CPU
tensor of the manifest's dtype; it refuses partial checkpoints and (with
`strict_topology`) ones written by another process count.
"""

from __future__ import annotations

import os
import shutil
import time
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import obs, profiler
from . import manifest as mf
from .manifest import CheckpointError
from .writer import WriterPool

MULTI_PROCESS = ("checkpoints over more than one process (per-host shards "
                 "and their barrier) wait for ROADMAP queue 1 item 10b (ii)")


def _host_topology(process_index, process_count) -> Tuple[int, int]:
    from ..dataset.feed_pipeline import host_topology

    index, count = host_topology(process_index, process_count)
    if count > 1:
        raise NotImplementedError(f"{count} processes: {MULTI_PROCESS}")
    return index, count


def _barrier(count: int, tag: str) -> None:
    """Rendezvous before the commit: a no-op for one process (more are
    refused by `_host_topology`)."""
    if count > 1:
        raise NotImplementedError(f"{tag}: {MULTI_PROCESS}")


def _var_meta(name: str, val, shard: int) -> Dict[str, Any]:
    return {"shape": list(val.shape), "dtype": mf.dtype_name(val),
            "shard": shard}


class _Snapshot:
    """A step's state on the host, or on its way there: `values` are CPU
    tensors (pinned ones for the card's) or arrays; `start` and `event`
    (CUDA, timed) bracket the copies into the pinned ones."""

    __slots__ = ("values", "start", "event", "nbytes")

    def __init__(self):
        self.values: Dict[str, Any] = {}
        self.start = None
        self.event = None
        self.nbytes = 0


class CheckpointManager:
    """Async checkpoint writer and reader for one checkpoint root."""

    def __init__(self, root: str, keep: Optional[int] = None,
                 max_in_flight: Optional[int] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        from ..fluid.flags import flag

        self.root = os.path.abspath(root)
        self.keep = int(flag("ckpt_keep", 3) if keep is None else keep)
        self._index, self._count = _host_topology(process_index,
                                                  process_count)
        mif = int(flag("ckpt_max_in_flight", 2)
                  if max_in_flight is None else max_in_flight)
        self._pool = WriterPool(max_in_flight=mif)
        self._side = {}  # device -> the snapshot copies' stream
        os.makedirs(self.root, exist_ok=True)

    # -- save (training thread) ----------------------------------------------
    def save_async(self, state: Dict[str, Any], step: int,
                   meta: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot `state` at this step boundary and return; the write
        happens on the writer thread."""
        flow = obs.TRACER.new_flow() if obs.TRACER.enabled else 0
        with obs.span("ckpt.snapshot", flow=flow), \
                profiler.timed("ckpt_stall_ms"):
            snap, var_meta = self._snapshot(state)
        job_meta = dict(meta or {})
        step = int(step)
        profiler.stat_add("ckpt_snapshot_bytes", snap.nbytes)
        self._pool.submit(
            lambda: self._write_job(snap, var_meta, step, job_meta),
            flow=flow)
        profiler.stat_add("ckpt_snapshots_total")

    def save(self, state: Dict[str, Any], step: int,
             meta: Optional[Dict[str, Any]] = None) -> str:
        """Synchronous save: snapshot, write, commit; returns the committed
        checkpoint's path."""
        self.save_async(state, step, meta)
        self.wait()
        return os.path.join(self.root, mf.checkpoint_dir_name(step))

    def _snapshot(self, state: Dict[str, Any]):
        """This step's copy of `state` (see the module's docstring) and
        the manifest's description of every var."""
        assignment = mf.shard_assignment(state.keys(), self._count)
        snap, var_meta, on_card = _Snapshot(), {}, []
        for name in sorted(state):
            val = state[name]
            if val is None:
                continue
            if not isinstance(val, torch.Tensor):
                val = np.array(val)
            var_meta[name] = _var_meta(name, val, assignment[name])
            if assignment[name] != self._index:
                continue
            if isinstance(val, torch.Tensor) and val.is_cuda:
                on_card.append((name, val.detach()))
            elif isinstance(val, torch.Tensor):
                snap.values[name] = val.detach().clone()
            else:
                snap.values[name] = val
        if on_card:
            dev = on_card[0][1].device
            side = self._side.get(dev)
            if side is None:
                side = self._side[dev] = torch.cuda.Stream(dev)
            # every pinned buffer first (an allocation may wait on the
            # device), so that the copies run back to back
            hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for _, t in on_card]
            cur = torch.cuda.current_stream(dev)
            side.wait_stream(cur)
            snap.start = torch.cuda.Event(enable_timing=True)
            snap.start.record(side)
            with torch.cuda.stream(side):
                for (name, t), host in zip(on_card, hosts):
                    host.copy_(t, non_blocking=True)
                    t.record_stream(side)
                    snap.values[name] = host
                    snap.nbytes += t.numel() * t.element_size()
            snap.event = torch.cuda.Event(enable_timing=True)
            snap.event.record(side)
            # the next step (an in-place update too) runs after the copy
            cur.wait_event(snap.event)
        return snap, var_meta

    # -- write (writer thread) -----------------------------------------------
    def _write_job(self, snap: _Snapshot, var_meta, step: int,
                   meta: Dict[str, Any]) -> None:
        tmp = os.path.join(self.root, mf.tmp_dir_name(step))
        os.makedirs(tmp, exist_ok=True)
        try:
            if snap.event is not None:
                snap.event.synchronize()
                profiler.time_add("ckpt_copy_ms",
                                  snap.start.elapsed_time(snap.event))
            arrays = {mf.encode_name(k): mf.to_numpy(v)
                      for k, v in snap.values.items()}
            mf.write_npz_atomic(os.path.join(tmp,
                                             mf.shard_file(self._index)),
                                arrays)
        finally:
            profiler.stat_add("ckpt_snapshot_bytes", -snap.nbytes)
            snap.values.clear()  # the pinned buffers go back to the cache
        _barrier(self._count, f"ckpt-shards-{step}")
        mf.write_manifest(tmp, {
            "format": mf.MANIFEST_FORMAT,
            "step": step,
            "time": time.time(),
            "process_count": self._count,
            "shards": [mf.shard_file(i) for i in range(self._count)],
            "vars": var_meta,
            "flag_signature": mf.flag_signature(),
            "meta": meta,
        })
        final = os.path.join(self.root, mf.checkpoint_dir_name(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish: manifest exists => complete
        mf.fsync_dir(self.root)
        profiler.stat_add("ckpt_saves_total")
        self._gc(step)

    def _gc(self, committed_step: int) -> None:
        """Keep the newest `keep` complete checkpoints; remove tmp dirs
        (a SIGKILL in a write leaves one) no newer than the commit."""
        done = mf.list_checkpoints(self.root)
        for _, path in done[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(path, ignore_errors=True)
            profiler.stat_add("ckpt_gc_count")
        for name in os.listdir(self.root):
            if not name.startswith(mf.TMP_PREFIX):
                continue
            try:
                stale_step = int(name[len(mf.TMP_PREFIX):])
            except ValueError:
                continue
            if stale_step <= committed_step:
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
                profiler.stat_add("ckpt_gc_count")

    # -- lifecycle -----------------------------------------------------------
    def wait(self) -> None:
        """Drain in-flight writes; re-raises writer-thread errors."""
        self._pool.wait()

    def close(self) -> None:
        self._pool.close()

    @property
    def in_flight(self) -> int:
        return self._pool.in_flight

    # -- restore -------------------------------------------------------------
    def latest(self) -> Optional[str]:
        return mf.latest_checkpoint(self.root)

    def read_meta(self, path: str) -> Dict[str, Any]:
        """Manifest of one committed checkpoint (no array loads)."""
        manifest = mf.read_manifest(path)
        mf.validate_complete(path, manifest)
        return manifest

    def restore(self, path: Optional[str] = None,
                strict_topology: bool = True
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """`(state, manifest)` from `path` (default: the newest complete
        checkpoint under the root).  Refuses partial checkpoints and, with
        `strict_topology`, ones written by another process count."""
        if path is None:
            path = self.latest()
            if path is None:
                raise CheckpointError(
                    f"{self.root}: no complete checkpoint to restore")
        manifest = self.read_meta(path)
        saved_count = int(manifest.get("process_count", 1))
        if strict_topology and saved_count != self._count:
            raise CheckpointError(
                f"{path}: topology mismatch — checkpoint was written by "
                f"{saved_count} host(s), this job runs {self._count}; "
                f"per-host shards do not re-deal across host counts "
                f"(restore with strict_topology=False to load weights "
                f"only, e.g. for serving reload)")
        state = _load_shards(path, manifest)
        sig, saved_sig = mf.flag_signature(), manifest.get(
            "flag_signature", "")
        if saved_sig and saved_sig != sig:
            warnings.warn(
                f"checkpoint {path} was written under different flags "
                f"({saved_sig} vs {sig}); the resumed numerics may not "
                f"match the saved run")
        profiler.stat_add("ckpt_restore_count")
        return state, manifest


def _load_shards(path: str, manifest: Dict[str, Any]
                 ) -> Dict[str, torch.Tensor]:
    """Every shard file merged into one state dict of CPU tensors."""
    var_meta = manifest.get("vars", {})
    state: Dict[str, torch.Tensor] = {}
    for shard in manifest.get("shards", []):
        with np.load(os.path.join(path, shard)) as data:
            for key in data.files:
                name = mf.decode_name(key)
                arr = data[key]
                meta = var_meta.get(name)
                state[name] = mf.to_torch(
                    arr, meta["dtype"] if meta else str(arr.dtype))
    missing = [n for n in var_meta if n not in state]
    if missing:
        raise CheckpointError(
            f"{path}: partial checkpoint — manifest describes vars "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''} that no "
            f"shard contains; refusing to load partial state")
    return state


# -- single-directory state API (io.checkpoint rides this) -------------------

def write_state(path: str, state: Dict[str, Any],
                meta: Optional[Dict[str, Any]] = None,
                process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> None:
    """Atomically write one checkpoint AT `path` (the directory itself):
    the manager's shard / manifest / commit protocol, no retention.
    Values: tensors on any device, or arrays."""
    index, count = _host_topology(process_index, process_count)
    path = os.path.abspath(path)
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f"{mf.TMP_PREFIX}{os.path.basename(path)}")
    os.makedirs(tmp, exist_ok=True)
    assignment = mf.shard_assignment(state.keys(), count)
    var_meta, arrays = {}, {}
    for name in sorted(state):
        val = state[name]
        if val is None:
            continue
        if not isinstance(val, torch.Tensor):
            val = np.asarray(val)
        var_meta[name] = _var_meta(name, val, assignment[name])
        if assignment[name] == index:
            arrays[mf.encode_name(name)] = mf.to_numpy(val)
    mf.write_npz_atomic(os.path.join(tmp, mf.shard_file(index)), arrays)
    _barrier(count, f"ckpt-state-{os.path.basename(path)}")
    mf.write_manifest(tmp, {
        "format": mf.MANIFEST_FORMAT,
        "step": -1,
        "time": time.time(),
        "process_count": count,
        "shards": [mf.shard_file(i) for i in range(count)],
        "vars": var_meta,
        "flag_signature": mf.flag_signature(),
        "meta": dict(meta or {}),
    })
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    mf.fsync_dir(parent)


def read_state(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """`(state, manifest)` from a state dir written by `write_state` or
    from a checkpoint root or step dir (given a root, its newest complete
    checkpoint).  Topology is not checked: the weights-only path (serving
    reload, tools)."""
    path = os.path.abspath(path)
    if not os.path.isfile(os.path.join(path, mf.MANIFEST_FILE)):
        newest = mf.latest_checkpoint(path)
        if newest is None:
            raise CheckpointError(
                f"{path}: neither a committed checkpoint (no "
                f"{mf.MANIFEST_FILE}) nor a checkpoint root with a "
                f"complete child checkpoint")
        path = newest
    manifest = mf.read_manifest(path)
    mf.validate_complete(path, manifest)
    return _load_shards(path, manifest), manifest
