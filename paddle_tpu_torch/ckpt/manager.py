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
  this host's `shard_<index>.npz`, fsync, meet the other hosts (every
  shard on disk before the manifest names it), and on host 0 write the
  manifest last, fsync, and publish the tmp dir with one atomic rename
  (`ckpt.manifest`).  Then remove checkpoints older than `keep` and any
  tmp dirs a killed run left.
  The pinned buffers come from PyTorch's caching host allocator, which
  keeps them when a write is done, so a steady cadence allocates no new
  pinned memory.

Counters: `ckpt_stall_ms` (the training thread's enqueue and
backpressure), `ckpt_copy_ms` (the device time of the snapshots' copies,
between two timed events on the side stream), `ckpt_save_ms` (the writer
thread a job), `ckpt_snapshot_bytes` (bytes copied but not yet written),
`ckpt_snapshots_total`, `ckpt_saves_total`, `ckpt_gc_count`,
`ckpt_restore_count`.

Several processes (the reference's per-host shards): host i (the
group's rank, or `process_index`) writes `shard_<i>.npz` holding the
whole vars that `manifest.shard_assignment` deals to it, host 0 commits.
A var laid out over the mesh arrives as this rank's shard: a DTensor
(its placements) or a tensor named in `save_async`'s `specs` (the SPMD
arm's scope).  Every rank gathers each such var in one fixed order (by
name) on the training thread, its owner keeps the whole, and the
manifest records its `spec` and, when some var has one, the live
`mesh_axes`.  The hosts meet before the commit through the group's store
(`comm.store_barrier`), not a collective: the writer thread's rendezvous
cannot then fall out of step with the training thread's collectives.
Without a live group the rendezvous is a no-op (a mocked topology).  So a
checkpoint written by the port is read by `paddle_tpu.ckpt` and the
other way round.

Restore returns `(state, manifest)` with every value a CPU tensor of the
manifest's dtype; it refuses partial checkpoints and (with
`strict_topology`) ones written by another process count or under other
mesh axes, naming both.  A checkpoint that records its mesh axes, restored
by as many processes, is read owned-shards-only: each host reads only its
own file (`_AutoCheckpoint` exchanges them so that every rank seats its
slices).  `strict_topology=False` loads the weights whatever the
topology.
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

def _host_topology(process_index, process_count) -> Tuple[int, int]:
    from ..dataset.feed_pipeline import host_topology

    return host_topology(process_index, process_count)


def _current_mesh_axes() -> Optional[Dict[str, int]]:
    """{axis: size} of the current mesh (parallel/mesh.current_mesh), or
    None outside one: the manifest records it, and restore checks it."""
    from ..parallel import mesh as mesh_lib

    m = mesh_lib.current_mesh()
    if m is None:
        return None
    return {str(k): int(v) for k, v in m.shape.items()}


def _barrier(count: int, tag: str) -> None:
    """Rendezvous before host 0 commits: every shard on (shared) disk
    before the manifest names it.  One process, or no live group (a
    mocked topology): a no-op."""
    from ..distributed import comm

    if count > 1 and comm.live():
        comm.store_barrier(tag, count)


def _var_meta(name: str, val, shard: int) -> Dict[str, Any]:
    return {"shape": list(val.shape), "dtype": mf.dtype_name(val),
            "shard": shard}


def _whole(val, spec):
    """(the whole tensor, its spec or None) of a value laid out over the
    mesh: a DTensor by its placements, a tensor named in `specs` (this
    rank's shard) by gathering over the current mesh; else (val, None).
    Every rank calls this for the same vars in the same order."""
    from torch.distributed.tensor import DTensor

    from ..parallel import spec_layout

    if isinstance(val, DTensor):
        sp = spec_layout.spec_from_placements(
            val.placements, val.device_mesh.mesh_dim_names)
        return val.full_tensor(), (sp if tuple(sp) else None)
    if spec is not None and tuple(spec):
        from ..parallel import compiler, mesh as mesh_lib

        return compiler.gather_full(val, spec,
                                    mesh_lib.current_mesh()), spec
    return val, None


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
                   meta: Optional[Dict[str, Any]] = None,
                   specs: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot `state` at this step boundary and return; the write
        happens on the writer thread.  `specs` maps the names of the
        values that are this rank's shards over the current mesh to their
        PartitionSpecs (a DTensor carries its own)."""
        flow = obs.TRACER.new_flow() if obs.TRACER.enabled else 0
        with obs.span("ckpt.snapshot", flow=flow), \
                profiler.timed("ckpt_stall_ms"):
            snap, var_meta = self._snapshot(state, specs or {})
        job_meta = dict(meta or {})
        step = int(step)
        # the layout, read on the training thread: the writer records the
        # topology the snapshot was taken under
        mesh_axes = _current_mesh_axes()
        profiler.stat_add("ckpt_snapshot_bytes", snap.nbytes)
        self._pool.submit(
            lambda: self._write_job(snap, var_meta, step, job_meta,
                                    mesh_axes),
            flow=flow)
        profiler.stat_add("ckpt_snapshots_total")

    def save(self, state: Dict[str, Any], step: int,
             meta: Optional[Dict[str, Any]] = None,
             specs: Optional[Dict[str, Any]] = None) -> str:
        """Synchronous save: snapshot, write, commit; returns the committed
        checkpoint's path."""
        self.save_async(state, step, meta, specs)
        self.wait()
        return os.path.join(self.root, mf.checkpoint_dir_name(step))

    def _snapshot(self, state: Dict[str, Any], specs: Dict[str, Any]):
        """This host's copy of its vars of `state` (see the module's
        docstring) and the manifest's description of every var."""
        from ..parallel import spec_layout

        assignment = mf.shard_assignment(state.keys(), self._count)
        snap, var_meta, on_card = _Snapshot(), {}, []
        for name in sorted(state):  # one collective order on every rank
            val = state[name]
            if val is None:
                continue
            if not isinstance(val, torch.Tensor):
                val = np.array(val)
                spec = None
            else:
                val, spec = _whole(val, specs.get(name))
            var_meta[name] = _var_meta(name, val, assignment[name])
            if spec is not None:
                var_meta[name]["spec"] = spec_layout.spec_to_json(spec)
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
                   meta: Dict[str, Any],
                   mesh_axes: Optional[Dict[str, int]] = None) -> None:
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
        _barrier(self._count, f"ckpt-shards:{self.root}:{step}")
        if self._index == 0:
            self._commit(tmp, var_meta, step, meta, mesh_axes)
        # host 0 commits; every host returns once the checkpoint is
        # published (so that a synchronous save reads back on each)
        _barrier(self._count, f"ckpt-commit:{self.root}:{step}")
        profiler.stat_add("ckpt_saves_total")

    def _commit(self, tmp, var_meta, step, meta, mesh_axes) -> None:
        """Host 0: the manifest written last, the tmp dir published, the
        retention applied."""
        manifest = {
            "format": mf.MANIFEST_FORMAT,
            "step": step,
            "time": time.time(),
            "process_count": self._count,
            "shards": [mf.shard_file(i) for i in range(self._count)],
            "vars": var_meta,
            "flag_signature": mf.flag_signature(),
            "meta": meta,
        }
        # the layout only where the state is laid out (some var carries a
        # spec): a replicated checkpoint keeps the merge-all format
        if mesh_axes and any("spec" in m for m in var_meta.values()):
            manifest["mesh_axes"] = mesh_axes
        mf.write_manifest(tmp, manifest)
        final = os.path.join(self.root, mf.checkpoint_dir_name(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish: manifest exists => complete
        mf.fsync_dir(self.root)
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
        `strict_topology`, ones written by another process count or under
        other mesh axes; a checkpoint that records its mesh axes, restored
        by as many processes (more than one), loads this host's own shard
        file only."""
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
        saved_axes = manifest.get("mesh_axes")
        live_axes = _current_mesh_axes()
        if strict_topology and saved_axes and live_axes \
                and dict(saved_axes) != dict(live_axes):
            raise CheckpointError(
                f"{path}: topology mismatch — checkpoint expects mesh "
                f"axes {dict(saved_axes)}, found {dict(live_axes)}; the "
                f"recorded partition layout does not re-seat across mesh "
                f"shapes (restore with strict_topology=False to load "
                f"weights only)")
        owned_only = bool(saved_axes) and strict_topology \
            and saved_count == self._count and self._count > 1
        state = _load_shards(path, manifest,
                             self._index if owned_only else None)
        sig, saved_sig = mf.flag_signature(), manifest.get(
            "flag_signature", "")
        if saved_sig and saved_sig != sig:
            warnings.warn(
                f"checkpoint {path} was written under different flags "
                f"({saved_sig} vs {sig}); the resumed numerics may not "
                f"match the saved run")
        profiler.stat_add("ckpt_restore_count")
        return state, manifest


def _load_shards(path: str, manifest: Dict[str, Any],
                 index: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Every shard file merged into one state dict of CPU tensors; with
    `index`, only host `index`'s file, holding the vars the manifest
    deals to it (the owned-shards-only restore)."""
    var_meta = manifest.get("vars", {})
    shards = manifest.get("shards", [])
    expected = list(var_meta)
    if index is not None:
        shards = [s for s in shards if s == mf.shard_file(index)]
        expected = [n for n, m in var_meta.items()
                    if int(m.get("shard", 0)) == index]
    state: Dict[str, torch.Tensor] = {}
    for shard in shards:
        with np.load(os.path.join(path, shard)) as data:
            for key in data.files:
                name = mf.decode_name(key)
                arr = data[key]
                meta = var_meta.get(name)
                state[name] = mf.to_torch(
                    arr, meta["dtype"] if meta else str(arr.dtype))
    missing = [n for n in expected if n not in state]
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
    _barrier(count, f"ckpt-state:{path}")
    if index == 0:
        _commit_state(path, tmp, parent, count, var_meta, meta)
    _barrier(count, f"ckpt-state-commit:{path}")


def _commit_state(path, tmp, parent, count, var_meta, meta) -> None:
    """Host 0 of write_state: the manifest written last, the tmp dir
    published at `path`."""
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
