"""`paddle.io`: Dataset, Sampler and DataLoader (counterpart of
paddle_tpu/io/__init__.py:1-585).

Datasets, samplers and `default_collate_fn` are the reference's, numpy on
the host: `RandomSampler` draws from the global `np.random.permutation`,
so `np.random.seed(s)` gives both packages the same batches.

DataLoader workers (`num_workers > 0`) are forked processes (threads
with `use_process_workers=False`).  Worker w collates batches w, w + n,
w + 2n, ... of the sampler's list and the loader reads the workers in
turn, so the batches come in the sampler's order, as with 0 workers.
A worker may touch only numpy: it is forked after CUDA is up.  A
process worker over a map-style dataset with the default collate sends
its batches through a ring of batch slots in one shared mapping: it
collates straight into one of its own free slots, and a CUDA consumer
copies the batch to the card from the slot itself, the mapping being
registered as pinned memory.  Batches of an IterableDataset or of
another collate, and a batch too large for its slot, cross through the
worker's `multiprocessing` queue (pickled).  `use_shared_memory` is
accepted and ignored, as in the reference.

`use_buffer_reader` (the default) moves each batch to the device one
batch ahead: a background thread copies it into pinned host memory and
issues a non_blocking copy on a side stream; the consumer's stream
waits for that copy on the device, never on the host.  Batches then
come as tensors on the device (`places`, else the current device);
without it they come as the workers made them (numpy).
"""

from __future__ import annotations

import itertools
import math
import queue
import threading
import time
import traceback

import numpy as np
import torch

from .. import device as _device

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "default_collate_fn",
           "DataLoader", "get_worker_info", "WorkerInfo"]


# -- datasets -----------------------------------------------------------------

class Dataset:
    """Map-style dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        arrays = [t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                  else np.asarray(t) for t in tensors]
        n = arrays[0].shape[0]
        assert all(a.shape[0] == n for a in arrays)
        self.tensors = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        assert all(len(d) == len(self.datasets[0]) for d in self.datasets)

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, tuple) else (sample,))
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        return itertools.chain(*self.datasets)


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    assert sum(lengths) == len(dataset)
    perm = np.random.RandomState().permutation(len(dataset))
    out, ofs = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + n].tolist()))
        ofs += n
    return out


# -- samplers -----------------------------------------------------------------

class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype="float64")
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(p), size=self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """This rank's batches: the (shuffled by epoch) indices padded to a
    multiple of the ranks, then every num_replicas-th from `rank`.
    Without num_replicas / rank, torch.distributed's world (1 and 0
    when it is not initialised)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        dist = torch.distributed
        live = dist.is_available() and dist.is_initialized()
        if num_replicas is None:
            num_replicas = dist.get_world_size() if live else 1
        if rank is None:
            rank = dist.get_rank() if live else 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(
            math.ceil(len(dataset) / self.nranks)) if not drop_last \
            else len(dataset) // self.nranks
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(n)
        if not self.drop_last and self.total_size > n:
            indices = np.concatenate(
                [indices, indices[:self.total_size - n]])
        indices = indices[:self.total_size]
        batch = []
        for idx in indices[self.local_rank::self.nranks].tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


# -- collate ------------------------------------------------------------------

def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch])
                for k in sample}
    return np.stack([np.asarray(s) for s in batch])


def _tree(batch, fn):
    """fn over the arrays of a collated batch, its structure kept."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree(b, fn) for b in batch)
    if isinstance(batch, dict):
        return {k: _tree(v, fn) for k, v in batch.items()}
    return fn(batch)


# -- worker transport ---------------------------------------------------------

class _NoRoom(Exception):
    pass


def _collate_into(batch, alloc):
    """default_collate_fn, each stacked array written where alloc(shape,
    dtype) says."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return tuple(_collate_into([b[i] for b in batch], alloc)
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: _collate_into([b[k] for b in batch], alloc)
                for k in sample}
    arrays = [np.asarray(s) for s in batch]
    out = alloc((len(arrays),) + arrays[0].shape, arrays[0].dtype)
    return np.stack(arrays, out=out)


def _batch_bytes(sample, batch_size):
    leaves = []
    _tree(sample, lambda a: leaves.append(np.asarray(a).nbytes))
    return batch_size * sum(-(-n // 64) * 64 for n in leaves)


class _Leaf:
    """Where one array of a batch lies in the ring."""

    def __init__(self, offset, shape, dtype):
        self.offset, self.shape, self.dtype = offset, shape, dtype


class _Ring:
    """Batch slots in one anonymous shared mapping, made before the
    workers fork, so that a worker collates a batch straight into a slot
    the loader reads.  For a CUDA consumer the mapping is registered as
    pinned memory (after the fork, unregistered when the workers stop),
    and a slot's arrays are copied to the card from where they lie.
    `busy` while an iteration's workers may still write to it."""

    def __init__(self, nslots, slot_bytes):
        import mmap

        self.nslots, self.slot_bytes = nslots, slot_bytes
        self.mm = mmap.mmap(-1, nslots * slot_bytes)
        self._pinned = None
        self.busy = False

    def write(self, idx, samples):
        """Collate `samples` into slot idx: the layout, a tree of _Leaf;
        _NoRoom when the batch does not fit."""
        off = [idx * self.slot_bytes]
        end = off[0] + self.slot_bytes
        where = {}

        def alloc(shape, dtype):
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            if off[0] + n > end:
                raise _NoRoom
            view = np.ndarray(shape, dtype, buffer=self.mm, offset=off[0])
            where[id(view)] = _Leaf(off[0], shape, np.dtype(dtype).str)
            off[0] += -(-n // 64) * 64
            return view

        views = _collate_into(samples, alloc)
        return _tree(views, lambda v: where[id(v)])

    def view(self, leaf):
        return np.ndarray(leaf.shape, np.dtype(leaf.dtype), buffer=self.mm,
                          offset=leaf.offset)

    def pin(self):
        import ctypes

        buf = (ctypes.c_char * len(self.mm)).from_buffer(self.mm)
        err = torch.cuda.cudart().cudaHostRegister(
            ctypes.addressof(buf), len(self.mm), 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister failed: {err}")
        self._pinned = buf

    def unpin(self):
        import ctypes

        if self._pinned is not None:
            torch.cuda.cudart().cudaHostUnregister(
                ctypes.addressof(self._pinned))
            self._pinned = None


class _Slot:
    """A batch that lies in a ring slot: its arrays, and the function
    that hands the slot back to the workers."""

    def __init__(self, arrays, release):
        self.arrays, self.release = arrays, release


class WorkerInfo:
    """Per-worker metadata, available inside process workers via
    get_worker_info()."""

    def __init__(self, wid, num_workers, dataset):
        self.id = wid
        self.num_workers = num_workers
        self.dataset = dataset


_WORKER_INFO = None


def get_worker_info():
    """Inside a worker process: that worker's WorkerInfo; in the main
    process (and in thread workers): None."""
    return _WORKER_INFO


# -- DataLoader ---------------------------------------------------------------

def _pinned(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor) and a.is_pinned():
        return a
    return torch.from_numpy(np.asarray(a)).pin_memory()


def copy_ahead(tree, dev, stream):
    """The arrays of `tree` (numpy, or pinned tensors) copied to `dev` on
    `stream` through pinned host memory without blocking the host:
    (the tree on `dev`, an event recorded on `stream` after the copies).
    The consumer hands both to `arrive`."""
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        out = _tree(tree, lambda a: _pinned(a).to(dev, non_blocking=True))
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def arrive(tree, done, dev):
    """`tree` ready for the current stream of `dev`: the stream waits for
    `done` on the device (the host does not), and the tensors are marked
    used there, so the allocator keeps them until that work ends."""
    cur = torch.cuda.current_stream(dev)
    cur.wait_event(done)
    _tree(tree, lambda x: x.record_stream(cur))
    return tree


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=False, timeout=0, worker_init_fn=None,
                 use_process_workers=None):
        self.dataset = dataset
        self.places = places
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.use_buffer_reader = use_buffer_reader
        self.prefetch_factor = max(2, int(prefetch_factor))
        self.worker_init_fn = worker_init_fn
        # 0: wait forever; > 0: a worker silent that long is an error
        self.timeout = float(timeout or 0)
        if use_process_workers is None:
            import multiprocessing as mp

            use_process_workers = "fork" in mp.get_all_start_methods()
        self.use_process_workers = bool(use_process_workers)
        self._ring = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif not self._iterable_mode:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
        else:
            self.batch_sampler = None

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no length")
        return len(self.batch_sampler)

    # -- host batches ----------------------------------------------------------
    def _iterable_shard_batches(self, wid, num_workers):
        """Collated batches of this worker's shard of an IterableDataset
        (every num_workers-th sample from wid)."""
        batch = []
        for i, sample in enumerate(self.dataset):
            if i % num_workers != wid:
                continue
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _batches_sync(self, work):
        if self._iterable_mode:
            yield from self._iterable_shard_batches(0, 1)
        else:
            for idxs in work:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    def _worker_batches(self, wid, work):
        if self._iterable_mode:
            return self._iterable_shard_batches(wid, self.num_workers)
        return (self.collate_fn([self.dataset[i] for i in idxs])
                for idxs in work[wid::self.num_workers])

    def _ring_for(self, work):
        """The ring for process workers over a map-style dataset with the
        default collate: prefetch_factor slots a worker, each sized from
        one sample for a batch.  It is made on first use and kept across
        epochs; while an earlier iteration's workers may still write to
        it (one left early and not yet closed), this one gets a new
        ring."""
        if not self.use_process_workers or self._iterable_mode \
                or self.collate_fn is not default_collate_fn or not work:
            return None
        nslots = self.num_workers * self.prefetch_factor
        slot = _batch_bytes(self.dataset[work[0][0]], len(work[0]))
        ring = self._ring
        if ring is None or ring.busy or ring.nslots != nslots \
                or ring.slot_bytes < slot:
            ring = self._ring = _Ring(nslots, slot)
        ring.busy = True
        return ring

    def _start_workers(self, work):
        """num_workers processes (or threads), each with its own queue,
        started here, in the consumer's thread.  Worker w owns ring slots
        w, w + n, ...: a worker waits only for its own slots, which come
        back in the order the loader reads its batches."""
        n = self.num_workers
        procs = self.use_process_workers
        ring = self._ring_for(work)
        if procs:
            import multiprocessing as mp

            ctx = mp.get_context("fork")
            stop = ctx.Event()
            queues = [ctx.Queue(maxsize=self.prefetch_factor)
                      for _ in range(n)]
            free = [ctx.Queue() for _ in range(n)] if ring else None
            for i in range(ring.nslots if ring else 0):
                free[i % n].put(i)
        else:
            stop = threading.Event()
            queues = [queue.Queue(maxsize=self.prefetch_factor)
                      for _ in range(n)]
            free = None

        def put(q, item):
            if procs:  # the reader drains the queue until the end
                q.put(item)
                return True
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def in_ring(wid, samples):
            """("ring", slot, layout), or the collated batch where it
            does not fit."""
            while True:
                try:
                    idx = free[wid].get(timeout=0.1)
                    break
                except queue.Empty:
                    if stop.is_set():
                        return None
            try:
                return ("ring", idx, ring.write(idx, samples))
            except _NoRoom:
                free[wid].put(idx)
                return ("b", default_collate_fn(samples))

        def child(wid):
            global _WORKER_INFO
            if procs:
                _WORKER_INFO = WorkerInfo(wid, n, self.dataset)
            q = queues[wid]
            try:
                if self.worker_init_fn is not None:
                    self.worker_init_fn(wid)
                if ring is not None:
                    for idxs in work[wid::n]:
                        if stop.is_set():
                            return
                        item = in_ring(wid, [self.dataset[i] for i in idxs])
                        if item is None or not put(q, item):
                            return
                else:
                    for b in self._worker_batches(wid, work):
                        if stop.is_set() or not put(q, ("b", b)):
                            return
                put(q, ("end", None))
            except BaseException:  # noqa: BLE001 - raised in the parent
                put(q, ("err", traceback.format_exc()))

        if procs:
            workers = [ctx.Process(target=child, args=(w,), daemon=True)
                       for w in range(n)]
        else:
            workers = [threading.Thread(target=child, args=(w,),
                                        daemon=True) for w in range(n)]
        for w in workers:
            w.start()
        return workers, queues, stop, ring, free

    def _read_workers(self, started, pin=False):
        """The workers' batches, read in turn: the sampler's order.  With
        `pin`, a batch in the ring comes as a _Slot of tensors over its
        pinned slot; otherwise it is copied out and its slot freed."""
        workers, queues, stop, ring, free = started
        live, pos = list(range(len(workers))), 0
        try:
            if ring is not None and pin:
                ring.pin()
            while live:
                w = live[pos]
                kind, *payload = self._get(queues[w], workers[w], w)
                if kind == "end":
                    live.pop(pos)
                    pos = pos % len(live) if live else 0
                    continue
                if kind == "err":
                    raise RuntimeError("DataLoader worker failed:\n"
                                       + payload[0])
                if kind == "ring":
                    idx, layout = payload
                    if pin:
                        batch = _Slot(_tree(layout, lambda leaf: (
                            torch.from_numpy(ring.view(leaf)))),
                            lambda i=idx, w=w: free[w].put(i))
                    else:
                        batch = _tree(layout,
                                      lambda leaf: np.array(ring.view(leaf)))
                        free[w].put(idx)
                else:
                    batch = payload[0]
                yield batch
                pos = (pos + 1) % len(live)
        finally:
            stop.set()
            if self.use_process_workers:
                self._stop_processes(workers, queues)
            if ring is not None:
                ring.unpin()
                ring.busy = False

    @staticmethod
    def _stop_processes(workers, queues):
        """Drain the queues while the workers, told to stop, finish the
        batch at hand and exit; any still alive after 10 s is
        terminated."""

        def drain():
            for q in queues:
                while True:
                    try:
                        q.get_nowait()
                    except (queue.Empty, OSError, EOFError, ValueError):
                        break

        deadline = time.monotonic() + 10
        while any(w.is_alive() for w in workers) \
                and time.monotonic() < deadline:
            drain()
            time.sleep(0.005)
        drain()
        for w in workers:
            if w.is_alive():
                w.terminate()
            w.join(timeout=5)

    def _get(self, q, worker, wid):
        t0 = time.monotonic()
        while True:
            try:
                return q.get(timeout=1.0)
            except queue.Empty:
                if not worker.is_alive():
                    try:  # its last words may have landed meanwhile
                        return q.get(timeout=1.0)
                    except queue.Empty:
                        pass
                    raise RuntimeError(
                        f"DataLoader worker {wid} died without a result "
                        f"(exitcode {getattr(worker, 'exitcode', None)})")
                if self.timeout > 0 and time.monotonic() - t0 > self.timeout:
                    raise RuntimeError(f"DataLoader worker {wid} timed out: "
                                       f"no data for {self.timeout:.0f}s")

    def _host_batches(self, work, pin=False):
        if self.num_workers > 0:
            return self._read_workers(self._start_workers(work), pin)
        return self._batches_sync(work)

    # -- iteration ---------------------------------------------------------------
    def __iter__(self):
        # the sampler's indices are drawn here, in the consumer's thread,
        # at the first batch, as the reference draws them
        work = None if self._iterable_mode else list(self.batch_sampler)
        if not self.use_buffer_reader:
            yield from self._host_batches(work)
            return
        dev = _device.resolve(self.places[0] if isinstance(
            self.places, (list, tuple)) else self.places)
        if dev.type != "cuda":
            for b in self._host_batches(work):
                yield _tree(b, torch.as_tensor)
            return
        yield from self._buffered(self._host_batches(work, pin=True), dev)

    @staticmethod
    def _buffered(gen, dev):
        """The batches of `gen` on `dev`, each copied there one batch ahead
        by a background thread (pinned host memory, non_blocking copy on a
        side stream); the consumer's stream waits for it on the device."""
        stream = torch.cuda.Stream(dev)
        q = queue.Queue(maxsize=1)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def run():
            try:
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    for batch in gen:
                        out, done = copy_ahead(
                            batch.arrays if isinstance(batch, _Slot)
                            else batch, dev, stream)
                        if isinstance(batch, _Slot):
                            # this thread waits for the copy (the GIL
                            # released), then hands the slot back
                            done.synchronize()
                            batch.release()
                        if not put(("b", out, done)):
                            break
                put(("end", None, None))
            except BaseException as e:  # noqa: BLE001 - raised below
                put(("err", e, None))
            finally:
                gen.close()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        try:
            while True:
                kind, out, done = q.get()
                if kind == "end":
                    return
                if kind == "err":
                    raise out
                yield arrive(out, done, dev)
        finally:
            stop.set()
            t.join(timeout=30)
