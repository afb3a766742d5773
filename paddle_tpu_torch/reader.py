"""paddle.reader — the fluid-era reader-decorator toolkit (counterpart of
paddle_tpu/reader.py; Paddle's python/paddle/reader/decorator.py: cache:51,
map_readers:91, shuffle:133, chain:182, compose:247, buffered:307,
firstn:366, xmap_readers:411, multiprocess_reader:504).

A *reader creator* is a zero-arg callable returning an iterable of
samples; every decorator maps reader creators to reader creators.  These
are host-side Python utilities with the reference's semantics, its use
of Python's `random` (`random.seed(s)` gives both packages the same
shuffle), and its threads where Paddle forks (xmap_readers,
multiprocess_reader).  `device_buffered` stages samples on the card from
pinned memory; io.DataLoader and io.PyReader are the batch loaders.
"""

from __future__ import annotations

import itertools
import queue
import random
import threading

import numpy as np
import torch

__all__ = ["cache", "map_readers", "buffered", "device_buffered", "compose",
           "chain", "shuffle", "shard", "firstn", "xmap_readers",
           "multiprocess_reader"]


def cache(reader):
    """Cache the first full pass in memory; later passes replay it."""
    all_data = tuple(reader())

    def creator():
        return iter(all_data)

    return creator


def map_readers(func, *readers):
    """Yield func(*samples) over the zip of the readers' outputs."""

    def creator():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return creator


def shuffle(reader, buf_size):
    """Buffered shuffle: fill a buf_size window, shuffle, emit."""

    def creator():
        buf = []
        for s in reader():
            buf.append(s)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            random.shuffle(buf)
            yield from buf

    return creator


def shard(reader, num_shards=None, shard_id=None):
    """Per-host disjoint shard of a reader (the reader-decorator face
    of the feed pipeline): sample i is yielded on the host where
    `i % num_shards == shard_id`.  Without both arguments the topology is
    one host (feed_pipeline.host_topology; more waits for ROADMAP queue 1
    item 10), which yields every sample.  The union over all hosts is
    exactly the underlying reader's stream, with no overlap."""

    def creator():
        from .dataset.feed_pipeline import host_topology

        index, count = host_topology(shard_id, num_shards)
        for i, s in enumerate(reader()):
            if i % count == index:
                yield s

    return creator


def chain(*readers):
    """Concatenate readers back to back."""

    def creator():
        return itertools.chain(*[r() for r in readers])

    return creator


def compose(*readers, **kwargs):
    """Zip readers into flattened tuples: (a, (b, c)) -> (a, b, c).
    check_alignment=True (default) raises when readers end unevenly."""
    check_alignment = kwargs.pop("check_alignment", True)
    _exhausted = object()  # private sentinel: a reader may yield None

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def creator():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(map(make_tuple, outputs), ())
            return
        for outputs in itertools.zip_longest(*rs, fillvalue=_exhausted):
            if any(o is _exhausted for o in outputs):
                raise ValueError(
                    "compose: readers have different lengths "
                    "(check_alignment=True)")
            yield sum(map(make_tuple, outputs), ())

    return creator


def buffered(reader, size):
    """Read ahead up to `size` samples in a background thread.  Upstream
    exceptions re-raise in the consumer; abandoning the generator early
    (e.g. under firstn) releases the fill thread instead of leaking it
    blocked on a full queue."""

    end = object()

    def creator():
        q = queue.Queue(maxsize=size)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def fill():
            try:
                for s in reader():
                    if not put(s):
                        return
                put(end)
            except BaseException as e:  # forward to the consumer
                put(e)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        try:
            while True:
                s = q.get()
                if s is end:
                    return
                if isinstance(s, BaseException):
                    raise s
                yield s
        finally:
            stop.set()

    return creator


def device_buffered(reader, size=2, device=None):
    """`buffered` + device staging (the executor hot path's feed stage
    as a reader decorator): the fill thread copies each sample's arrays
    to `device` (default: the current device, cuda) from pinned host
    memory with `non_blocking=True`, while the consumer computes on
    earlier ones, so the host-to-device copy overlaps the card's work on
    batch N.  Samples must be arrays / (nested) tuples of arrays; they
    arrive as tensors on `device`.  Host time spent staging is counted on
    the profiler's `host_feed_ms`."""
    from . import device as _device

    dev = _device.resolve(device)

    def to_device(a):
        t = torch.as_tensor(np.asarray(a)) if not isinstance(
            a, torch.Tensor) else a
        if dev.type != "cuda":
            return t.to(dev)
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    def stage(sample):
        from .io import _tree
        from .profiler import timed

        with timed("host_feed_ms"):
            return _tree(sample, to_device)

    return buffered(map_readers(stage, reader), size)


def firstn(reader, n):
    """Only the first n samples."""

    def creator():
        return itertools.islice(reader(), n)

    return creator


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with `process_num` worker threads.
    order=True preserves input order (the reference tags samples with
    indices and reorders on the output side)."""

    end = object()

    def creator():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        stop = threading.Event()

        def put(q, item):
            # bounded put that gives up when the consumer is gone —
            # otherwise abandoned generators leak threads blocked on
            # full queues (and keep the upstream reader open)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feed():
            try:
                for i, s in enumerate(reader()):
                    if not put(in_q, (i, s)):
                        return
            except BaseException as e:
                put(out_q, e)
            finally:
                for _ in range(process_num):
                    put(in_q, end)

        def work():
            try:
                while not stop.is_set():
                    try:
                        item = in_q.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    if item is end:
                        return
                    i, s = item
                    if not put(out_q, (i, mapper(s))):
                        return
            except BaseException as e:  # a dead worker must not deadlock
                put(out_q, e)
            finally:
                put(out_q, end)

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()

        try:
            finished = 0
            if not order:
                while finished < process_num:
                    item = out_q.get()
                    if item is end:
                        finished += 1
                        continue
                    if isinstance(item, BaseException):
                        raise item
                    yield item[1]
                return
            pending = {}
            next_i = 0
            while finished < process_num or pending:
                if next_i in pending:
                    yield pending.pop(next_i)
                    next_i += 1
                    continue
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                pending[item[0]] = item[1]
        finally:
            stop.set()

    return creator


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave multiple readers concurrently, one thread each (Paddle
    forks worker processes with pipes; a process that has started CUDA
    must not fork, and `use_pipe` is accepted and ignored, as in the
    reference)."""

    end = object()

    def creator():
        q = queue.Queue(queue_size)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def run(r):
            try:
                for s in r():
                    if not put(s):
                        return
            except BaseException as e:
                put(e)
            finally:
                put(end)

        for r in readers:
            threading.Thread(target=run, args=(r,), daemon=True).start()
        try:
            finished = 0
            while finished < len(readers):
                s = q.get()
                if s is end:
                    finished += 1
                    continue
                if isinstance(s, BaseException):
                    raise s
                yield s
        finally:
            stop.set()

    return creator
