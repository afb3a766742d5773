"""The dataset loops' feed pipeline (counterpart of
paddle_tpu/dataset/feed_pipeline.py:67-498).

A producer thread takes host batches from a dataset's parser pool (or
any iterable of feed dicts), stages each through `stage_fn` and puts it
into a `DeviceRing` of depth K (`PADDLE_PREFETCH_DEPTH`, default 2).  For
the card, the Executor's stage function packs a batch's arrays into one
pinned host buffer and copies it on a side stream without blocking
(`io.copy_ahead`), so batch N+1..N+K is on its way while step N runs;
the consumer's stream waits on the copy's CUDA event, never the host.
The ring blocks the producer while it is full (backpressure bounds the
staged batches at K), hands the consumer the oldest batch, re-raises an
upstream exception in the consumer, and releases a blocked producer
when closed.

Counters, in the port's `profiler`: `ring_occupancy` /
`ring_occupancy_max`, `prefetch_depth`; timers `parser_wait_ms`
(producer waiting on the parsers), `ring_full_wait_ms` (producer
backpressured: the device sets the pace) and `ring_empty_wait_ms`
(consumer starved: the feed does); `attribute_stall` classifies them
and `FeedPipeline.feed_report` sums them up.

Mid-epoch resume (paddle_tpu_torch.ckpt): opening a fluid dataset
records the feed epoch on it (`_feed_epoch`, one more a pass unless the
caller names it), and the first `skip_batches` batches of a resumed
epoch are drawn and dropped on the producer thread before anything is
staged (`feed_skipped_batches`), as the reference does; the order itself
is the dataset's, the same for the same files and seed.

Several hosts: `host_topology` reads the live process group (rank,
world size), and a fluid dataset's pass deals each rank its disjoint,
exhaustive shard of the epoch's permutation (files, or records where
there are fewer files than ranks), unless the dataset was already
loaded sharded (`load_into_memory(shard_by_host=True)`).  The shard math
(`epoch_order`, `shard_plan`) is the reference's, so the same seed gives
the same per-epoch plan on every rank.
"""

from __future__ import annotations

import collections
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import profiler

DEFAULT_PREFETCH_DEPTH = int(os.environ.get("PADDLE_PREFETCH_DEPTH", "2"))

def host_topology(process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> Tuple[int, int]:
    """(index, count) of this host: the arguments where given, else the
    live process group's (rank, world size), else the PADDLE_* contract,
    else one host."""
    from ..distributed import parallel

    index = parallel.process_index() if process_index is None \
        else int(process_index)
    count = parallel.process_count() if process_count is None \
        else int(process_count)
    return index, max(1, count)


def epoch_order(n: int, seed: int, epoch: int) -> List[int]:
    """The permutation of range(n) for one epoch, the same on every host
    (seed and epoch are shared)."""
    order = list(range(n))
    random.Random(f"feed-shard:{int(seed)}:{int(epoch)}").shuffle(order)
    return order


def shard_plan(n_items: int, index: int, count: int, epoch: int = 0,
               seed: int = 0) -> List[int]:
    """The item indices host `index` of `count` owns this epoch: a
    strided slice of the epoch's permutation, disjoint and exhaustive
    over the hosts for any (n_items, count); the identity on one host."""
    if count <= 1:
        return list(range(n_items))
    if index < 0 or index >= count:
        raise ValueError(f"shard index {index} outside [0, {count})")
    return epoch_order(n_items, seed, epoch)[index::count]


def attribute_stall(times: Optional[Dict[str, float]] = None) -> str:
    """Where the pipeline's wall time went, from the timers alone:
    `compute-bound` (the producer waited on a full ring), `parser-bound`
    or `transfer-bound` (the consumer starved; the producer's time went
    to the parsers, or to staging), `balanced` (nobody waited)."""
    if times is None:
        times = profiler.get_time_stats()
    full = float(times.get("ring_full_wait_ms", 0.0))
    empty = float(times.get("ring_empty_wait_ms", 0.0))
    parser = float(times.get("parser_wait_ms", 0.0))
    stage = float(times.get("host_feed_ms", 0.0))
    if full < 1e-6 and empty < 1e-6:
        return "balanced"
    if full >= empty:
        return "compute-bound"
    return "parser-bound" if parser >= stage else "transfer-bound"


class DeviceRing:
    """Depth-K ring of staged batches: `put` blocks while K batches wait
    (accounted as `ring_full_wait_ms`) and returns False once the ring is
    closed; `get` pops the oldest, blocking while the ring is empty
    (`ring_empty_wait_ms`), and gives `_END` at the end or once closed
    and drained; `close` releases a blocked producer and drops what the
    ring holds."""

    _END = object()

    def __init__(self, depth: int):
        self.depth = max(1, int(depth))
        self._slots: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self.max_occupancy = 0
        self.total_put = 0

    def __len__(self) -> int:
        with self._cond:
            return len(self._slots)

    def put(self, staged) -> bool:
        with self._cond:
            if len(self._slots) >= self.depth and not self._closed:
                t0 = time.perf_counter()
                while len(self._slots) >= self.depth and not self._closed:
                    self._cond.wait(timeout=0.1)
                profiler.time_add("ring_full_wait_ms",
                                  (time.perf_counter() - t0) * 1e3)
            if self._closed:
                return False
            self._slots.append(staged)
            occ = len(self._slots)
            self.total_put += staged is not self._END
            self.max_occupancy = max(self.max_occupancy, occ)
            profiler.stat_set("ring_occupancy", occ)
            profiler.stat_max("ring_occupancy_max", occ)
            self._cond.notify_all()
            return True

    def put_end(self):
        self.put(self._END)

    def get(self):
        with self._cond:
            if not self._slots and not self._closed:
                t0 = time.perf_counter()
                while not self._slots and not self._closed:
                    self._cond.wait(timeout=0.1)
                profiler.time_add("ring_empty_wait_ms",
                                  (time.perf_counter() - t0) * 1e3)
            if not self._slots:
                return self._END
            item = self._slots.popleft()
            profiler.stat_set("ring_occupancy", len(self._slots))
            self._cond.notify_all()
            return item

    def close(self):
        with self._cond:
            self._closed = True
            self._slots.clear()
            self._cond.notify_all()


class FeedPipeline:
    """Iterable of staged feeds: parser pool -> `stage_fn` (producer
    thread) -> `DeviceRing` -> consumer.

    `source` is a fluid dataset (one pass of its `batch_iter`, feed epoch
    `epoch`, default the next; this host's shard of it where there are
    several hosts, host_topology) or any iterable of host feed dicts.
    `stage_fn(feed)` runs on the producer thread; the first
    `skip_batches` batches are dropped unstaged (a resumed epoch)."""

    def __init__(self, stage_fn: Callable[[Any], Any], source,
                 depth: Optional[int] = None, epoch: Optional[int] = None,
                 skip_batches: int = 0, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self._stage = stage_fn
        self._depth = DEFAULT_PREFETCH_DEPTH if depth is None \
            else max(1, int(depth))
        self._skip = max(0, int(skip_batches))
        self._ring = DeviceRing(self._depth)
        batch_iter = getattr(source, "batch_iter", None)
        if batch_iter is None:
            self._batch_iter = iter(source)
        else:
            # the epoch counter advances a pass: the checkpoints key the
            # mid-epoch resume off it
            if epoch is None:
                epoch = getattr(source, "_feed_epoch", -1) + 1
            source._feed_epoch = int(epoch)
            index, count = host_topology(process_index, process_count)
            if count <= 1 or getattr(source, "_host_sharded", False):
                self._batch_iter = batch_iter()
            else:
                self._batch_iter = batch_iter(shard=(index, count),
                                              epoch=int(epoch))
        self.epoch_feed_ms = 0.0
        profiler.stat_set("prefetch_depth", self._depth)
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="feed-producer")
        self._thread.start()

    def _produce(self):
        ring = self._ring
        t_start = time.perf_counter()
        try:
            it = self._batch_iter
            skipped = 0
            while skipped < self._skip:
                try:
                    next(it)  # consumed before the checkpoint: not staged
                except StopIteration:
                    break
                skipped += 1
            if skipped:
                profiler.stat_add("feed_skipped_batches", skipped)
            while True:
                t0 = time.perf_counter()
                try:
                    feed = next(it)
                except StopIteration:
                    break
                profiler.time_add("parser_wait_ms",
                                  (time.perf_counter() - t0) * 1e3)
                if not ring.put(self._stage(feed)):
                    return  # the consumer left the epoch
            self.epoch_feed_ms = (time.perf_counter() - t_start) * 1e3
            ring.put_end()
        except BaseException as e:  # noqa: BLE001 - raised by the consumer
            ring.put(e)
        finally:
            close = getattr(self._batch_iter, "close", None)
            if close is not None:
                close()  # stops the dataset's parser pool

    def __iter__(self):
        ring = self._ring
        try:
            while True:
                item = ring.get()
                if item is DeviceRing._END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            ring.close()
            self._thread.join(timeout=5)

    def feed_report(self) -> Dict[str, Any]:
        """This host's feed counters and the stall attribution."""
        times = profiler.get_time_stats()
        stats = profiler.get_int_stats()
        return {
            "host": 0,
            "hosts": 1,
            "prefetch_depth": self._depth,
            "epoch_feed_ms": round(self.epoch_feed_ms, 3),
            "host_feed_ms": round(times.get("host_feed_ms", 0.0), 3),
            "parser_wait_ms": round(times.get("parser_wait_ms", 0.0), 3),
            "ring_full_wait_ms": round(
                times.get("ring_full_wait_ms", 0.0), 3),
            "ring_empty_wait_ms": round(
                times.get("ring_empty_wait_ms", 0.0), 3),
            "ring_occupancy_max": stats.get("ring_occupancy_max", 0),
            "stall_attribution": attribute_stall(times),
        }
