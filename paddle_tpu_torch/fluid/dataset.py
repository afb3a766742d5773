"""Dataset factory: the file-driven ingestion path of train_from_dataset
(counterpart of paddle_tpu/fluid/dataset.py:36-333).

The wire format is the reference's MultiSlot text line ("<n> v1 .. vn"
a slot, slots in set_use_var's order).  Parser threads feed a bounded
`queue.Queue`; `thread` sizes the parser pool (the Executor runs one
step at a time on one stream, so there are no device workers).
`InMemoryDataset` holds the parsed samples on the host and shuffles
them with `random.Random(seed)` (the reference's global_shuffle on one
host); `QueueDataset` streams them while the loop trains.  The same
files and seed give the reference's order, batch by batch.

Several hosts (the reference's per-host sharding): `batch_iter(shard=
(index, count), epoch)` deals each host a disjoint, exhaustive shard of
the epoch's permutation (a strided slice of the files; of each file's
records where there are fewer files than hosts), and
`load_into_memory(shard_by_host=True)` loads only this host's shard (the
topology from the process group, feed_pipeline.host_topology).
`set_pipe_command` raises as in the reference.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import List

import numpy as np

from ..dataset import feed_pipeline
from .executor import dataset_np_dtype as _np_dtype


class DatasetFactory:
    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError(f"unknown dataset class {datafeed_class!r}")


class _Queue:
    """A bounded queue.Queue whose producers stop once the consumer has
    closed it: `push` returns False then."""

    def __init__(self, capacity):
        self._q = queue.Queue(maxsize=capacity)
        self._closed = threading.Event()

    def push(self, item) -> bool:
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def pop(self):
        return self._q.get()

    def close(self):
        self._closed.set()


class _Done:
    """A parser thread's last item: its error, if it failed."""

    def __init__(self, error=None):
        self.error = error


def _start_parsers(jobs, q: _Queue):
    """One daemon thread a job (a generator of items), each pushing its
    items and then a _Done."""

    def worker(job):
        try:
            for item in job:
                if not q.push(item):
                    return
            q.push(_Done())
        except BaseException as e:  # noqa: BLE001 - raised by the consumer
            q.push(_Done(e))

    threads = [threading.Thread(target=worker, args=(j,), daemon=True)
               for j in jobs]
    for t in threads:
        t.start()
    return threads


class DatasetBase:
    def __init__(self):
        self._batch_size = 1
        self._use_vars = []
        self._filelist: List[str] = []
        self._thread = 1
        self._parse_fn = None
        self._drop_last = False
        self._seed = 0
        # set by load_into_memory(shard_by_host=True): the store holds
        # only this host's shard, which no pass shards again
        self._host_sharded = False

    def set_batch_size(self, batch_size):
        self._batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self._thread = max(1, int(thread_num))

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_use_var(self, var_list):
        self._use_vars = list(var_list)

    def set_parse_fn(self, fn):
        """fn(line) -> one numpy array a use_var, in place of the MultiSlot
        parse (the reference's replacement of set_pipe_command)."""
        self._parse_fn = fn

    def set_pipe_command(self, cmd):
        raise NotImplementedError(
            "set_pipe_command (shell preprocessors) is not supported; use "
            "set_parse_fn(python_fn) instead")

    def set_shuffle_seed(self, seed):
        """Seeds the in-memory global shuffle."""
        self._seed = int(seed)

    def _shard_files(self, shard, epoch=0):
        """(files, keep) of one host's shard: a strided slice of the
        epoch's file permutation (feed_pipeline.shard_plan) where there
        are at least as many files as hosts; else every file, of whose
        records `keep(line index)` takes a disjoint, exhaustive slice."""
        if not shard:
            return list(self._filelist), None
        index, count = int(shard[0]), max(1, int(shard[1]))
        if count <= 1:
            return list(self._filelist), None
        if len(self._filelist) >= count:
            order = feed_pipeline.shard_plan(len(self._filelist), index,
                                             count, epoch=epoch,
                                             seed=self._seed)
            return [self._filelist[i] for i in order], None
        offset = (index + int(epoch)) % count
        return list(self._filelist), \
            lambda li, _c=count, _o=offset: li % _c == _o

    def _parse_line(self, line):
        if self._parse_fn is not None:
            return self._parse_fn(line)
        toks = line.split()
        out = []
        pos = 0
        for v in self._use_vars:
            n = int(toks[pos])
            out.append(np.asarray(toks[pos + 1:pos + 1 + n],
                                  dtype=_np_dtype(v)))
            pos += 1 + n
        return out

    def _iter_samples(self, files, keep=None):
        """The files' samples in order; `keep(line index)` filters the
        records before they are parsed (a record shard)."""
        for path in files:
            with open(path) as f:
                li = 0
                for line in f:
                    line = line.strip()
                    if line:
                        if keep is None or keep(li):
                            yield self._parse_line(line)
                        li += 1

    def _iter_samples_keyed(self, files, file_base, keep=None):
        """((file, line) key, sample): a threaded load restores the
        files' order from the keys."""
        for fi, path in enumerate(files):
            with open(path) as f:
                li = 0
                for line in f:
                    line = line.strip()
                    if line:
                        if keep is None or keep(li):
                            yield (file_base[fi], li), \
                                self._parse_line(line)
                        li += 1

    def _batch(self, samples, columns=None, lo=0):
        """The samples' arrays stacked a use_var, into a feed dict; a
        var's slice of `columns` (the whole store stacked, rows lo..)
        stands for its stack."""
        feed = {}
        for i, v in enumerate(self._use_vars):
            col = columns[i] if columns is not None else None
            a = col[lo:lo + len(samples)] if col is not None else \
                np.stack([s[i] for s in samples])
            want = [d for d in v.shape if d not in (-1, None)]
            if want and list(a.shape[1:]) != want:
                a = a.reshape([len(samples)] + want)
            feed[v.name] = a
        return feed

    def batch_iter(self, shard=None, epoch=0):
        raise NotImplementedError


class InMemoryDataset(DatasetBase):
    """Load, shuffle, iterate.  Besides the samples it keeps the store
    stacked a use_var (`_columns`, built at the load and permuted by the
    shuffle), so a batch is a slice: stacking a thousand small arrays
    per var a batch on the feed thread would hold the GIL for tens of ms
    a batch, against the training loop's dispatch."""

    def __init__(self):
        super().__init__()
        self._samples = None
        self._columns = None

    def _stack_columns(self):
        """One array a use_var over every sample, None for a var whose
        samples differ in shape (its batches stack their own, and raise
        as the reference's where a batch mixes shapes)."""
        cols = []
        for i in range(len(self._use_vars)):
            try:
                cols.append(np.stack([s[i] for s in self._samples]))
            except ValueError:
                cols.append(None)
        self._columns = cols

    def load_into_memory(self, shard_by_host=False, process_index=None,
                         process_count=None):
        """Parse every file into host memory with `thread` parser
        threads, in the files' order; `shard_by_host` loads only this
        host's shard (of `process_count` hosts, the group's by
        default)."""
        if not self._filelist:
            raise ValueError("set_filelist() before load_into_memory()")
        filelist, keep = self._filelist, None
        if shard_by_host:
            index, count = feed_pipeline.host_topology(process_index,
                                                       process_count)
            filelist, keep = self._shard_files((index, count))
            self._host_sharded = count > 1
        if self._thread <= 1 or len(filelist) <= 1:
            self._samples = list(self._iter_samples(filelist, keep))
            self._stack_columns()
            return
        q = _Queue(4096)
        jobs = [self._iter_samples_keyed(filelist[i::self._thread],
                                         list(range(i, len(filelist),
                                                    self._thread)), keep)
                for i in range(min(self._thread, len(filelist)))]
        threads = _start_parsers(jobs, q)
        done, keyed = 0, []
        try:
            while done < len(threads):
                item = q.pop()
                if isinstance(item, _Done):
                    done += 1
                    if item.error is not None:
                        raise item.error
                else:
                    keyed.append(item)
        finally:
            q.close()
        # the threads' arrival order is the scheduler's: restore the
        # (file, line) order, which the seeded shuffle starts from
        keyed.sort(key=lambda kv: kv[0])
        self._samples = [s for _, s in keyed]
        self._stack_columns()

    def global_shuffle(self, fleet=None, thread_num=None):
        """One permutation over every loaded sample."""
        if self._samples is None:
            raise ValueError("load_into_memory() before global_shuffle()")
        # the reference's random.Random(seed).shuffle of the samples, as a
        # permutation (the same swaps), applied to them and the columns
        order = list(range(len(self._samples)))
        random.Random(self._seed).shuffle(order)
        self._samples = [self._samples[i] for i in order]
        idx = np.asarray(order, dtype=np.int64)
        self._columns = [None if c is None else c[idx]
                         for c in self._columns]

    def release_memory(self):
        self._samples = None
        self._columns = None

    def get_memory_data_size(self, fleet=None):
        return len(self._samples or [])

    def batch_iter(self, shard=None, epoch=0):
        """`shard=(index, count)`: only this host's slice of the epoch's
        permutation of the store, unless the store was loaded sharded."""
        if self._samples is None:
            raise ValueError("load_into_memory() first")
        samples, columns = self._samples, self._columns
        if shard and not self._host_sharded and int(shard[1]) > 1:
            order = feed_pipeline.shard_plan(len(samples), int(shard[0]),
                                             int(shard[1]), epoch=epoch,
                                             seed=self._seed)
            samples = [samples[i] for i in order]
            idx = np.asarray(order, dtype=np.int64)
            columns = [None if c is None else c[idx] for c in columns]
        for i in range(0, len(samples), self._batch_size):
            chunk = samples[i:i + self._batch_size]
            if self._drop_last and len(chunk) < self._batch_size:
                break
            yield self._batch(chunk, columns, i)


class QueueDataset(DatasetBase):
    """Streaming: `thread` parser threads feed a bounded queue while the
    loop trains; with one thread the samples come in the files' order."""

    def batch_iter(self, shard=None, epoch=0):
        """`shard=(index, count)`: the parsers read only this host's
        shard of the epoch's files (records)."""
        if not self._filelist:
            raise ValueError("set_filelist() before iterating")
        filelist, keep = self._shard_files(shard, epoch=epoch)
        if not filelist:
            return
        q = _Queue(1024)
        jobs = [self._iter_samples(filelist[i::self._thread], keep)
                for i in range(min(self._thread, len(filelist)))]
        threads = _start_parsers(jobs, q)
        try:
            done, buf = 0, []
            while done < len(threads) or buf:
                if done < len(threads):
                    s = q.pop()
                    if isinstance(s, _Done):
                        done += 1
                        if s.error is not None:
                            raise s.error
                    else:
                        buf.append(s)
                if len(buf) == self._batch_size or (done == len(threads)
                                                    and buf):
                    if not (self._drop_last
                            and len(buf) < self._batch_size):
                        yield self._batch(buf)
                    buf = []
        finally:
            # a consumer leaving mid-epoch releases the producers
            q.close()
            for t in threads:
                t.join(timeout=5)
