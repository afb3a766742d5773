"""Bucketed batch shapes (counterpart of paddle_tpu/serving/bucketing.py).

The batch dimension is snapped onto a small ladder of buckets (powers of
two by default) and every request batch is padded up to its bucket by
edge replication, so the model only ever sees `len(buckets)` shapes per
input signature.  Where the JAX package AOT-compiles one executable per
(bucket, signature), PyTorch runs eagerly: "compiling" an entry is one
warm-up run of the model at that shape (kernel builds on first use,
cuBLAS handles, the caching allocator's first blocks), done off the
dispatch loop under the same `_compile_lock`.  Batches larger than the
top bucket are served by chunking through it.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device

TRACE_STAT = "serving_trace_count"


def bucket_ladder(max_batch: int, min_bucket: int = 8) -> List[int]:
    """Power-of-two ladder covering [1, max_batch]: [8, 16, ..].

    The smallest bucket is `min_bucket` so single-request traffic maps
    onto ONE entry (batch 1..8 all pad to 8) instead of eight."""
    max_batch = max(1, int(max_batch))
    b = max(1, int(min_bucket))
    ladder = [min(b, max_batch)]
    while ladder[-1] < max_batch:
        b *= 2
        ladder.append(min(b, max_batch))
    return ladder


def bucket_for(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= n, or None (caller chunks through max)."""
    for b in buckets:
        if b >= n:
            return b
    return None


def pad_batch(a: np.ndarray, n: int) -> np.ndarray:
    """Pad the leading dim of host array `a` up to `n` rows by edge
    replication (repeat the last real row: padded rows stay inside the
    model's numeric envelope, where zeros could hit log(0)/div-0)."""
    rows = a.shape[0]
    if rows == n:
        return a
    if rows > n:
        raise ValueError(f"pad_batch: {rows} rows > bucket {n}")
    fill = np.broadcast_to(a[-1:], (n - rows,) + a.shape[1:])
    return np.concatenate([a, fill], axis=0)


def input_signature(inputs: Sequence[Any]) -> Tuple:
    """Per-request shape identity: trailing dims + dtype of each input
    (the batch dim is the bucket's business, not the signature's)."""
    return tuple((tuple(a.shape[1:]), str(np.dtype(a.dtype)))
                 for a in inputs)


class BucketedRunner:
    """Pads/buckets the leading batch dim of `fn` into a fixed set of
    warmed-up shapes.

    fn(*tensors) -> tensor / list of tensors, called on `device` under
    torch.inference_mode().  Outputs whose leading dim equals the padded
    batch are sliced back to the real row count (on the device, no
    transfer).  The warmed entries live in a bounded `CompileCache`
    (`cache`, or one of CACHE_CAPACITY), keyed by (bucket, signature,
    donate); the model registry gives each tenant its own.

    `bucketed=False` runs exact request shapes, unpadded (the inference
    `switch_ir_optim(False)` mapping).  `donate=True` (the inference
    `enable_memory_optim` mapping) has no buffer donation to map to in
    eager PyTorch: the padded feed on the device is released as soon as
    the model has been called, where it is otherwise kept with the batch
    until its outputs reach the host (`run_with_feed`); no answer
    changes.  `aot_token` is accepted and ignored (the persistent AOT
    cache is not ported: ROADMAP queue 1 item 11)."""

    CACHE_CAPACITY = 32

    def __init__(self, fn: Callable, buckets: Sequence[int], device=None,
                 donate: bool = False, bucketed: bool = True,
                 cache=None, aot_token: Optional[str] = None):
        from ..fluid.compile_cache import CompileCache

        if not buckets:
            raise ValueError("BucketedRunner needs >= 1 bucket")
        self._fn = fn
        self.buckets = sorted(set(int(b) for b in buckets))
        self.device = _device.resolve(device)
        self.donate = bool(donate)
        self.bucketed = bool(bucketed)
        self.aot_token = aot_token
        self._cache = cache if cache is not None else CompileCache(
            self.CACHE_CAPACITY, stat_prefix="serving")
        self._compile_lock = threading.Lock()

    # -- entry management --------------------------------------------------
    def _key(self, bucket: int, sig: Tuple) -> Tuple:
        return (bucket, sig, self.donate)

    def _bucket_of(self, rows: int) -> int:
        if not self.bucketed:
            return rows
        b = bucket_for(rows, self.buckets)
        return b if b is not None else self.buckets[-1]

    def plan(self, inputs: Sequence[Any]) -> Tuple[int, Tuple]:
        """(bucket, signature) the given inputs will run under."""
        return (self._bucket_of(inputs[0].shape[0]),
                input_signature(inputs))

    def is_compiled(self, inputs: Sequence[Any]) -> bool:
        return self._key(*self.plan(inputs)) in self._cache

    def ensure_compiled(self, inputs: Sequence[Any]) -> None:
        """Warm up the entry for these inputs if it is new — the off-path
        half of the contract: the engine's compiler thread calls this
        with the request parked, the dispatch loop never does."""
        bucket, sig = self.plan(inputs)
        key = self._key(bucket, sig)
        if self._cache.get(key) is not None:
            return
        # one warm-up at a time: racing threads would warm the same entry
        # twice (correct but wasteful)
        with self._compile_lock:
            if self._cache.get(key) is not None:
                return
            from ..profiler import stat_add, timed

            with timed("serving_compile_ms"):
                rows = min(inputs[0].shape[0], bucket)
                self._call([pad_batch(a[:rows], bucket) for a in inputs])
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            stat_add(TRACE_STAT)
            self._cache.put(key, True)

    def _call(self, padded: Sequence[np.ndarray]):
        """(outputs, the feed on the device)."""
        # inference_mode is thread-local: entered in the thread that runs
        # the model
        with torch.inference_mode():
            xs = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                  for a in padded]
            out = self._fn(*xs)
        return (list(out) if isinstance(out, (list, tuple)) else [out]), xs

    # -- execution ---------------------------------------------------------
    def run(self, inputs: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """Run host `inputs` (shared leading batch dim) through the
        bucketed entry; returns DEVICE tensors sliced to the real row
        count — the device may still be working on them (the caller
        waits at its own sanctioned boundary)."""
        return self.run_with_feed(inputs)[0]

    def run_with_feed(self, inputs: Sequence[np.ndarray]):
        """`run`'s outputs and the device feed to keep with them until
        they reach the host (None with `donate`)."""
        rows = inputs[0].shape[0]
        top = self.buckets[-1]
        if self.bucketed and rows > top:
            return self._run_chunked(inputs, rows, top), None
        bucket, _sig = self.plan(inputs)
        self.ensure_compiled(inputs)
        outs, xs = self._call([pad_batch(a, bucket) for a in inputs])
        outs = [o[:rows] if o.ndim and o.shape[0] == bucket else o
                for o in outs]
        return outs, None if self.donate else xs

    def _run_chunked(self, inputs, rows: int, top: int):
        """rows > max bucket: stream through the top bucket and
        concatenate on the device."""
        parts, rows_per = [], []
        for lo in range(0, rows, top):
            hi = min(lo + top, rows)
            rows_per.append(hi - lo)
            parts.append(self.run([a[lo:hi] for a in inputs]))
        outs = []
        for vals in zip(*parts):
            batched = all(v.ndim and v.shape[0] == r
                          for v, r in zip(vals, rows_per))
            outs.append(torch.cat(list(vals), dim=0) if batched else vals[0])
        return outs

    @property
    def trace_count(self) -> int:
        return len(self._cache)
