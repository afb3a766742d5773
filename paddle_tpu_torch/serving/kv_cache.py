"""Paged device-resident KV state for autoregressive serving (counterpart
of paddle_tpu/serving/kv_cache.py).

K/V live in one device-resident pool of fixed-size PAGES (vLLM's
PagedAttention layout) instead of one (batch, max_seq, heads, dim)
rectangle per request.  A host-side `PageTable` hands pages to sequences
at page granularity and takes them back at retirement, so device memory
held per request is proportional to its context length, rounded up to
one page.

Page 0 is reserved as a scratch page: masked lanes (inactive slots,
padded prefill positions) redirect their writes there, which keeps the
scatter shape static without corrupting live pages.

Multi-layer models share ONE pool and ONE PageTable: pass `num_layers=N`
and the pools grow a leading layer dim (N, num_pages, page_size, heads,
dim).  A page id then names the same row in every layer, so one
allocation covers the whole decoder stack.

`write_prefill` and `append_token` write the pool IN PLACE (index_copy_
on a flat (P*S, H, D) view) and return it.  The JAX package gets
in-place updates from buffer donation; building a new pool per layer per
step here would copy the whole pool every token.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import device as _device
from .admission import EngineOverloaded


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PageTable:
    """Host-side page allocator: seq_id -> list of device page ids.

    Thread-safe; raises a typed `EngineOverloaded("kv_pages", ...)`
    when the pool is exhausted instead of letting the device OOM."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("PageTable needs >= 2 pages (page 0 is "
                             "the reserved scratch page)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free: deque = deque(range(1, self.num_pages))
        self._owned: Dict[object, List[int]] = {}
        self._lock = threading.Lock()
        # device bytes per page, reported by the PagedKVCache backing
        # this table (0 for a table with no device pool, e.g. tests)
        self.bytes_per_page = 0

    def note_pool_bytes(self, pool_nbytes: int) -> None:
        """Record the device pool size backing this table so _publish
        can export `serving_kv_bytes` (bytes of in-use pages)."""
        self.bytes_per_page = int(pool_nbytes) // max(1, self.num_pages)
        with self._lock:
            self._publish()

    def pages_needed(self, n_tokens: int) -> int:
        return cdiv(max(1, int(n_tokens)), self.page_size)

    @property
    def capacity(self) -> int:
        return self.num_pages - 1  # page 0 reserved

    @property
    def available(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - self.available

    @property
    def seqs(self) -> int:
        """Live sequences holding pages."""
        with self._lock:
            return len(self._owned)

    def _publish(self) -> None:
        from ..profiler import stat_set

        used = self.capacity - len(self._free)
        stat_set("serving_kv_pages_in_use", used)
        stat_set("serving_kv_pages_capacity", self.capacity)
        if self.bytes_per_page:
            # bytes backing the pages currently handed out (the
            # admission-pressure view), not the whole pool
            stat_set("serving_kv_bytes", used * self.bytes_per_page)

    def allocate(self, seq_id, n_tokens: int) -> List[int]:
        """Pages covering `n_tokens`; all-or-nothing."""
        k = self.pages_needed(n_tokens)
        with self._lock:
            if seq_id in self._owned:
                raise ValueError(f"seq {seq_id!r} already holds pages")
            if len(self._free) < k:
                raise EngineOverloaded(
                    "kv_pages", self.capacity - len(self._free),
                    self.capacity,
                    detail=f"need {k} pages for {n_tokens} tokens")
            pages = [self._free.popleft() for _ in range(k)]
            self._owned[seq_id] = pages
            self._publish()
            return list(pages)

    def extend(self, seq_id, n: int = 1) -> List[int]:
        with self._lock:
            owned = self._owned.get(seq_id)
            if owned is None:
                raise KeyError(seq_id)
            if len(self._free) < n:
                raise EngineOverloaded(
                    "kv_pages", self.capacity - len(self._free),
                    self.capacity, detail="extend")
            pages = [self._free.popleft() for _ in range(n)]
            owned.extend(pages)
            self._publish()
            return pages

    def pages_of(self, seq_id) -> List[int]:
        with self._lock:
            return list(self._owned.get(seq_id, ()))

    def free(self, seq_id) -> int:
        """Return a sequence's pages to the pool (retirement)."""
        with self._lock:
            pages = self._owned.pop(seq_id, None)
            if pages is None:
                return 0
            self._free.extend(pages)
            self._publish()
            return len(pages)

    def rows(self, seq_id, width: int) -> np.ndarray:
        """(width,) int32 page-id row for the device page table;
        unused entries point at the scratch page 0.

        Width overflow raises typed `EngineOverloaded("kv_rows", ...)`:
        this runs mid-decode, where an untyped ValueError would kill the
        whole co-batched step; the engine handles it like pool
        exhaustion (retire or pause the one slot, keep the batch
        decoding)."""
        pages = self.pages_of(seq_id)
        if len(pages) > width:
            raise EngineOverloaded(
                "kv_rows", len(pages), width,
                detail=f"seq {seq_id!r} outgrew its page row "
                       "(raise max_pages_per_seq)")
        out = np.zeros((width,), np.int32)
        out[:len(pages)] = pages
        return out


class PagedKVCache:
    """Device-resident paged K/V pool.

    Single-layer (num_layers=None): k/v are (num_pages, page_size,
    num_heads, head_dim).  Multi-layer (num_layers=N): one leading layer
    dim, (N, num_pages, page_size, num_heads, head_dim), backed by ONE
    PageTable; a page id indexes the same row of every layer, so one
    allocation serves the whole decoder stack and `bytes_per_page`
    (hence serving_kv_bytes) counts all N layers of a handed-out page.

    The pools are zero-filled torch tensors on `device` (default cuda;
    raises without CUDA unless device="cpu"), `dtype` float32 unless
    given.  They are written in place by `write_prefill` and
    `append_token`.  The JAX package also registers its pools as a
    memory-ledger source (obs/memprof); the port has no memory ledger,
    so that source is left out."""

    def __init__(self, num_pages: int, page_size: int, num_heads: int,
                 head_dim: int, dtype: Optional[torch.dtype] = None,
                 num_layers: Optional[int] = None, device=None):
        dtype = dtype or torch.float32
        self.num_layers = num_layers
        self.table = PageTable(num_pages, page_size)
        shape = (num_pages, page_size, num_heads, head_dim)
        if num_layers is not None:
            if num_layers < 1:
                raise ValueError("num_layers must be >= 1")
            shape = (int(num_layers),) + shape
        dev = _device.resolve(device)
        self.k = torch.zeros(shape, dtype=dtype, device=dev)
        self.v = torch.zeros(shape, dtype=dtype, device=dev)
        nbytes = self.k.numel() * self.k.element_size()
        self.table.note_pool_bytes(2 * nbytes)

    @property
    def page_size(self) -> int:
        return self.table.page_size


# -- device-side page ops (in place) ----------------------------------------

def _as_index(t, device) -> torch.Tensor:
    """int64 index tensor on `device` from a tensor or a host array."""
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.asarray(t))
    return t.to(device=device, dtype=torch.int64)


def write_prefill(kc, vc, rows, length, k, v, start=0):
    """Scatter one sequence's prefill K/V into its pages, in place.

    kc/vc: (P, S, H, D) pools, or (L, P, S, H, D) multi-layer pools, in
    which case k/v carry a matching leading layer dim and one call
    scatters every layer through the SAME flat index (the page row is
    shared across layers).  rows: (max_pages,) int page ids; length:
    scalar (int or 0-d tensor); row i of k/v lands at global position
    start + i and rows with i >= length (padding) redirect to scratch
    page 0, rewriting the value already there; k/v: (Tb, H, D) (or
    (L, Tb, H, D)) padded K/V.  `start` is the chunk offset for chunked
    prefill.  Returns the (updated) pools."""
    P, S, H, D = kc.shape[-4:]
    dim = kc.dim() - 4  # the flat position axis: 1 if layered, else 0
    rows = _as_index(rows, kc.device)
    tb = k.shape[-3]
    pos = torch.arange(tb, device=kc.device)
    valid = pos < length
    gpos = start + pos
    # padded rows may run past the row; their index is redirected anyway
    page_ids = rows[(gpos // S).clamp(max=rows.shape[0] - 1)]
    flat_idx = torch.where(valid, page_ids * S + gpos % S,
                           torch.zeros_like(page_ids))
    sel = valid[:, None, None]
    for pool, new in ((kc, k), (vc, v)):
        flat = pool.view(*pool.shape[:-4], P * S, H, D)
        w = torch.where(sel, new.to(pool.dtype),
                        flat.index_select(dim, flat_idx))
        flat.index_copy_(dim, flat_idx, w)
    return kc, vc


def append_token(kc, vc, page_rows, positions, k, v, active):
    """Append one token's K/V per slot at `positions`, in place.

    kc/vc: (P, S, H, D) pools (one layer's plane of a multi-layer pool
    is such a view); page_rows: (B, max_pages) int; positions: (B,) int
    (the index the new token occupies); k/v: (B, H, D); active: (B,)
    bool; inactive slots redirect to scratch page 0 and rewrite its
    current value (a no-op).  Returns the (updated) pools."""
    P, S, H, D = kc.shape
    w = page_rows.shape[1]
    col = (positions.long() // S).clamp(max=w - 1)
    page_ids = torch.gather(page_rows.long(), 1, col[:, None])[:, 0]
    flat_idx = torch.where(active, page_ids * S + positions.long() % S,
                           torch.zeros_like(page_ids))
    kflat = kc.view(P * S, H, D)
    vflat = vc.view(P * S, H, D)
    sel = active[:, None, None]
    kw = torch.where(sel, k.to(kc.dtype), kflat.index_select(0, flat_idx))
    vw = torch.where(sel, v.to(vc.dtype), vflat.index_select(0, flat_idx))
    kflat.index_copy_(0, flat_idx, kw)
    vflat.index_copy_(0, flat_idx, vw)
    return kc, vc
