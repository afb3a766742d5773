"""Bounded LRU for built entries (a copy of
paddle_tpu/fluid/compile_cache.py): the Executor keeps one entry per
(program id and version, feed signature, fetch list, scope), and evicts
the least recently used past its capacity.

Every operation takes the lock; the training executor is single-threaded
per instance, so it is uncontended there.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Iterator, Optional


class CompileCache:
    """Bounded LRU for compiled entries.

    `stat_prefix` wires hit/miss/eviction counters into
    paddle_tpu_torch.profiler (`<prefix>_cache_hits`,
    `<prefix>_cache_misses`, `<prefix>_cache_evictions`) so cache
    behavior is observable wherever the tenant lives.
    """

    def __init__(self, capacity: int, stat_prefix: Optional[str] = None,
                 on_evict: Optional[Callable[[Any, Any], None]] = None):
        if capacity < 1:
            raise ValueError(f"CompileCache capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = capacity
        self._od: "collections.OrderedDict[Any, Any]" = \
            collections.OrderedDict()
        self._lock = threading.RLock()
        self._stat_prefix = stat_prefix
        # eviction must release what the entry holds (device tensors);
        # the callback runs outside the lock, and its exceptions are
        # swallowed (accounting must never break a put)
        self._on_evict = on_evict

    def _stat(self, name: str) -> None:
        if self._stat_prefix is not None:
            from ..profiler import stat_add

            stat_add(f"{self._stat_prefix}_cache_{name}")

    def get(self, key) -> Optional[Any]:
        """Entry for `key` (refreshing recency) or None."""
        with self._lock:
            entry = self._od.get(key)
            if entry is not None:
                self._od.move_to_end(key)
                self._stat("hits")
            return entry

    def put(self, key, value) -> None:
        evicted = []
        with self._lock:
            self._od[key] = value
            self._od.move_to_end(key)
            while len(self._od) > self.capacity:
                evicted.append(self._od.popitem(last=False))
                self._stat("evictions")
        if self._on_evict is not None:
            for ekey, evalue in evicted:
                try:
                    self._on_evict(ekey, evalue)
                except Exception:  # noqa: BLE001 - see __init__
                    pass

    def get_or_build(self, key, builder: Callable[[], Any]) -> Any:
        """Entry for `key`, building (and caching) it on miss.

        The builder runs OUTSIDE the lock, so it does not serialize
        unrelated lookups.  Two threads racing the same key may both
        build; last-put wins (the entries are identical)."""
        entry = self.get(key)
        if entry is not None:
            return entry
        self._stat("misses")
        entry = builder()
        self.put(key, entry)
        return entry

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._od

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def __iter__(self) -> Iterator:
        with self._lock:
            return iter(list(self._od))

    def keys(self):
        with self._lock:
            return list(self._od)

    def values(self):
        with self._lock:
            return list(self._od.values())

    def items(self):
        with self._lock:
            return list(self._od.items())

    def clear(self) -> None:
        with self._lock:
            self._od.clear()
