"""Process-wide counters and millisecond timers (copy of the StatRegistry
half of paddle_tpu/profiler/__init__.py).

`stat_add`/`stat_set`/`stat_max` bump named integer counters and gauges
(the feed pipeline's `ring_occupancy` / `ring_occupancy_max`,
`prefetch_depth`, `in_flight_steps`), `time_add`/`time_set`/`timed`
accumulate milliseconds on named pipeline stages, and `count_sync`
counts device->host materializations.  `get_int_stats()` /
`get_time_stats()` snapshot them.  `timed` also records its interval as
an obs span when tracing is on.
"""

from __future__ import annotations

import contextlib
import threading
import time

_STATS: dict = {}
_TIMES: dict = {}
_STATS_LOCK = threading.Lock()


def stat_add(name: str, value: int = 1) -> None:
    """Bump a named global counter."""
    with _STATS_LOCK:
        _STATS[name] = _STATS.get(name, 0) + int(value)


def stat_set(name: str, value: int) -> None:
    with _STATS_LOCK:
        _STATS[name] = int(value)


def stat_max(name: str, value: int) -> None:
    """Raise a named gauge to `value` if it is below it."""
    with _STATS_LOCK:
        _STATS[name] = max(_STATS.get(name, 0), int(value))


def stat_reset(name: str = None) -> None:
    """Clear one counter, or all of them."""
    with _STATS_LOCK:
        if name is None:
            _STATS.clear()
        else:
            _STATS.pop(name, None)


def get_int_stats() -> dict:
    """Snapshot of every counter."""
    with _STATS_LOCK:
        return dict(_STATS)


def time_add(name: str, ms: float) -> None:
    """Accumulate `ms` milliseconds on a named pipeline stage."""
    with _STATS_LOCK:
        _TIMES[name] = _TIMES.get(name, 0.0) + float(ms)


def time_set(name: str, ms: float) -> None:
    with _STATS_LOCK:
        _TIMES[name] = float(ms)


def time_reset(name: str = None) -> None:
    with _STATS_LOCK:
        if name is None:
            _TIMES.clear()
        else:
            _TIMES.pop(name, None)


def get_time_stats() -> dict:
    """Snapshot of the pipeline stage accumulators, in milliseconds."""
    with _STATS_LOCK:
        return dict(_TIMES)


@contextlib.contextmanager
def timed(name: str):
    """Accumulate the with-block's wall time onto `name` (ms); with span
    tracing on, the interval is recorded as a span too."""
    from .obs.tracing import TRACER

    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        time_add(name, dt * 1e3)
        TRACER.add_span(name, t0, dt)


def count_sync(n: int = 1) -> None:
    """Record a device->host materialization (the serving completer is
    the one sanctioned site)."""
    stat_add("executor_sync_count", n)
