"""Background checkpoint writer pool (a copy of paddle_tpu/ckpt/writer.py):
bounded in-flight snapshots with backpressure.

`submit()` hands a prepared write job to the writer thread and returns at
once; the device-to-host wait, serialization and file I/O overlap the
next steps.  At most `max_in_flight` snapshots may be pending; beyond
that `submit()` blocks (accounted as `ckpt_stall_ms`), so a slow disk
bounds host memory at K snapshots.  `wait()` drains the queue and
re-raises the first writer-thread exception, and so does the next
`submit()`: a failed checkpoint is a durability hole and is never
swallowed.

Counters: `ckpt_save_ms` (writer-thread wall time a job),
`ckpt_inflight` / `ckpt_inflight_max`; each job runs inside a
`ckpt.write` span flow-linked to the caller's `ckpt.snapshot` span.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, List, Optional

from .. import obs, profiler


class WriterPool:
    """One writer thread + a bounded job queue with backpressure."""

    def __init__(self, max_in_flight: int = 2, name: str = "ckpt-writer"):
        self.max_in_flight = max(1, int(max_in_flight))
        self._name = name
        self._jobs: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._active = 0
        self._errors: List[BaseException] = []
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    # -- caller side (training thread) ---------------------------------------
    def submit(self, job: Callable[[], None], flow: int = 0) -> None:
        """Enqueue one write job; blocks while `max_in_flight` jobs are
        pending.  Raises any error a previous job left behind."""
        with self._cond:
            self._raise_pending_locked()
            if self._in_flight_locked() >= self.max_in_flight:
                t0 = time.perf_counter()
                while (self._in_flight_locked() >= self.max_in_flight
                       and not self._closed):
                    self._cond.wait(timeout=0.1)
                profiler.time_add("ckpt_stall_ms",
                                  (time.perf_counter() - t0) * 1e3)
            if self._closed:
                raise RuntimeError("WriterPool is closed")
            self._jobs.append((job, flow))
            occ = self._in_flight_locked()
            profiler.stat_set("ckpt_inflight", occ)
            profiler.stat_max("ckpt_inflight_max", occ)
            self._cond.notify_all()
        self._ensure_thread()

    def wait(self) -> None:
        """Block until every submitted job finished, then surface the
        first writer-thread exception (cleared afterwards)."""
        with self._cond:
            while self._in_flight_locked() and not self._closed:
                self._cond.wait(timeout=0.1)
            self._raise_pending_locked()

    def close(self) -> None:
        """Drain outstanding writes, stop the thread, surface errors."""
        try:
            self.wait()
        finally:
            with self._cond:
                self._closed = True
                self._cond.notify_all()
            if self._thread is not None:
                self._thread.join(timeout=5)
                self._thread = None

    @property
    def in_flight(self) -> int:
        with self._cond:
            return self._in_flight_locked()

    # -- internals -----------------------------------------------------------
    def _in_flight_locked(self) -> int:
        return len(self._jobs) + self._active

    def _raise_pending_locked(self) -> None:
        if self._errors:
            err = self._errors[0]
            del self._errors[:]
            raise err

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name=self._name)
            self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._jobs and not self._closed:
                    self._cond.wait(timeout=0.1)
                if self._closed and not self._jobs:
                    return
                job, flow = self._jobs.popleft()
                self._active += 1
                profiler.stat_set("ckpt_inflight", self._in_flight_locked())
            try:
                with obs.span("ckpt.write", flow=flow), \
                        profiler.timed("ckpt_save_ms"):
                    job()
            except BaseException as e:  # noqa: BLE001 - surfaced on wait()
                with self._cond:
                    self._errors.append(e)
            finally:
                with self._cond:
                    self._active -= 1
                    profiler.stat_set("ckpt_inflight",
                                      self._in_flight_locked())
                    self._cond.notify_all()
