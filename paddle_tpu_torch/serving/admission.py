"""Admission control: bounded queues fail fast instead of growing.

Copy of paddle_tpu/serving/admission.py: a loaded engine REJECTS new
work with a typed error the caller can catch and retry/shed — it never
grows its queue (host OOM).  The TensorFlow-Serving-style
bounded-batching-queue discipline.
"""

from __future__ import annotations

import threading


class EngineOverloaded(RuntimeError):
    """Raised when a bounded serving resource is at its limit.

    Fields:
      resource: which bound tripped ("queue", "kv_pages", "slots")
      depth:    current occupancy of the resource
      bound:    the configured limit
    """

    def __init__(self, resource: str, depth: int, bound: int,
                 detail: str = ""):
        self.resource = resource
        self.depth = depth
        self.bound = bound
        msg = (f"engine overloaded: {resource} at {depth}/{bound}"
               + (f" ({detail})" if detail else "")
               + " — shed load or raise the bound")
        super().__init__(msg)


class EngineClosed(RuntimeError):
    """Raised by submit() after shutdown() began."""


class RequestCancelled(RuntimeError):
    """Raised by Response.result() for a cancelled request."""


class AdmissionController:
    """Counting gate over one named bound.

    `admit()` raises EngineOverloaded at the bound; `release()` frees a
    unit.  The count is also mirrored to a profiler gauge when
    `gauge_stat` is given, so queue depth shows in get_int_stats()."""

    def __init__(self, bound: int, resource: str = "queue",
                 gauge_stat: str = None):
        self.bound = int(bound)
        self.resource = resource
        self._gauge = gauge_stat
        self._count = 0
        self._lock = threading.Lock()

    def _publish(self) -> None:
        if self._gauge is not None:
            from ..profiler import stat_set

            stat_set(self._gauge, self._count)

    def admit(self, n: int = 1) -> None:
        from ..profiler import stat_add

        with self._lock:
            if self._count + n > self.bound:
                stat_add("serving_rejected_total")
                raise EngineOverloaded(self.resource, self._count,
                                       self.bound)
            self._count += n
            self._publish()

    def release(self, n: int = 1) -> None:
        with self._lock:
            self._count = max(0, self._count - n)
            self._publish()

    @property
    def depth(self) -> int:
        with self._lock:
            return self._count
