"""Span tracer: thread-local span stacks + cross-thread flow links.

The observability tentpole (ISSUE 6): one causal trace format for the
whole stack.  The TF paper (arxiv 1605.08695) treats runtime tracing as
a first-class system concern — the trace must show a training step or a
serving request END TO END, across the batcher/dispatch/completer/
feed-ring threads, not as disconnected per-thread timelines.  This
module is the substrate:

* **Spans** — named wall-time intervals.  `Tracer.span(name)` returns a
  context manager; `__enter__` pushes it on the calling thread's span
  stack, `__exit__` pops and records it, so nesting is correct by
  construction even when the body raises.  `add_span(name, t0, dur)`
  records retroactively (for sites that only know a span happened after
  the fact, e.g. "the batcher just handed me a coalesced batch").

* **Flow links** — `new_flow()` mints a process-unique id; any span may
  carry one or more flow ids.  Spans sharing a flow id are causally
  linked across threads: the exporter emits Chrome-trace flow events
  ("s"/"t"/"f") so Perfetto draws arrows from the feed producer to the
  consuming dispatch, and from a serving request's admission through
  coalesce -> dispatch -> complete.

* **Near-zero disabled overhead** — `span()` returns the shared
  `NULL_SPAN` singleton when disabled (no allocation, no lock), and
  `add_span` is a single attribute check.  The hot-path contract
  (docs/async_hot_path.md) is untouched: tracing never syncs, never
  transfers, and disabled-mode counters are asserted flat in tests.

* **Bounded buffer** — a long traced run cannot grow host memory
  without limit; overflow is counted (`dropped`), never silent.

stdlib-only, a copy of paddle_tpu/obs/tracing.py: the port keeps its
own tracer and imports nothing of the JAX package.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

DEFAULT_CAPACITY = 200_000

FlowArg = Union[int, Iterable[int], None]


def _flow_tuple(flow: FlowArg) -> Tuple[int, ...]:
    if not flow:
        return ()
    if isinstance(flow, int):
        return (flow,)
    return tuple(f for f in flow if f)


class _NullSpan:
    """Shared no-op span handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, key, value):
        return self

    def add_flow(self, flow):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One live span (context manager).  Records itself on exit."""

    __slots__ = ("_tracer", "name", "t0", "flows", "attrs")

    def __init__(self, tracer: "Tracer", name: str,
                 flows: Tuple[int, ...], attrs: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.flows = flows
        self.attrs = attrs
        self.t0 = 0.0

    def set_attr(self, key, value):
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value
        return self

    def add_flow(self, flow: FlowArg):
        self.flows = self.flows + _flow_tuple(flow)
        return self

    def __enter__(self):
        self._tracer._stack().append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        stack = self._tracer._stack()
        # pop self even if an inner span leaked (exception unwound past
        # a begin without end); everything above self closes with us so
        # the stack cannot corrupt across requests
        while stack:
            if stack.pop() is self:
                break
        self._tracer._record(self.name, self.t0, dur, self.flows,
                             self.attrs)
        return False


class Tracer:
    """Span buffer + per-thread stacks + flow id allocator."""

    # flow ids remembered as incomplete once the buffer starts dropping
    # their spans; bounded so a pathological run cannot grow the set
    DROPPED_FLOWS_CAP = 8192

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self.capacity = int(capacity)
        self.dropped = 0
        self._lock = threading.Lock()
        # records: (name, tid, thread_name, t0, dur, flows, attrs)
        self._spans: List[tuple] = []
        # flow ids that lost >=1 span to a buffer drop: their exported
        # flow arrows would dangle (e.g. an "f" finish whose "s" start
        # never made it into the buffer), so export suppresses them
        self._dropped_flows: set = set()
        self._tls = threading.local()
        self._flow_ids = itertools.count(1)

    # -- lifecycle ---------------------------------------------------------
    def enable(self, reset: bool = False) -> None:
        if reset:
            self.reset()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._spans = []
            self.dropped = 0
            self._dropped_flows = set()

    # -- span API ----------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_span(self) -> Optional[Span]:
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    def new_flow(self) -> int:
        """Mint a process-unique flow id (cheap; safe while disabled)."""
        return next(self._flow_ids)

    def span(self, name: str, flow: FlowArg = None,
             attrs: Optional[dict] = None):
        """Context manager for one span; NULL_SPAN while disabled."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, _flow_tuple(flow), attrs)

    def add_span(self, name: str, t0: float, dur: float,
                 flow: FlowArg = None, attrs: Optional[dict] = None) -> None:
        """Record a span retroactively (t0/dur in perf_counter seconds)."""
        if not self.enabled:
            return
        self._record(name, t0, dur, _flow_tuple(flow), attrs)

    def attach_flow(self, flow: FlowArg) -> None:
        """Attach flow id(s) to the innermost open span, if any."""
        cur = self.current_span()
        if cur is not None:
            cur.add_flow(flow)

    def _record(self, name, t0, dur, flows, attrs) -> None:
        th = threading.current_thread()
        with self._lock:
            if len(self._spans) >= self.capacity:
                self.dropped += 1
                if flows and len(self._dropped_flows) < \
                        self.DROPPED_FLOWS_CAP:
                    # this flow is now incomplete: a surviving span of
                    # it must not export a dangling flow arrow
                    self._dropped_flows.update(flows)
                return
            self._spans.append((name, th.ident, th.name, t0, dur,
                                flows, attrs))

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def records(self) -> List[tuple]:
        with self._lock:
            return list(self._spans)

    def summary(self) -> Dict[str, Any]:
        """Aggregate view for obs.snapshot(): per-name totals, thread
        count, flow count, drop counter."""
        recs = self.records()
        with self._lock:
            dropped_flows = set(self._dropped_flows)
        by_name: Dict[str, Dict[str, float]] = {}
        tids = set()
        flows = set()
        for name, tid, tname, _t0, dur, fls, _attrs in recs:
            # the OS reuses thread idents after a thread exits; the
            # (ident, name) pair keeps short-lived threads distinct
            tids.add((tid, tname))
            flows.update(fls)
            e = by_name.setdefault(name, {"count": 0, "total_ms": 0.0,
                                          "max_ms": 0.0})
            e["count"] += 1
            ms = dur * 1e3
            e["total_ms"] += ms
            if ms > e["max_ms"]:
                e["max_ms"] = ms
        for e in by_name.values():
            e["total_ms"] = round(e["total_ms"], 3)
            e["max_ms"] = round(e["max_ms"], 3)
        return {"count": len(recs), "dropped": self.dropped,
                "threads": len(tids), "flows": len(flows),
                # flows whose arrows the exporter suppresses because
                # the buffer dropped part of them mid-run
                "orphaned_flows": len(flows & dropped_flows),
                "by_name": by_name}

    # -- export ------------------------------------------------------------
    def chrome_trace(self, other_data: Optional[dict] = None) -> dict:
        """The recorded spans as a chrome://tracing / Perfetto document:
        one "X" complete event per span on a per-thread track, "M"
        thread_name metadata, and "s"/"t"/"f" flow events linking spans
        that share a flow id (the cross-thread arrows)."""
        recs = self.records()
        with self._lock:
            dropped_flows = set(self._dropped_flows)
        # track key is (ident, thread name): idents are reused once a
        # thread exits, and two engine threads must never share a track
        tid_map: Dict[tuple, int] = {}
        tname: Dict[int, str] = {}
        events: List[dict] = []
        flow_spans: Dict[int, List[tuple]] = {}
        for name, tid, thread_name, t0, dur, flows, attrs in recs:
            vt = tid_map.setdefault((tid, thread_name), len(tid_map))
            tname.setdefault(vt, thread_name)
            ev = {"ph": "X", "cat": "span", "name": name,
                  "ts": t0 * 1e6, "dur": dur * 1e6, "pid": 0, "tid": vt}
            if attrs:
                ev["args"] = dict(attrs)
            events.append(ev)
            for f in flows:
                flow_spans.setdefault(f, []).append((t0, dur, vt))
        for vt, nm in tname.items():
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": vt, "args": {"name": nm}})
        orphaned = 0
        for fid, spans in flow_spans.items():
            if fid in dropped_flows:
                # the buffer dropped part of this flow: whichever span
                # survived would emit a dangling arrow (e.g. an "f"
                # finish with no "s" start) — drop the flow's events
                # entirely and count it
                orphaned += 1
                continue
            if len(spans) < 2:
                continue  # a link needs two ends
            spans.sort()
            for i, (t0, dur, vt) in enumerate(spans):
                if i == 0:
                    # start: emitted from inside the producing span
                    ev = {"ph": "s", "ts": (t0 + dur) * 1e6 - 0.01}
                elif i == len(spans) - 1:
                    ev = {"ph": "f", "bp": "e", "ts": t0 * 1e6 + 0.01}
                else:
                    ev = {"ph": "t", "ts": t0 * 1e6 + 0.01}
                ev.update({"cat": "flow", "name": "flow", "id": fid,
                           "pid": 0, "tid": vt})
                events.append(ev)
        other = {"producer": "paddle_tpu_torch.obs",
                 "dropped_events": self.dropped,
                 "orphaned_flows": orphaned}
        if other_data:
            other.update(other_data)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": other}

    def export(self, path: str, other_data: Optional[dict] = None) -> int:
        """Write the Chrome-trace JSON to `path`; returns the number of
        span ("X") events written."""
        doc = self.chrome_trace(other_data)
        with open(path, "w") as f:
            json.dump(doc, f)
        return sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")


# the process-wide tracer every paddle_tpu_torch subsystem records into
TRACER = Tracer()
