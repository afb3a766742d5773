"""paddle_tpu_torch.obs — span tracing (counterpart of paddle_tpu/obs).

Only the span surface is ported in this slice: `span`, `add_span` and the
process-wide `TRACER` (obs/tracing.py, copied; `TRACER.enable()` turns
recording on, `TRACER.chrome_trace()` exports).  Telemetry, cost
attribution and device profiling come in later slices.
"""

from __future__ import annotations

from typing import Optional

from .tracing import TRACER

__all__ = ["span", "add_span", "TRACER"]


def span(name: str, flow=None, attrs: Optional[dict] = None):
    """Context manager recording one span on this thread's track; the
    shared no-op singleton while tracing is disabled."""
    return TRACER.span(name, flow=flow, attrs=attrs)


def add_span(name: str, t0: float, dur: float, flow=None,
             attrs: Optional[dict] = None) -> None:
    """Record a span retroactively (perf_counter seconds)."""
    TRACER.add_span(name, t0, dur, flow=flow, attrs=attrs)
