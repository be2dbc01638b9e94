"""Serving-plane observability: metrics registry, tracing, stats (a copy
of ``repro.obs``, which imports no jax but is reached through the
``repro`` package; the port keeps its own).

See docs/observability.md for the event taxonomy, span hierarchy and
exporter formats.  The port adds its own spans inside the engine step
and the forward (``PORT_SPAN_KINDS``, opened through ``host_span`` on
the recorder ``recording`` makes active) and the clock shared with a
``torch.profiler`` trace (``TraceRecorder.anchor``, ``clock_offset_us``,
``TraceRecorder.gaps_by_span``).
"""

from .metrics import Counter, Gauge, Histogram, MetricRegistry, bind_counters
from .stats import pctl_ms, percentiles, summarize, time_call
from .trace import (
    ANCHOR,
    LIFECYCLE_EVENTS,
    NULL_RECORDER,
    PORT_SPAN_KINDS,
    SPAN_KINDS,
    TraceRecorder,
    clock_offset_us,
    host_span,
    recording,
    validate_chrome_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "bind_counters",
    "pctl_ms",
    "percentiles",
    "summarize",
    "time_call",
    "ANCHOR",
    "LIFECYCLE_EVENTS",
    "NULL_RECORDER",
    "PORT_SPAN_KINDS",
    "SPAN_KINDS",
    "TraceRecorder",
    "clock_offset_us",
    "host_span",
    "recording",
    "validate_chrome_trace",
]
