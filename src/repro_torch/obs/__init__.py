"""Serving-plane observability: metrics registry, tracing, stats (a copy
of ``repro.obs``, which imports no jax but is reached through the
``repro`` package; the port keeps its own).

See docs/observability.md for the event taxonomy, span hierarchy and
exporter formats.
"""

from .metrics import Counter, Gauge, Histogram, MetricRegistry, bind_counters
from .stats import pctl_ms, percentiles, summarize, time_call
from .trace import (
    LIFECYCLE_EVENTS,
    NULL_RECORDER,
    SPAN_KINDS,
    TraceRecorder,
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
    "LIFECYCLE_EVENTS",
    "NULL_RECORDER",
    "SPAN_KINDS",
    "TraceRecorder",
    "validate_chrome_trace",
]
