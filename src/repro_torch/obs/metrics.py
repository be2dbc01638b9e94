"""Typed metric registry for the serving plane (a copy of
``repro.obs.metrics``).

Three metric kinds:

- ``Counter``  — monotonically incremented int/float, resettable.
- ``Gauge``    — point-in-time value; either set explicitly or backed
  by a zero-arg callable (used for pool utilization, prefix hit rate
  and the closed-form byte/dispatch models, so the owning object's hot
  path is never touched).
- ``Histogram`` — fixed log-spaced buckets with p50/p95/p99 snapshots.
  Observations clamp into under/overflow buckets; percentile queries
  return the geometric midpoint of the covering bucket, clamped to the
  observed min/max.

``bind_counters`` migrates the legacy class-level ``_COUNTERS`` tuple
pattern onto the registry: it installs data descriptors on the class so
pre-existing call sites (``self.steps_run += 1``, ``setattr(self, c, 0)``
in ``reset_counters``, and plain attribute reads) keep working verbatim
while the values live in registry ``Counter`` objects.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Union

Number = Union[int, float]

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "bind_counters",
]


class Counter:
    kind = "counter"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def set(self, v: Number) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Counter({self.name}={self.value})"


class Gauge:
    kind = "gauge"
    __slots__ = ("name", "fn", "_value")

    def __init__(self, name: str, fn: Optional[Callable[[], Number]] = None):
        self.name = name
        self.fn = fn
        self._value: Number = 0

    @property
    def value(self) -> Number:
        if self.fn is not None:
            return self.fn()
        return self._value

    def set(self, v: Number) -> None:
        if self.fn is not None:
            raise ValueError(f"gauge {self.name} is callback-backed")
        self._value = v

    def reset(self) -> None:
        if self.fn is None:
            self._value = 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Gauge({self.name}={self.value})"


class Histogram:
    """Fixed log-bucket histogram over (lo, hi) with N buckets/decade."""

    kind = "histogram"

    def __init__(self, name: str, lo: float = 1e-7, hi: float = 1e4, per_decade: int = 8):
        if lo <= 0 or hi <= lo:
            raise ValueError("need 0 < lo < hi")
        self.name = name
        self.lo = lo
        self.per_decade = per_decade
        self.n_buckets = int(math.ceil(math.log10(hi / lo) * per_decade)) + 2
        self.counts: List[int] = [0] * self.n_buckets
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _bucket(self, v: float) -> int:
        if v < self.lo:
            return 0
        i = int(math.floor(math.log10(v / self.lo) * self.per_decade)) + 1
        return min(i, self.n_buckets - 1)

    def _edge(self, i: int) -> float:
        # Lower edge of bucket i (i >= 1); bucket 0 is underflow.
        return self.lo * 10.0 ** ((i - 1) / self.per_decade)

    def observe(self, v: Number) -> None:
        v = float(v)
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def percentile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = q / 100.0 * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                if i == 0:
                    return self.vmin
                mid = math.sqrt(self._edge(i) * self._edge(i + 1))
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax  # pragma: no cover - acc always reaches count

    @property
    def value(self) -> int:
        return self.count

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }

    def reset(self) -> None:
        self.counts = [0] * self.n_buckets
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Histogram({self.name}, n={self.count})"


class MetricRegistry:
    """Name -> metric map with get-or-create accessors.

    Metric names are slash-namespaced (``"engine/steps_run"``,
    ``"channel/handoff_bytes"``); one registry spans all layers of an
    engine so benches and exporters read from a single place.
    """

    def __init__(self):
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}

    def _get_or_create(self, name: str, kind, factory):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, kind):
                raise TypeError(f"metric {name} is {m.kind}, wanted {kind.__name__.lower()}")
            return m
        m = factory()
        self._metrics[name] = m
        return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name))

    def gauge(self, name: str, fn: Optional[Callable[[], Number]] = None) -> Gauge:
        g = self._get_or_create(name, Gauge, lambda: Gauge(name, fn))
        if fn is not None and g.fn is None:
            g.fn = fn
        return g

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get_or_create(name, Histogram, lambda: Histogram(name, **kw))

    def get(self, name: str):
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def value(self, name: str) -> Number:
        return self._metrics[name].value

    def snapshot(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[name] = m.snapshot() if isinstance(m, Histogram) else m.value
        return out

    def reset(self) -> None:
        """Zero counters/histograms and set-gauges; fn-gauges are live."""
        for m in self._metrics.values():
            m.reset()

    def prometheus_text(self, prefix: str = "repro") -> str:
        """Prometheus text-exposition snapshot of every metric."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            pname = _sanitize(f"{prefix}_{name}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_fmt(m.value)}")
            else:
                lines.append(f"# TYPE {pname} summary")
                for q in (0.5, 0.95, 0.99):
                    lines.append(f'{pname}{{quantile="{q}"}} {_fmt(m.percentile(q * 100))}')
                lines.append(f"{pname}_sum {_fmt(m.total)}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + "\n"


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _fmt(v: Number) -> str:
    if isinstance(v, float) and not v.is_integer():
        return repr(v)
    return str(int(v))


class _CounterAttr:
    """Data descriptor routing a legacy counter attribute to the registry.

    Installed on the owning class by ``bind_counters``; takes priority
    over the instance ``__dict__`` so ``self.x += 1`` and
    ``setattr(self, x, 0)`` write through to the bound ``Counter``.
    """

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj._obs_counters[self.name].value

    def __set__(self, obj, value) -> None:
        obj._obs_counters[self.name].set(value)


def bind_counters(obj, registry: MetricRegistry, namespace: str,
                  names: Optional[Iterable[str]] = None) -> None:
    """Bind ``obj``'s legacy ``_COUNTERS`` attributes onto ``registry``.

    Each name becomes a ``Counter`` called ``"<namespace>/<name>"``,
    initialised to zero.  Descriptor installation on the class is
    idempotent; the per-instance binding lives in ``obj._obs_counters``.
    """
    cls = type(obj)
    names = tuple(names if names is not None else getattr(cls, "_COUNTERS", ()))
    for n in names:
        if not isinstance(getattr(cls, n, None), _CounterAttr):
            setattr(cls, n, _CounterAttr(n))
    bound = {}
    for n in names:
        c = registry.counter(f"{namespace}/{n}")
        c.reset()
        bound[n] = c
    obj._obs_counters = bound
