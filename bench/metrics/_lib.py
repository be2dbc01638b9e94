"""Shared arithmetic of the metric readers.  A reader takes the run's
record (``harness._record``: host-clock token stamps relative to the
window's opening, counters at its two ends, per-step work, with
``--trace 1`` the engine's spans and the profiler's reduction) and
returns one number, or None where the record holds nothing to read."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["window", "ttft_ms", "itl_ms", "p95", "counter", "roofline",
           "percent", "least_s", "prefill_ms_per_ktok"]


def window(rec) -> float:
    return rec["window"][1] - rec["window"][0]


def ttft_ms(rec) -> List[float]:
    """Submit -> first token of every request sent in the window; one
    that never had its first token counts from its submit to the last
    stamp the run made."""
    t0, t1 = rec["window"]
    last = max((t for r in rec["requests"] for t in r["times"][-1:]),
               default=t1)
    return [((r["times"][0] if r["times"] else last) - r["submit"]) * 1e3
            for r in rec["requests"] if t0 <= r["submit"] <= t1]


def itl_ms(rec) -> List[float]:
    """Every gap between two consecutive tokens of one request, both
    stamped inside the window."""
    t0, t1 = rec["window"]
    out = []
    for r in rec["requests"]:
        ts = [t for t in r["times"] if t0 <= t <= t1]
        out.extend((b - a) * 1e3 for a, b in zip(ts, ts[1:]))
    return out


def p95(values) -> Optional[float]:
    """The 95th percentile (numpy's linear interpolation)."""
    return float(np.percentile(values, 95)) if len(values) else None


def counter(rec, name: str) -> Optional[float]:
    if name not in rec["counters1"]:
        return None
    return rec["counters1"][name] - rec["counters0"][name]


def percent(num: float, den: float) -> Optional[float]:
    return 100.0 * num / den if den > 0 else None


def roofline(rec, kind: str, phase: str) -> Optional[float]:
    """Σ least time / Σ device time of ``kind``'s calls launched under
    ``phase`` in the profiler window, in percent."""
    prof = rec.get("profile") or {}
    d = (prof.get("rooflines") or {}).get(kind, {}).get(phase)
    if not d or not d["calls"] or d["device_s"] <= 0:
        return None
    return 100.0 * d["bound_s"] / d["device_s"]


def least_s(rec) -> float:
    """Σ over the window's steps of the step's least time on the card
    (``bench.roofline.Model.step``)."""
    from bench.roofline import Model, bound
    model = Model(**rec["model"])
    return sum(bound(*model.step(s["chunks"], s["sampled"],
                                 s["positions"]))[0] for s in rec["steps"])


def prefill_ms_per_ktok(rec) -> Optional[float]:
    """Milliseconds of the engine's prefill spans per 1000 prompt tokens
    it computed in the window."""
    n = counter(rec, "prefill_tokens_computed")
    s = (rec.get("spans") or {}).get("prefill")
    return s["seconds"] * 1e6 / n if s and n else None
