"""Request-lifecycle tracing and step-span timelines (a copy of
``repro.obs.trace``).

``TraceRecorder`` captures two things into one bounded ring buffer:

- **lifecycle events** — instant markers for a request's progress
  through the serving plane::

      SUBMIT -> ADMIT -> PREFILL_CHUNK... -> PREFILL_COMPLETE
             -> HANDOFF -> DECODE_DISPATCH / DECODE_SYNC
             -> RETIRE | PREEMPT | BOUNCE

- **spans** — durations of engine step phases (``capacity`` / ``admit``
  / ``prefill`` / ``decode_dispatch`` / ``decode_sync``) and channel
  push/pull, recorded via the ``span()`` context manager.

The ring is bounded (``capacity`` entries, default 64Ki); the oldest
entries are evicted under pressure.  Per-kind event **counts** and the
sums of numeric event args are kept in separate monotonic accumulators
that never evict, so closed-form tie-outs (decode dispatches
``(gen-1)/K``, handoff bytes ``pages * page_handoff_bytes``) hold
regardless of ring capacity.

A disabled recorder (``NULL_RECORDER``) costs one predicted branch per
telemetry call; it records nothing and its ``span()`` returns a shared
no-op context manager.  Telemetry never touches device math — all
recording is host-side bookkeeping after values already exist.

Exports: Chrome trace-event JSON (open in Perfetto / chrome://tracing),
a JSONL event stream, and SLO metrics (TTFT, TPOT, queue wait, prefill
stall, end-to-end) derived from lifecycle timestamps.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, List, Optional

from .stats import summarize

__all__ = [
    "LIFECYCLE_EVENTS",
    "SPAN_KINDS",
    "TraceRecorder",
    "NULL_RECORDER",
    "validate_chrome_trace",
]

LIFECYCLE_EVENTS = (
    "SUBMIT",
    "ADMIT",
    "PREFILL_CHUNK",
    "PREFILL_COMPLETE",
    "HANDOFF",
    "DECODE_DISPATCH",
    "DECODE_SYNC",
    "RETIRE",
    "PREEMPT",
    "BOUNCE",
)

SPAN_KINDS = (
    "step",
    "capacity",
    "admit",
    "prefill",
    "decode_dispatch",
    "decode_sync",
    "channel_push",
    "channel_pull",
)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("rec", "kind", "rid", "args", "t0")

    def __init__(self, rec: "TraceRecorder", kind: str, rid, args):
        self.rec = rec
        self.kind = kind
        self.rid = rid
        self.args = args

    def __enter__(self):
        self.t0 = self.rec._now()
        return self

    def __exit__(self, *exc):
        self.rec._end_span(self)
        return False


class TraceRecorder:
    """Bounded-ring recorder for lifecycle events and phase spans."""

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        self.enabled = enabled
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._counts: Dict[str, int] = {}
        self._sums: Dict[str, float] = {}
        self.dropped = 0
        # Optional MetricRegistry: span durations are also observed into
        # "span/<kind>" histograms there, so the Prometheus snapshot
        # carries phase-latency percentiles.
        self.hist_registry = None
        self._t0 = time.perf_counter()

    # -- recording ---------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def event(self, kind: str, rid: Optional[int] = None, **args) -> None:
        """Record an instant lifecycle event. No-op when disabled."""
        if not self.enabled:
            return
        self._counts[kind] = self._counts.get(kind, 0) + 1
        for k, v in args.items():
            if isinstance(v, (int, float)):
                key = f"{kind}.{k}"
                self._sums[key] = self._sums.get(key, 0) + v
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append({"ph": "i", "ts": self._now(), "kind": kind,
                           "rid": rid, "args": args})

    def span(self, kind: str, rid: Optional[int] = None, **args):
        """Context manager timing a phase. No-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, kind, rid, args)

    def _end_span(self, s: _Span) -> None:
        t1 = self._now()
        self._counts[s.kind] = self._counts.get(s.kind, 0) + 1
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append({"ph": "X", "ts": s.t0, "dur": t1 - s.t0,
                           "kind": s.kind, "rid": s.rid, "args": s.args})
        if self.hist_registry is not None:
            self.hist_registry.histogram(f"span/{s.kind}").observe(t1 - s.t0)

    def clear(self) -> None:
        self._ring.clear()
        self._counts.clear()
        self._sums.clear()
        self.dropped = 0
        self._t0 = time.perf_counter()

    # -- queries -----------------------------------------------------

    def __len__(self) -> int:
        return len(self._ring)

    def count(self, kind: str) -> int:
        """Exact number of events/spans of ``kind`` (eviction-proof)."""
        return self._counts.get(kind, 0)

    def arg_sum(self, kind: str, key: str) -> float:
        """Exact sum of a numeric event arg (eviction-proof)."""
        return self._sums.get(f"{kind}.{key}", 0)

    def events(self, kind: Optional[str] = None,
               rid: Optional[int] = None) -> List[dict]:
        out = []
        for e in self._ring:
            if kind is not None and e["kind"] != kind:
                continue
            if rid is not None and e["rid"] != rid:
                continue
            out.append(e)
        return out

    # -- SLO derivation ----------------------------------------------

    def request_slo(self) -> Dict[int, Dict[str, float]]:
        """Per-request latency metrics (ms) from lifecycle timestamps.

        - ``queue_wait_ms``    = ADMIT - SUBMIT
        - ``ttft_ms``          = PREFILL_COMPLETE - SUBMIT (the first
          token is sampled from the prefill logits)
        - ``prefill_stall_ms`` = PREFILL_COMPLETE - ADMIT
        - ``e2e_ms``           = RETIRE - SUBMIT
        - ``tpot_ms``          = (RETIRE - PREFILL_COMPLETE) / (gen - 1)

        Derived from ring contents; requests whose SUBMIT was evicted
        are skipped.
        """
        first: Dict[int, Dict[str, float]] = {}
        last_retire: Dict[int, dict] = {}
        for e in self._ring:
            rid = e["rid"]
            if rid is None or e["ph"] != "i":
                continue
            kinds = first.setdefault(rid, {})
            if e["kind"] not in kinds:
                kinds[e["kind"]] = e["ts"]
            if e["kind"] == "RETIRE":
                last_retire[rid] = e
        out: Dict[int, Dict[str, float]] = {}
        for rid, kinds in first.items():
            if "SUBMIT" not in kinds:
                continue
            sub = kinds["SUBMIT"]
            rec: Dict[str, float] = {}
            if "ADMIT" in kinds:
                rec["queue_wait_ms"] = (kinds["ADMIT"] - sub) * 1e3
            if "PREFILL_COMPLETE" in kinds:
                pc = kinds["PREFILL_COMPLETE"]
                rec["ttft_ms"] = (pc - sub) * 1e3
                if "ADMIT" in kinds:
                    rec["prefill_stall_ms"] = (pc - kinds["ADMIT"]) * 1e3
            if rid in last_retire:
                ret = last_retire[rid]
                rec["e2e_ms"] = (ret["ts"] - sub) * 1e3
                gen = ret["args"].get("generated", 0)
                if gen > 1 and "PREFILL_COMPLETE" in kinds:
                    rec["tpot_ms"] = (ret["ts"] - kinds["PREFILL_COMPLETE"]) * 1e3 / (gen - 1)
            if rec:
                out[rid] = rec
        return out

    def slo_summary(self) -> Dict[str, Dict[str, float]]:
        """Aggregate p50/p95/p99 over every per-request SLO metric."""
        cols: Dict[str, List[float]] = {}
        for rec in self.request_slo().values():
            for k, v in rec.items():
                cols.setdefault(k, []).append(v)
        return {k: summarize(v) for k, v in sorted(cols.items())}

    # -- exporters ---------------------------------------------------

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable).

        One process; tid 0 is the engine step lane, tid ``rid + 1`` is
        the per-request lane.  Spans are ``ph="X"`` complete events,
        lifecycle events are ``ph="i"`` instants; timestamps in µs.
        """
        evs: List[dict] = [
            {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "repro-serve"}},
            {"ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
             "args": {"name": "engine"}},
        ]
        rids = sorted({e["rid"] for e in self._ring if e["rid"] is not None})
        for rid in rids:
            evs.append({"ph": "M", "pid": 0, "tid": int(rid) + 1,
                        "name": "thread_name",
                        "args": {"name": f"req {rid}"}})
        for e in self._ring:
            rid = e["rid"]
            tid = 0 if rid is None else int(rid) + 1
            args = dict(e["args"])
            if rid is not None:
                args["rid"] = int(rid)
            out = {"name": e["kind"], "pid": 0, "tid": tid,
                   "ts": e["ts"] * 1e6, "args": args}
            if e["ph"] == "X":
                out["ph"] = "X"
                out["cat"] = "span"
                out["dur"] = e["dur"] * 1e6
            else:
                out["ph"] = "i"
                out["cat"] = "lifecycle"
                out["s"] = "t"
            evs.append(out)
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def write_jsonl(self, path: str) -> None:
        """One JSON object per ring entry, in recording order."""
        with open(path, "w") as f:
            for e in self._ring:
                f.write(json.dumps(e) + "\n")


NULL_RECORDER = TraceRecorder(capacity=0, enabled=False)


def validate_chrome_trace(obj: dict) -> Dict[str, int]:
    """Schema-check a Chrome trace-event JSON object.

    Raises ``ValueError`` on the first violation; returns counts of
    spans / instants / metadata events when valid.  This is what
    ``bench_serve.py --smoke`` and the CI trace step run against
    emitted artifacts, so a malformed export fails loudly rather than
    silently rendering empty in Perfetto.
    """
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"), list):
        raise ValueError("top level must be an object with a traceEvents list")
    n = {"X": 0, "i": 0, "M": 0}
    for idx, e in enumerate(obj["traceEvents"]):
        where = f"traceEvents[{idx}]"
        if not isinstance(e, dict):
            raise ValueError(f"{where}: not an object")
        ph = e.get("ph")
        if ph not in ("X", "i", "M", "B", "E", "C"):
            raise ValueError(f"{where}: bad ph {ph!r}")
        if not isinstance(e.get("name"), str) or not e["name"]:
            raise ValueError(f"{where}: missing name")
        for k in ("pid", "tid"):
            if not isinstance(e.get(k), int):
                raise ValueError(f"{where}: missing int {k}")
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where}: bad dur {dur!r}")
        n[ph] = n.get(ph, 0) + 1
    return {"spans": n["X"], "instants": n["i"], "metadata": n["M"],
            "total": len(obj["traceEvents"])}
