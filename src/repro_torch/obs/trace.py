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
  push/pull, recorded via the ``span()`` context manager; and the
  port's finer spans (``PORT_SPAN_KINDS``) inside those phases, down to
  the sub-blocks of each layer, which model code opens through
  ``host_span()`` on the recorder that the engine step made active
  (``recording()``), so that no recorder is threaded through the
  forward.

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
optionally on the clock of a ``torch.profiler`` trace (``anchor()`` and
``clock_offset_us()``) so that one file holds the host's spans and the
card's kernels, the card's idle time by the span the host was in
(``gaps_by_span()``), and SLO metrics (TTFT, TPOT, queue wait, prefill
stall, end-to-end) derived from lifecycle timestamps.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import torch

from .stats import summarize

__all__ = [
    "LIFECYCLE_EVENTS",
    "SPAN_KINDS",
    "PORT_SPAN_KINDS",
    "ANCHOR",
    "TraceRecorder",
    "NULL_RECORDER",
    "recording",
    "host_span",
    "clock_offset_us",
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

# The port's own spans, host time only (none touches the device).  They
# nest inside the engine phases above:
#   decode_dispatch > decode.stage > sync.decode_operands, sync.page_table
#   decode_dispatch > decode.forward > fwd.*
#   prefill > prefill.stage > sync.chunk_operands
#   prefill > prefill.forward > fwd.*;  prefill > prefill.write
#   prefill > sync.first_token
# A ``sync.*`` span holds exactly one call that can make the host wait
# for the card, so its length is that wait.  ``fwd.*`` spans are one per
# sub-block and layer: ``fwd.embed``, then per attention layer
# ``fwd.attn_in`` (pre-norm, q/k/v, RoPE), ``fwd.kv_write`` (the pool
# write), ``fwd.attn`` (the attention kernel), ``fwd.attn_out`` (output
# projection and residual add), and per block with an FFN or MoE
# ``fwd.mlp``; ``fwd.readout`` (final norm and read-out) and, in the
# decode loop, ``fwd.sample`` (sampler and done-logic).
PORT_SPAN_KINDS = (
    "decode.stage",
    "decode.forward",
    "prefill.stage",
    "prefill.forward",
    "prefill.write",
    "sync.decode_operands",
    "sync.page_table",
    "sync.chunk_operands",
    "sync.first_token",
    "fwd.embed",
    "fwd.attn_in",
    "fwd.kv_write",
    "fwd.attn",
    "fwd.attn_out",
    "fwd.mlp",
    "fwd.readout",
    "fwd.sample",
)

# name of the profiler range that ``TraceRecorder.anchor`` opens
ANCHOR = "obs.anchor"


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


class _HostSpan(_Span):
    """A ``host_span``: recorded like any span, but observed into no
    histogram (there are a few hundred a step)."""

    __slots__ = ()

    def __exit__(self, *exc):
        self.rec._record_span(self)
        return False


_NO_ARGS: dict = {}


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

    def host_span(self, kind: str):
        """Context manager timing one of the port's ``PORT_SPAN_KINDS``
        on the host: no request id, no args, no histogram.  No-op when
        disabled.  Model code reaches it through the module-level
        ``host_span``; a subclass that extends ``span`` leaves it be."""
        if not self.enabled:
            return _NULL_SPAN
        return _HostSpan(self, kind, None, _NO_ARGS)

    def _end_span(self, s: _Span) -> None:
        dur = self._record_span(s)
        if self.hist_registry is not None:
            self.hist_registry.histogram(f"span/{s.kind}").observe(dur)

    def _record_span(self, s: _Span) -> float:
        dur = self._now() - s.t0
        self._counts[s.kind] = self._counts.get(s.kind, 0) + 1
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append({"ph": "X", "ts": s.t0, "dur": dur,
                           "kind": s.kind, "rid": s.rid, "args": s.args})
        return dur

    def anchor(self) -> float:
        """This recorder's time (s), read as a zero-length profiler range
        ``ANCHOR`` opens: while ``torch.profiler`` runs, the range puts
        that instant on the profiler's clock (``clock_offset_us``).  A
        first range of the same name goes before it: a session's first
        range starts tens to hundreds of µs late, later ones within a
        few µs of a clock read taken just before them."""
        with torch.profiler.record_function(ANCHOR):
            pass
        t = self._now()
        with torch.profiler.record_function(ANCHOR):
            pass
        return t

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

    def chrome_trace(self, offset_us: float = 0.0) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable).

        One process; tid 0 is the engine step lane, tid ``rid + 1`` is
        the per-request lane.  Spans are ``ph="X"`` complete events,
        lifecycle events are ``ph="i"`` instants; timestamps in µs,
        shifted by ``offset_us`` (``clock_offset_us``: the events then
        lie on a ``torch.profiler`` trace's clock and can join its
        ``traceEvents``).
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
                   "ts": e["ts"] * 1e6 + offset_us, "args": args}
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

    def gaps_by_span(self, trace_events: Sequence[dict],
                     offset_us: float) -> Dict[str, float]:
        """The card's idle seconds in a ``torch.profiler`` Chrome trace,
        keyed by the innermost span of this recorder open on the host
        when each gap began ("none" where no span was open).  The card
        is busy where a kernel, copy or memset runs; a gap lies between
        two such operations (the profiler's start and stop fall outside
        them).  ``offset_us`` places this recorder's spans on the
        trace's clock (``clock_offset_us``)."""
        busy = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in trace_events
                      if e.get("cat") in ("kernel", "gpu_memcpy",
                                          "gpu_memset"))
        gaps, at = [], busy[0][1] if busy else 0.0
        for t0, t1 in busy[1:]:
            if t0 > at:
                gaps.append((at, t0))
            at = max(at, t1)
        spans = sorted((e["ts"] * 1e6 + offset_us, -e["dur"] * 1e6,
                        e["kind"]) for e in self._ring if e["ph"] == "X")
        starts = [t0 for t0, _, _ in spans]
        reach, far = [], float("-inf")      # latest end among spans[:i+1]
        for t0, neg_dur, _ in spans:
            far = max(far, t0 - neg_dur)
            reach.append(far)
        out: Dict[str, float] = {}
        for a, b in gaps:
            # spans nest, so the open span that began last is innermost
            kind = "none"
            i = bisect.bisect_right(starts, a) - 1
            while i >= 0 and reach[i] > a:
                t0, neg_dur, k = spans[i]
                if t0 - neg_dur > a:
                    kind = k
                    break
                i -= 1
            out[kind] = out.get(kind, 0.0) + (b - a) * 1e-6
        return out


NULL_RECORDER = TraceRecorder(capacity=0, enabled=False)

_active: TraceRecorder = NULL_RECORDER


@contextlib.contextmanager
def recording(rec: TraceRecorder):
    """Make ``rec`` the recorder ``host_span`` opens spans on, for the
    block; the one active before comes back after it.  One active
    recorder per process: the engines step on one thread."""
    global _active
    prev, _active = _active, rec
    try:
        yield rec
    finally:
        _active = prev


def host_span(kind: str):
    """A span of ``kind`` on the active recorder (``recording``); the
    shared no-op span while ``NULL_RECORDER`` (the default) is active."""
    return _active.host_span(kind)


def clock_offset_us(trace_events: Sequence[dict], stamp: float) -> float:
    """µs to add to this recorder's times (s × 1e6) to place them on the
    clock of a ``torch.profiler`` Chrome trace: the start of the trace's
    last ``ANCHOR`` range less ``stamp``, the value ``anchor()`` returned
    while the profiler ran."""
    starts = [float(e["ts"]) for e in trace_events
              if e.get("name") == ANCHOR and e.get("ph") == "X"]
    if not starts:
        raise ValueError(f"the trace has no {ANCHOR!r} range: call "
                         f"TraceRecorder.anchor() while the profiler runs")
    return max(starts) - stamp * 1e6


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
