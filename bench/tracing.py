"""What the traced run records besides the host clock.

``BenchRecorder`` is the program's ``TraceRecorder`` with two
additions: it keeps per window step the prefill chunks and first tokens
(for ``mfu``), and it knows the engine phase the host is in, so a
kernel call can be charged to it.

While the profiler runs, each engine span is also a profiler range of
its name, and ``KernelCalls`` wraps the program's four kernel entry
points the cells drive (``rmmec_matmul``, ``paged_flash_decode``,
``paged_flash_prefill``, ``dequant``): each call runs inside a profiler
range ``bench.<kind>`` and leaves its phase and its operations and
bytes (``roofline``).

``Profile`` runs ``torch.profiler`` over the profiled steps that follow
the window and reduces its Chrome trace (``reduce_trace``): each kernel
is charged, through its launch's correlation id, to the ranges open on
the host when it was launched.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Sequence

import torch

from . import roofline

__all__ = ["BenchRecorder", "KernelCalls", "Profile", "reduce_trace",
           "PHASES"]

PHASES = ("capacity", "admit", "prefill", "decode_dispatch", "decode_sync",
          "step")
ANCHOR = "bench.window"


def BenchRecorder():
    """A ``TraceRecorder`` (see the module docstring)."""
    from repro_torch.obs import TraceRecorder

    class _Phase:
        def __init__(self, rec, kind, inner):
            self.rec, self.kind, self.inner, self.rf = rec, kind, inner, None

        def __enter__(self):
            self.rec.phase.append(self.kind)
            if self.rec.profiling:
                self.rf = torch.profiler.record_function(self.kind)
                self.rf.__enter__()
            self.inner.__enter__()
            return self

        def __exit__(self, *exc):
            self.inner.__exit__(*exc)
            if self.rf is not None:
                self.rf.__exit__(*exc)
            self.rec.phase.pop()
            return False

    class _Rec(TraceRecorder):
        def __init__(self):
            super().__init__(capacity=1 << 20)
            self.phase: List[str] = []
            self.profiling = False
            self.calls: List[dict] = []
            self.pending: List[dict] = []
            self.chunks: List[tuple] = []     # (start, real) this step
            self.sampled = 0                  # first tokens this step

        def span(self, kind, rid=None, **args):
            return _Phase(self, kind, super().span(kind, rid, **args))

        def event(self, kind, rid=None, **args):
            super().event(kind, rid, **args)
            if kind == "PREFILL_CHUNK":
                self.chunks.append((int(args["start"]), int(args["real"])))
                for call in self.pending:
                    call["flops"], call["bytes"] = roofline.paged_prefill(
                        start=int(args["start"]), **call.pop("shape"))
                    self.calls.append(call)
                self.pending.clear()
            elif kind == "PREFILL_COMPLETE":
                self.sampled += 1

        def take_step(self) -> dict:
            out = {"chunks": self.chunks, "sampled": self.sampled}
            self.chunks, self.sampled = [], 0
            return out

    return _Rec()


class KernelCalls:
    """Wraps the program's kernel entry points for the profiled steps;
    ``restore`` puts them back."""

    def __init__(self, rec, eng):
        self.rec, self.eng = rec, eng
        self._orig = []
        from repro_torch.kernels import ops
        from repro_torch.models import attention, moe
        self._wrap(ops, "rmmec_matmul", "rmmec", self._rmmec)
        self._wrap(attention, "paged_flash_decode", "attn_decode",
                   self._decode)
        self._wrap(attention, "paged_flash_prefill", "attn_prefill", None)
        self._wrap(moe, "dequant", "dequant", self._dequant)

    def _wrap(self, mod, name, kind, count):
        orig = getattr(mod, name, None)
        if orig is None:
            return
        rec = self.rec

        def wrapped(*a, **kw):
            if not rec.profiling:
                return orig(*a, **kw)
            with torch.profiler.record_function(f"bench.{kind}"):
                out = orig(*a, **kw)
            call = {"kind": kind, "phase": rec.phase[-1] if rec.phase
                    else "harness"}
            if count is None:               # the chunk's start comes later
                q, ks = a[0], a[2]
                _, c, kh, g, dh = q.shape
                call["shape"] = dict(c=c, kh=kh, g=g, dh=dh, gs=ks.shape[-1],
                                     q_bytes=q.element_size())
                rec.pending.append(call)
            else:
                call["flops"], call["bytes"] = count(*a, **kw)
                rec.calls.append(call)
            return out

        setattr(mod, name, wrapped)
        self._orig.append((mod, name, orig))

    @staticmethod
    def _rmmec(x, words, scales, mask, spec, n=None):
        n = n if n is not None else words.shape[-1] * (32 // spec.bits)
        return roofline.rmmec(x.shape[0], x.shape[1], n, x.element_size(),
                              spec.bits, scales.shape[0])

    def _decode(self, q, k_codes, k_scale, *rest, **kw):
        b, kh, g, dh = q.shape
        pos = self.eng.last_positions
        live = sum(p + 1 for p in pos) + (b - len(pos))
        return roofline.paged_decode(b, kh, g, dh, k_scale.shape[-1], live,
                                     q.element_size())

    @staticmethod
    def _dequant(t, dtype=torch.float32):
        k, n = t.shape
        return roofline.dequant(k, n, t.spec.bits, t.scales.shape[0],
                                2 if dtype == torch.bfloat16 else 4)

    def restore(self):
        for mod, name, orig in self._orig:
            setattr(mod, name, orig)
        self._orig.clear()


class Profile:
    """``start`` and ``stop`` the profiler around the profiled steps;
    ``reduce`` afterwards."""

    def __init__(self, rec):
        self.rec = rec
        self.prof = None
        self.rf = None

    @staticmethod
    def warm():
        """Initialise the profiler once in set-up (CUPTI's first start)."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.ones(8, device="cuda").sum().item()

    def start(self):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.rf = torch.profiler.record_function(ANCHOR)
        self.rf.__enter__()
        self.rec.profiling = True

    def stop(self):
        torch.cuda.synchronize()
        self.rec.profiling = False
        self.rf.__exit__(None, None, None)
        self.prof.stop()

    def reduce(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        return reduce_trace(events)


class _Intervals:
    """The profiler ranges of each name, on the trace's clock (µs)."""

    def __init__(self, events: Sequence[dict]):
        by: Dict[str, list] = {}
        for e in events:
            if e.get("cat") == "user_annotation":
                t = float(e["ts"])
                by.setdefault(e["name"], []).append(
                    (t, t + float(e.get("dur", 0.0))))
        self.by = {}
        for name, iv in by.items():
            iv.sort()
            self.by[name] = ([a for a, _ in iv], [b for _, b in iv])

    def inside(self, name: str, t: float) -> bool:
        starts, ends = self.by.get(name, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and ends[i] >= t

    def first(self, names, t: float, default=None):
        return next((n for n in names if self.inside(n, t)), default)

    def count(self, name: str) -> int:
        return len(self.by.get(name, ((),))[0])


KINDS = ("bench.rmmec", "bench.attn_decode", "bench.attn_prefill",
         "bench.dequant")


def reduce_trace(events: List[dict], top: int = 10) -> dict:
    """The profiled steps from a Chrome trace (µs): device time by
    (kernel call kind, engine phase), kernels by phase, busy and window
    seconds, top device operations and the longest idle gaps.  A kernel
    is charged to the profiler ranges open on the host when it was
    launched (its launch found by correlation id)."""
    ranges = _Intervals(events)
    if not ranges.count(ANCHOR):
        return {}
    w0, w1 = ranges.by[ANCHOR][0][0], ranges.by[ANCHOR][1][0]
    launch: Dict[int, float] = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[int(corr)] = float(e["ts"])
    by_kind: Dict[str, Dict[str, float]] = {}
    kernels: Dict[str, int] = {}
    ops: Dict[str, float] = {}
    busy: List[tuple] = []
    unattributed = 0
    for e in events:
        cat = e.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if ts + dur < w0 or ts > w1:
            continue
        busy.append((max(ts, w0), min(ts + dur, w1)))
        ops[e["name"]] = ops.get(e["name"], 0.0) + dur
        corr = (e.get("args") or {}).get("correlation")
        at = launch.get(int(corr)) if corr is not None else None
        if at is None:
            unattributed += 1
            continue
        phase = ranges.first(PHASES, at, "harness")
        if cat == "kernel":
            kernels[phase] = kernels.get(phase, 0) + 1
        kind = ranges.first(KINDS, at)
        if kind is not None:
            kind = kind[len("bench."):]
            d = by_kind.setdefault(kind, {})
            d[phase] = d.get(phase, 0.0) + dur * 1e-6
    busy.sort()
    merged: List[list] = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append([ranges.first(PHASES, a, "harness"),
                         (b - a) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in merged) * 1e-6,
        "by_kind": by_kind,
        "kernels": kernels,
        "dispatches": ranges.count("decode_dispatch"),
        "unattributed": unattributed,
        "top_ops": [[n[:160], s * 1e-6] for n, s in
                    sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": gaps[:top],
    }
