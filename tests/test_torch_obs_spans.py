"""The port's spans inside the engine step and the forward
(``obs.PORT_SPAN_KINDS``) on the CPU with a tiny ``ContinuousEngine``:
tracing leaves the tokens as they were, every kind is recorded under the
parent it nests in, a decode forward opens ``layers * 5 + 3`` ``fwd.*``
spans that cover its time, the NULL handle allocates nothing, the anchor
places the recorder on a ``torch.profiler`` clock, ``gaps_by_span``
charges idle time to the innermost span, ``serve --profile`` writes one
merged trace, and the benchmark's recorder still charges every kernel
call to an engine phase while its new span readers read numbers."""

import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(__file__)
ROOT = os.path.normpath(os.path.join(HERE, os.pardir))
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "bench", "tests"))

from _torch_bridge import one_torch_thread  # noqa: E402,F401
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine  # noqa: E402

CFG = get_config("qwen2-0.5b").reduced()
ENGINE = dict(n_pages=12, page_size=16, max_batch=4, max_len=64,
              prefill_chunk_tokens=16, device="cpu")
PAGES = dict(prefix_cache=True)                 # the chat cell's path
CARRY = dict(decode_steps=2)
CONTEXTS = {"pages": PAGES, "carry": CARRY}

# the parents each kind nests in (its innermost enclosing span)
PARENTS = {
    "decode.stage": {"decode_dispatch"},
    "decode.forward": {"decode_dispatch"},
    "sync.decode_operands": {"decode.stage"},
    "sync.page_table": {"decode.stage"},
    "prefill.stage": {"prefill"},
    "prefill.forward": {"prefill"},
    "prefill.write": {"prefill"},
    "sync.chunk_operands": {"prefill.stage"},
    "sync.first_token": {"prefill"},
    "fwd.sample": {"decode.forward"},
    **{k: {"decode.forward", "prefill.forward"}
       for k in ("fwd.embed", "fwd.attn_in", "fwd.kv_write", "fwd.attn",
                 "fwd.attn_out", "fwd.mlp", "fwd.readout")},
}


@pytest.fixture(scope="module")
def params():
    return zoo.init_model(CFG, torch.Generator("cpu").manual_seed(0))


def _reqs():
    rng = np.random.default_rng(3)
    pre = rng.integers(0, CFG.vocab, 16)
    return [(np.concatenate([pre, rng.integers(0, CFG.vocab, n)])
             .astype(np.int32), g) for n, g in ((20, 6), (3, 4), (9, 5))]


def _serve(params, trace=None, **kw):
    eng = ContinuousEngine(CFG, params, trace=trace, **{**ENGINE, **kw})
    rids = [eng.submit(p, g) for p, g in _reqs()]
    out = eng.run()
    return [out[r] for r in rids], eng


def _spans(rec):
    return [e for e in rec.events() if e["ph"] == "X"]


def _parent(span, spans):
    """The innermost other span whose interval holds ``span``'s."""
    a, b = span["ts"], span["ts"] + span["dur"]
    outer = [s for s in spans if s is not span and s["ts"] <= a
             and s["ts"] + s["dur"] >= b]
    return max(outer, key=lambda s: (s["ts"], -s["dur"]), default=None)


@pytest.fixture(scope="module")
def traced(params):
    out = {}
    for name, kw in CONTEXTS.items():
        rec = obs.TraceRecorder()
        toks, eng = _serve(params, rec, **kw)
        out[name] = (toks, eng, rec)
    return out


@pytest.mark.parametrize("context", sorted(CONTEXTS))
def test_traced_tokens_equal_untraced(params, traced, context):
    plain, _ = _serve(params, **CONTEXTS[context])
    for got, want in zip(traced[context][0], plain):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("context", sorted(CONTEXTS))
def test_every_kind_recorded_and_nested(traced, context):
    """Every port kind appears (the pages context writes its chunk's KV
    inside the forward, so it has no ``prefill.write``) and sits in the
    parent the hierarchy names; the recorder stays the NULL one after
    the run."""
    _, _, rec = traced[context]
    spans = _spans(rec)
    kinds = {s["kind"] for s in spans}
    want = set(obs.PORT_SPAN_KINDS) - ({"prefill.write"}
                                       if context == "pages" else set())
    assert kinds & set(obs.PORT_SPAN_KINDS) == want
    assert obs.SPAN_KINDS == obs_trace.SPAN_KINDS
    assert not set(obs.PORT_SPAN_KINDS) & set(obs.SPAN_KINDS)
    for s in spans:
        if s["kind"] in PARENTS:
            parent = _parent(s, spans)
            assert parent is not None and \
                parent["kind"] in PARENTS[s["kind"]], (s["kind"], parent)
    assert obs_trace._active is obs.NULL_RECORDER


@pytest.mark.parametrize("context", sorted(CONTEXTS))
def test_fwd_spans_per_decode_forward(traced, context):
    """``layers * 5 + 3`` ``fwd.*`` spans per decode iteration (embed,
    five a layer, read-out, sample), K iterations per ``decode.forward``."""
    _, eng, rec = traced[context]
    spans = _spans(rec)
    per_iter = CFG.n_layers * 5 + 3
    forwards = [s for s in spans if s["kind"] == "decode.forward"]
    assert len(forwards) == eng.decode_dispatches > 0
    for f in forwards:
        kids = [s for s in spans if s["kind"].startswith("fwd.")
                and _parent(s, spans) is f]
        assert len(kids) == eng.decode_steps * per_iter, len(kids)


def test_fwd_children_cover_the_forward(traced):
    """The sub-block spans hold >= 90% of their forward's host time."""
    spans = _spans(traced["pages"][2])
    for kind in ("decode.forward", "prefill.forward"):
        total = covered = 0.0
        for f in (s for s in spans if s["kind"] == kind):
            total += f["dur"]
            covered += sum(s["dur"] for s in spans
                           if s["kind"].startswith("fwd.")
                           and _parent(s, spans) is f)
        assert total > 0 and covered / total >= 0.9, (kind, covered / total)


def test_null_handle_returns_the_shared_null_span():
    null = obs_trace._NULL_SPAN
    assert obs.host_span("fwd.attn") is null
    with obs.recording(obs.TraceRecorder(enabled=False)):
        assert obs.host_span("fwd.attn") is null
    rec = obs.TraceRecorder()
    rec.hist_registry = obs.MetricRegistry()
    with obs.recording(rec):
        with obs.host_span("fwd.attn") as s, rec.span("step"):
            assert s is not null
        with obs.recording(obs.NULL_RECORDER):
            assert obs.host_span("fwd.mlp") is null
    assert obs.host_span("fwd.attn") is null
    assert rec.count("fwd.attn") == 1 and rec.count("fwd.mlp") == 0
    snap = rec.hist_registry.snapshot()
    assert "span/step" in snap and "span/fwd.attn" not in snap


def test_anchor_puts_the_recorder_on_the_profiler_clock(tmp_path):
    """A recorder span and a profiler range opened at the same moment lie
    within 0.1 ms of each other once the anchor's offset is applied, in
    the offset export as well."""
    rec = obs.TraceRecorder()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        stamp = rec.anchor()
        for i in range(3):
            torch.ones(64).sum()
            with rec.span("step"), torch.profiler.record_function(f"r{i}"):
                torch.ones(64).sum()
    path = tmp_path / "cpu.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    off = obs.clock_offset_us(events, stamp)
    ranges = {e["name"]: e["ts"] for e in events
              if e.get("cat") == "user_annotation"}
    ours = [e for e in rec.chrome_trace(off)["traceEvents"]
            if e["name"] == "step"]
    assert len(ours) == 3
    for i, e in enumerate(ours):
        assert abs(e["ts"] - ranges[f"r{i}"]) < 100.0, (e["ts"],
                                                        ranges[f"r{i}"])
    with pytest.raises(ValueError, match="obs.anchor"):
        obs.clock_offset_us([], stamp)


def test_gaps_by_span_charges_the_innermost_span():
    """Synthetic trace, recorder 1000 µs behind it: each idle gap between
    two device operations goes to the innermost span open when it began,
    "none" outside every span."""
    rec = obs.TraceRecorder()
    clock = iter([0.0, 1e-3, 4e-3, 5e-3, 6e-3, 10e-3])
    rec._now = lambda: next(clock)
    with rec.span("step"):
        with rec.host_span("decode.forward"):
            pass
        with rec.host_span("sync.decode_operands"):
            pass

    def ev(cat, ts, dur):
        return {"ph": "X", "cat": cat, "name": cat, "ts": ts, "dur": dur}

    events = [{"ph": "M", "name": "process_name", "pid": 1},
              ev("cpu_op", 500.0, 14300.0),     # host time bounds nothing
              ev("kernel", 1000.0, 1500.0),
              ev("gpu_memcpy", 3000.0, 3300.0),
              ev("kernel", 3100.0, 100.0),
              ev("gpu_memset", 6800.0, 5200.0),
              ev("kernel", 13000.0, 500.0)]
    got = rec.gaps_by_span(events, 1000.0)
    want = {"decode.forward": 0.5e-3, "sync.decode_operands": 0.5e-3,
            "none": 1.0e-3}
    assert rec.gaps_by_span(events[:2], 1000.0) == {}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), (k, got[k])


def test_serve_profile_writes_one_merged_trace(monkeypatch, capsys,
                                               tmp_path):
    from repro_torch.launch import serve
    path = tmp_path / "prof.json"
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--reduced", "--batch", "2",
        "--prompt-len", "12", "--steps", "4", "--paged", "--n-pages", "8",
        "--prefill-chunk", "16", "--profile", str(path)])
    serve.main()
    out = capsys.readouterr().out
    assert f"to {path}" in out and "served 4 requests" in out
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {obs.ANCHOR, "decode.forward", "fwd.attn", "aten::mm"} <= names
    assert obs_trace._active is obs.NULL_RECORDER


def test_bench_recorder_keeps_every_call_in_an_engine_phase(params):
    """The benchmark's recorder pushes only ``span()`` kinds onto its
    phase stack: with the new spans open around the kernels, every call
    ``KernelCalls`` records is still charged to one of ``PHASES``."""
    from bench.tracing import PHASES, BenchRecorder, KernelCalls
    rec = BenchRecorder()
    eng = ContinuousEngine(CFG, params, trace=rec,
                           policy=PrecisionPolicy.paper_mixed(),
                           **{**ENGINE, **PAGES})
    calls = KernelCalls(rec, eng)
    rec.profiling = True
    try:
        for p, g in _reqs():
            eng.submit(p, g)
        eng.run()
    finally:
        rec.profiling = False
        calls.restore()
    kinds = {(c["kind"], c["phase"]) for c in rec.calls}
    assert {("rmmec", "prefill"), ("rmmec", "decode_dispatch"),
            ("attn_decode", "decode_dispatch"),
            ("attn_prefill", "prefill")} <= kinds, kinds
    assert {c["phase"] for c in rec.calls} <= set(PHASES)
    assert rec.phase == [] and rec.count("fwd.kv_write") > 0


def test_span_readers_read_a_cpu_harness_record():
    from _bench_tiny import small_traffic, tiny_cell
    from bench import harness
    with pytest.MonkeyPatch.context() as mp:
        small_traffic(mp)
        res = harness.run_cell(tiny_cell("deepseek-67b.chat"), 2**31 + 5,
                               1.0, True, "cpu", log=lambda m: None)
    rec = res["record"]
    got = {name: harness.read_metric(name, rec) for name in (
        "decode_enqueue_ms", "prefill_enqueue_ms_per_chunk",
        "sync_wait_ms_per_step", "kv_write_share", "decode_iter_ms")}
    for name, v in got.items():
        assert v is not None and v > 0, (name, v)
    assert got["kv_write_share"] < 100.0
    assert got["decode_enqueue_ms"] < got["decode_iter_ms"]
    assert harness.read_metric("host_us_per_launch", rec) is None
    rec["profile"] = {"kernels": {"decode_dispatch": 600}, "dispatches": 3}
    assert harness.read_metric("host_us_per_launch", rec) == \
        pytest.approx(1e3 * got["decode_enqueue_ms"] / 200)
    rec["spans"] = {k: v for k, v in rec["spans"].items()
                    if k in obs.SPAN_KINDS}          # the parent's record
    for name in got:
        if name != "decode_iter_ms":
            assert harness.read_metric(name, rec) is None, name
