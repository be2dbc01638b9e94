"""Each metric reader against a recorded fixture, and the profiler's
reduction against a hand-made Chrome trace."""

from __future__ import annotations

import math

import pytest

from bench import harness
from bench.tracing import reduce_trace


def _ev(cat, name, ts, dur=0.0, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


TRACE = [
    _ev("user_annotation", "bench.window", 0.0, 1000.0),
    _ev("user_annotation", "step", 50.0, 900.0),
    _ev("user_annotation", "prefill", 100.0, 300.0),
    _ev("user_annotation", "decode_dispatch", 500.0, 300.0),
    _ev("user_annotation", "bench.rmmec", 110.0, 40.0),
    _ev("user_annotation", "bench.rmmec", 510.0, 30.0),
    _ev("cuda_runtime", "cudaLaunchKernel", 120.0, 5.0, corr=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 520.0, 5.0, corr=2),
    _ev("cuda_driver", "cuLaunchKernelEx", 600.0, 5.0, corr=3),
    _ev("kernel", "tile_kernel", 200.0, 100.0, corr=1),
    _ev("kernel", "split_k_kernel", 550.0, 50.0, corr=2),
    _ev("kernel", "decode_page_kernel", 610.0, 20.0, corr=3),
    _ev("gpu_memcpy", "Memcpy DtoH", 900.0, 10.0),
    _ev("kernel", "outside", 1200.0, 10.0, corr=9),
]


def test_reduce_trace_by_hand():
    r = reduce_trace(TRACE)
def _record():
    """A two-second window: three requests, four steps."""
    reqs = [
        {"submit": -1.0, "prompt": 100, "times": [-0.5, 0.5, 1.0, 1.5]},
        {"submit": 0.2, "prompt": 50, "times": [0.5, 0.5, 1.0, 2.5]},
        {"submit": 1.0, "prompt": 80, "times": [2.2]},
    ]
    steps = [
        {"start": 0.0, "end": 0.5, "positions": [10, 20],
         "admitted_prompt_tokens": 50, "chunks": [(0, 50)], "sampled": 1},
        {"start": 0.5, "end": 1.0, "positions": [11, 21, 5],
         "admitted_prompt_tokens": 0, "chunks": [], "sampled": 0},
        {"start": 1.0, "end": 1.5, "positions": [],
         "admitted_prompt_tokens": 80, "chunks": [(256, 30)], "sampled": 0},
        {"start": 1.5, "end": 2.0, "positions": [12],
         "admitted_prompt_tokens": 0, "chunks": [], "sampled": 0},
    ]
    model = {"weight_bytes": 3.35e9, "flops_per_token": 1e9,
             "readout_flops": 1e8, "attn_layers": 2,
             "attn_flops_per_pair": 100.0, "kv_slot_bytes": 0.0,
             "state_bytes": 0.0}
    prof = {"window_s": 2.0, "busy_s": 1.5, "kernels": {"decode_dispatch": 30},
            "dispatches": 3,
            "rooflines": {"rmmec": {
                "prefill": {"bound_s": 0.01, "calls": 4, "device_s": 0.1},
                "decode_dispatch": {"bound_s": 0.02, "calls": 8,
                                    "device_s": 0.5}}}}
    return {"cell": "x", "max_batch": 4, "window": [0.0, 2.0],
            "setup_s": 12.5, "requests": reqs, "steps": steps,
            "counters0": {"prefill_tokens_computed": 100,
                          "decode_dispatches": 7, "prefix_hit_tokens": 256},
            "counters1": {"prefill_tokens_computed": 180,
                          "decode_dispatches": 10, "prefix_hit_tokens": 320},
            "unanswered": 0, "model": model, "profile": prof,
            "spans": {"prefill": {"seconds": 0.4, "count": 2},
                      "decode_dispatch": {"seconds": 0.3, "count": 3},
                      "decode_sync": {"seconds": 0.15, "count": 3}}}


EXPECT = {
    # tokens stamped in [0, 2]: 3 + 3 = 6 over 2 s
    "output_tok_s": 3.0,
    # first tokens in the window: request 1 (50) only
    "prompt_tok_s": 25.0,
    # requests sent in the window: 0.3 s and 1.2 s
    "ttft_p95_ms.chat": 300.0 + 0.95 * 900.0,
    # gaps inside the window: 500, 500 (req 0); 0, 500 (req 1)
    "itl_p95_ms": 500.0,
    "setup_s": 12.5,
    "prefill_ms_per_ktok": 0.4 * 1e6 / 80,
    "prefill_ms_per_ktok.stateful": 0.4 * 1e6 / 80,
    "decode_iter_ms": 0.45 * 1e3 / 3,
    "decode_slot_share": 100.0 * 6 / (3 * 4),
    "prefix_hit_share": 100.0 * 64 / 130,
    "launches_per_decode_iter": 10.0,
    "rmmec_roofline.prefill": 10.0,
    "rmmec_roofline.decode": 4.0,
    "idle_share.chat": 25.0,
    "mfu.chat": None,                       # worked out in the test
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader(name):
    rec = _record()
    got = harness.read_metric(name, rec)
    if name == "mfu.chat":
        # per step the larger of operations / 989e12 and bytes / 3.35e12
        ops = [50e9 + 1275 * 100 * 2 + 1e8, 3 * 1.1e9 + 50 * 100 * 2,
               30e9 + (30 * 256 + 465) * 100 * 2, 1.1e9 + 13 * 100 * 2]
        nbytes = [2 * 3.35e9, 3.35e9, 3.35e9, 3.35e9]
        least = sum(max(o / 989e12, b / 3.35e12)
                    for o, b in zip(ops, nbytes))
        assert math.isclose(got, 100 * least / 2.0)
    else:
        assert math.isclose(got, EXPECT[name]), (name, got)


@pytest.mark.parametrize("name", ["attn_roofline.decode",
                                  "attn_roofline.prefill",
                                  "dequant_roofline", "prefix_hit_share",
                                  "mfu.chat", "idle_share.chat"])
def test_reader_finds_nothing(name):
    """A reader with nothing to read returns None, never 0."""
    rec = _record()
    rec["profile"] = None
    rec["counters0"].pop("prefix_hit_tokens")
    rec["counters1"].pop("prefix_hit_tokens")
    for s in rec["steps"]:
        s.pop("chunks")
    assert harness.read_metric(name, rec) is None


def test_stateful_tails_read_as_the_end_to_end_ones():
    rec = _record()
    assert harness.read_metric("itl_p95_ms.stateful", rec) == \
        harness.read_metric("itl_p95_ms", rec)
    assert harness.read_metric("ttft_p95_ms.stateful", rec) == \
        harness.read_metric("ttft_p95_ms.chat", rec)


def test_metrics_of_a_cell():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["y"]}],
             "per_layer": [{"name": "p", "moves": "a", "workloads": ["x"]},
                           {"name": "q", "moves": "b"},
                           {"name": "r", "moves": "a"}]}
    names = lambda c, t: [m["name"] for m in harness.metrics_of(bench, c, t)]
    assert names("x", False) == ["a"] and names("y", False) == ["a", "b"]
    assert names("x", True) == ["p", "r"] and names("y", True) == ["q", "r"]
