"""Comparisons made in turns on one card (card only).

  PYTHONPATH=src python -m repro_torch.benchmarks.in_turns attention \
      TREE_A TREE_B [TREE_B TREE_A ...]
  PYTHONPATH=src python -m repro_torch.benchmarks.in_turns engines
  PYTHONPATH=src python -m repro_torch.benchmarks.in_turns serve \
      TREE_A TREE_B [TREE_B TREE_A ...]

``attention``: the Dh 64 attention kernels' times (``flash_decode`` at
``chip_smoke.py`` phase 2's shapes, ``paged_flash_decode`` and
``paged_flash_prefill`` at phase 2b's) of each checkout in the order
given, one process each (a checkout is a directory holding
``chip_smoke.py`` and ``src/repro_torch``, e.g. a ``git archive`` of
another commit), so two commits compare on one card as A, B, B, A.

``engines``: ``ContinuousEngine`` and ``DisaggEngine`` (K=4) in the
order continuous, disagg, disagg, continuous on phase 3b's weights and
traffic: wall time and, per decode iteration, the host time of the
decode loop's dispatch, the decode dispatch and sync spans and the
prefill spans.

``serve``: qwen2-0.5b served by each checkout in the order given, one
process each: the static engine at phase 3's shape (B=8, prompt 128, 32
steps) with ``paper_mixed`` packed weights and with unpacked bf16 ones,
ms per decode step; then ``ContinuousEngine`` at K=1 and K=4 on phase
3b's weights, pool and traffic, wall and ms per decode iteration.

All print CSV rows ``name,value,derived`` and the card's name and power
limit last.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

_ATTENTION = """
import json, os, sys
tree = os.path.abspath(sys.argv[1])
sys.path[:0] = [os.path.join(tree, "src"), tree]
import numpy as np, torch
import chip_smoke as cs
cs.phase_build()
summary, fails = {}, []
cs.phase_flash(summary, fails)
gen = torch.Generator("cuda").manual_seed(4)
d, p = cs._paged_times("", gen, np.random.default_rng(4), 8, 2, 7, 64, 128, 8)
print("RESULT " + json.dumps({"flash_decode": summary["flash_decode"]["ms"],
                             "paged_flash_decode": d["ms"],
                             "paged_flash_prefill": p["ms"],
                             "fails": fails}))
"""


_SERVE = """
import json, os, sys, time
tree = os.path.abspath(sys.argv[1])
sys.path[:0] = [os.path.join(tree, "src"), tree]
import numpy as np, torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.models import zoo
from repro_torch.obs import TraceRecorder
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
cs.phase_build()
cfg = get_config("qwen2-0.5b")
res = {}
toks = np.random.default_rng(0).integers(0, cfg.vocab, (8, 128))
for name, policy in (("static_packed", PrecisionPolicy.paper_mixed()),
                     ("static_unpacked", None)):
    params = zoo.init_model(cfg, torch.Generator("cuda").manual_seed(0))
    eng = ServeEngine(cfg, params, max_len=256, quantized_kv=True,
                      policy=policy)
    del params
    eng.generate(toks, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(toks, 0)
    torch.cuda.synchronize()
    prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.generate(toks, 32)
    torch.cuda.synchronize()
    res[name + "_ms_per_step"] = (time.perf_counter() - t0 - prefill) / 32 * 1e3
    del eng
params = zoo.pack_params(
    zoo.init_model(cfg, torch.Generator("cuda").manual_seed(0)),
    PrecisionPolicy.paper_mixed())
kw = dict(max_len=1024, page_size=128, max_batch=8,
          prefill_chunk_tokens=256, prefix_cache=True, sync_guard=True)
warm = ContinuousEngine(cfg, params, n_pages=8, decode_steps=1, **kw)
rng = np.random.default_rng(1)
for n in (300, 40):
    warm.submit(rng.integers(0, cfg.vocab, n), 3)
warm.run()
reqs = cs._continuous_traffic(cfg.vocab)
for k in (1, 4):
    rec = TraceRecorder()
    eng = ContinuousEngine(cfg, params, n_pages=20, decode_steps=k,
                           trace=rec, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs._serve_continuous(eng, reqs)
    torch.cuda.synchronize()
    res[f"continuous_k{k}_wall_s"] = time.perf_counter() - t0
    iters = eng.decode_dispatches * k
    res[f"continuous_k{k}_ms_per_decode_iteration"] = sum(
        e["dur"] for n in ("decode_dispatch", "decode_sync")
        for e in rec.events(n)) * 1e3 / iters
print("RESULT " + json.dumps(res))
"""


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def attention(trees) -> None:
    for i, tree in enumerate(trees):
        out = subprocess.run([sys.executable, "-c", _ATTENTION, tree],
                             capture_output=True, text=True, check=True,
                             timeout=900).stdout
        res = json.loads(out.split("RESULT ", 1)[1])
        if res.pop("fails"):
            raise RuntimeError(f"{tree}: kernel checks failed")
        for name, ms in res.items():
            print(f"attention/{name},{ms:.5f},turn={i};tree={tree}",
                  flush=True)


def serve(trees) -> None:
    for i, tree in enumerate(trees):
        out = subprocess.run([sys.executable, "-c", _SERVE, tree],
                             capture_output=True, text=True, check=True,
                             timeout=900).stdout
        for name, v in json.loads(out.split("RESULT ", 1)[1]).items():
            print(f"serve/{name},{v:.4f},turn={i};tree={tree}", flush=True)


def engines() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from ..configs import get_config
    from ..core.policy import PrecisionPolicy
    from ..models import zoo
    from ..obs import TraceRecorder
    from ..serve import disagg as D
    from ..serve import engine as E
    cs.phase_build()
    cfg = get_config("qwen2-0.5b")
    params = zoo.pack_params(
        zoo.init_model(cfg, torch.Generator("cuda").manual_seed(0)),
        PrecisionPolicy.paper_mixed())
    kw = dict(max_len=1024, page_size=128, max_batch=8,
              prefill_chunk_tokens=256, prefix_cache=True, decode_steps=4,
              sync_guard=True)
    reqs = cs._continuous_traffic(cfg.vocab)
    loop_s = [0.0]
    dispatch = E._dispatch_decode_loop

    def timed(*a, **k):
        t = time.perf_counter()
        out = dispatch(*a, **k)
        loop_s[0] += time.perf_counter() - t
        return out

    E._dispatch_decode_loop = D._dispatch_decode_loop = timed
    try:
        warm = E.ContinuousEngine(cfg, params, n_pages=8,
                                  **{**kw, "decode_steps": 1})
        rng = np.random.default_rng(1)
        for n in (300, 40):
            warm.submit(rng.integers(0, cfg.vocab, n), 3)
        warm.run()
        for i, which in enumerate(("continuous", "disagg", "disagg",
                                   "continuous")):
            rec = TraceRecorder()
            eng = E.ContinuousEngine(cfg, params, n_pages=20, trace=rec,
                                     **kw) if which == "continuous" else \
                D.DisaggEngine(cfg, params, prefill_pages=20,
                               decode_pages=20, trace=rec, **kw)
            loop_s[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cs._serve_continuous(eng, reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            iters = eng.decode_dispatches * kw["decode_steps"]
            spans = {n: sum(e["dur"] for e in rec.events(n)) * 1e3 / iters
                     for n in ("decode_dispatch", "decode_sync", "prefill")}
            derived = ";".join(
                [f"turn={i}", f"iterations={iters}",
                 f"loop_dispatch_ms_per_iteration={loop_s[0] * 1e3 / iters:.3f}"]
                + [f"{n}_ms_per_iteration={v:.3f}" for n, v in spans.items()])
            print(f"engines/{which}_wall_s,{wall:.3f},{derived}", flush=True)
    finally:
        E._dispatch_decode_loop = D._dispatch_decode_loop = dispatch


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("in_turns measures on the CUDA card; none found")
    print("name,value,derived")
    if argv[:1] == ["attention"] and len(argv) > 1:
        attention(argv[1:])
    elif argv == ["engines"]:
        engines()
    elif argv[:1] == ["serve"] and len(argv) > 1:
        serve(argv[1:])
    else:
        raise SystemExit(__doc__)
    print(_card())


if __name__ == "__main__":
    main()
