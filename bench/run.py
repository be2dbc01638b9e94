#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on one CUDA card.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

From the root of a checkout.  Set-up draws the weights from the seed on
the card, has the program (``src/repro_torch``) pack them, and ramps the
cell's closed-loop clients to a full batch; the window then runs for
``--seconds``; afterwards a seeded sample of the requests finished in
the window is held against the plain reference (``bench/reference``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``, each compared number
beside its limit (also the last lines of standard error).  Exits non-zero
without a result when no card is present, when the program cannot be
imported, or when JAX or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    from bench import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        _log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        _log(f"{args.workload} needs {entry['chips']} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             f" available")
        return 2
    try:
        import repro_torch  # noqa: F401  (the program under test)
    except ImportError as exc:
        _log(f"the program cannot be imported: {exc}")
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cell = harness.load_cell(args.workload)
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", t_start=harness.process_start(), log=_log)
    record = res["record"]
    metrics = {}
    for m in harness.metrics_of(bench, args.workload, bool(args.trace)):
        v = harness.read_metric(m["name"], record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    t = time.perf_counter()
    checked = harness.check(cell, args.seed, res["served"], "cuda")
    _log(f"[bench] reference check {time.perf_counter() - t:.1f} s over "
         f"{checked['compared_requests']} requests")
    _log("[bench] readings " + json.dumps(
        {k: v for k, v in checked.items() if k != "requests"}))
    checks = harness.verdict(cell, res, checked)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, "memory_peak_bytes": int(res["memory_peak_bytes"])}
    out = {"correct": harness.is_correct(checks),
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    prof = record.get("profile")
    if args.trace:
        if prof:
            device["busy_s"] = prof["busy_s"]
            device["window_s"] = prof["window_s"]
            out["breakdown"] = {"device_ops": prof["top_ops"],
                                "idle_gaps": prof["idle_gaps"]}
            _log("[bench] profile " + json.dumps(
                {k: prof[k] for k in ("kernels", "dispatches",
                                      "unattributed", "rooflines")}))
        else:
            _log("the profiler window recorded nothing")
    bad = _loaded_forbidden()
    if bad:
        _log(f"loaded once the window closed: {', '.join(bad)}")
        return 3
    out["checks"] = checks
    for name, c in checks.items():
        _log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # leave without the interpreter's teardown: unloading the profiler's
    # CUPTI hooks and the kernels' libraries at exit can fault after the
    # result is out, and the run's exit code must be the run's
    os._exit(code)
