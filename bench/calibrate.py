#!/usr/bin/env python3
"""Readings for a cell's correctness limits, on one CUDA card.

  python3 bench/calibrate.py --workload <cell> --seconds <s> \
      --seeds <n> [<n> ...] [--out PATH]

For each seed, in one process: one run of the cell as ``run.py`` makes
it (set-up, ramp, window), then the reference over the run's seeded
sample twice: at full precision, which gives the program's widest and
mean logit gaps (on float32 logits and in the read-out's bfloat16), and
as the control, the reference itself at the next precision below the
configuration's bf16 activations (every product's input through float8
e4m3 under a power-of-two scale per row, the logits in bfloat16 as the
program's read-out writes them), which gives the control's.  One JSON
line per seed on standard output (and appended to ``--out``).  The
benchmark's own runs never run the control."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    from bench import harness
    from bench.reference.common import fp8_rows
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                               t_start=t,
                               log=lambda m: print(m, file=sys.stderr))
        chk = harness.check(cell, seed, res["served"], "cuda", act=fp8_rows)
        line = dict(chk, workload=args.workload, seed=seed,
                    unanswered=res["failed"],
                    output_tok_s=harness.read_metric("output_tok_s",
                                                     res["record"]),
                    wall_s=time.perf_counter() - t,
                    device=torch.cuda.get_device_name(0))
        print(json.dumps({k: v for k, v in line.items()
                          if k != "requests"}), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
