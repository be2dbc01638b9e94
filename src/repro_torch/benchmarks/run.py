"""Benchmark runner of the port: one harness per paper table, printing
``name,us_per_call,derived`` CSV (the counterpart of
``benchmarks/run.py`` for the tables the port has).

  Table II  -> bench_mac_engine  (SIMD MAC engine, packed GEMM + quire)
  Table III -> bench_coprocessor (morphable 8x8/16x16 array)
  Fig 5-8   -> bench_accuracy    (precision sweeps on the XR workloads)
  size tbl  -> bench_model_size  (13.5 -> 2.42 MB UL-VIO story)

  python -m repro_torch.benchmarks.run
      [--only mac_engine|coprocessor|model_size|accuracy] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` asks for the plain
path.
"""

from __future__ import annotations

import argparse
import sys
import traceback

from . import (bench_accuracy, bench_coprocessor, bench_mac_engine,
               bench_model_size)

BENCHES = {
    "mac_engine": bench_mac_engine.run,
    "coprocessor": bench_coprocessor.run,
    "model_size": bench_model_size.run,
    "accuracy": bench_accuracy.run,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, choices=sorted(BENCHES),
                    help="run a single bench")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    failed = []
    for name, fn in BENCHES.items():
        if args.only and name != args.only:
            continue
        try:
            fn(args.device)
        except Exception:
            traceback.print_exc()
            failed.append(name)
    if failed:
        print(f"# FAILED: {failed}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
