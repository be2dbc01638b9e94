"""Benchmark runner of the port: one harness per paper table, printing
``name,us_per_call,derived`` CSV (the counterpart of
``benchmarks/run.py`` for the tables the port has).

  Table II  -> bench_mac_engine  (SIMD MAC engine, packed GEMM + quire)
  Table III -> bench_coprocessor (morphable 8x8/16x16 array)

  python -m repro_torch.benchmarks.run [--only mac_engine|coprocessor]
                                       [--device cpu]

It runs on the CUDA card unless ``--device cpu`` asks for the plain
path.
"""

from __future__ import annotations

import argparse
import sys
import traceback

from . import bench_coprocessor, bench_mac_engine

BENCHES = {
    "mac_engine": bench_mac_engine.run,
    "coprocessor": bench_coprocessor.run,
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
