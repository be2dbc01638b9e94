"""Benchmark runner of the port: one harness per paper table, printing
``name,us_per_call,derived`` CSV (the counterpart of
``benchmarks/run.py``, the same seven benches).

  Table II  -> bench_mac_engine  (SIMD MAC engine, packed GEMM + quire)
  Table III -> bench_coprocessor (morphable 8x8/16x16 array)
  Table IV  -> bench_e2e         (end-to-end packed vs dense inference)
  Fig 5-8   -> bench_accuracy    (precision sweeps on the XR workloads)
  size tbl  -> bench_model_size  (13.5 -> 2.42 MB UL-VIO story)
  decode    -> bench_decode      (posit8 KV flash decode vs the bf16
                                  cache: tokens/s + KV bytes/step)
  serve     -> bench_serve       (continuous batching over paged KV:
                                  throughput, p50/p99 latency, chunked
                                  prefill, disaggregation, prefix cache,
                                  the K-step loop, the state slabs)

  python -m repro_torch.benchmarks.run [--only NAME] [--device cpu]
      [--smoke] [--full] [--out DIR]

It runs on the CUDA card unless ``--device cpu`` asks for the plain
path.  ``--full`` runs e2e / decode / serve at qwen2-0.5b's published
width (default: the reference's reduced config); ``--smoke`` takes the
reference's small traffic for decode / serve, whose JSON goes to
``--out`` (default ``build/bench_torch/``).
"""

from __future__ import annotations

import argparse
import sys
import traceback

from . import (bench_accuracy, bench_coprocessor, bench_decode, bench_e2e,
               bench_mac_engine, bench_model_size, bench_serve)

BENCHES = {
    "mac_engine": bench_mac_engine.run,
    "coprocessor": bench_coprocessor.run,
    "e2e": bench_e2e.run,
    "model_size": bench_model_size.run,
    "accuracy": bench_accuracy.run,
    "decode": bench_decode.run,
    "serve": bench_serve.run,
}

# the flags each bench takes besides the device
FLAGS = {"e2e": ("full",), "decode": ("smoke", "full", "out_dir"),
         "serve": ("smoke", "full", "out_dir")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, choices=sorted(BENCHES),
                    help="run a single bench")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true",
                    help="decode / serve: the reference's small traffic")
    ap.add_argument("--full", action="store_true",
                    help="e2e / decode / serve: qwen2-0.5b at full width")
    ap.add_argument("--out", dest="out_dir", default=None,
                    help="directory of the decode / serve JSON")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived", flush=True)
    failed = []
    for name, fn in BENCHES.items():
        if args.only and name != args.only:
            continue
        try:
            fn(args.device, **{k: getattr(args, k)
                               for k in FLAGS.get(name, ())})
        except Exception:
            traceback.print_exc()
            failed.append(name)
    if failed:
        print(f"# FAILED: {failed}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
