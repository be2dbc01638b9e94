"""Hillclimb ladders: hypothesis -> change -> measure -> record, through
the port's dry run (the counterpart of ``repro.launch.hillclimb``).

Runs the reference's three cells through their ladders and writes tagged
records (``build/dryrun_torch/*__<tag>.json``) plus one JSON line per
variant to ``build/dryrun_torch/perf_log.jsonl``.  The hypotheses speak
of what the port runs (eager PyTorch on fake tensors, the hand kernels
counted as one op each); the numbers are the records'.

  python -m repro_torch.launch.hillclimb [--cell A|B|C|all]
      [--mesh 16x16] [--reduced] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os

from .dryrun import OUT_DIR, lower_cell, save_record


def run_variant(arch, shape, tag, hypothesis, *, out_dir=OUT_DIR,
                mesh_shape=None, reduced=False, **kw):
    rec = lower_cell(arch, shape, verbose=False, mesh_shape=mesh_shape,
                     reduced=reduced, **kw)
    save_record(rec, tag, out_dir)
    rf = rec["roofline"]
    row = {
        "arch": arch, "shape": shape, "tag": tag, "hypothesis": hypothesis,
        "mesh": rec["mesh"], "reduced": reduced,
        "t_compute": rf["t_compute_s"], "t_memory": rf["t_memory_s"],
        "t_coll": rf["t_collective_s"], "dominant": rf["dominant"],
        "frac": rf["roofline_fraction"],
        "useful": rf["useful_flops_ratio"],
        "temp_gib": rec["memory"]["temp_bytes"] / 2**30,
        "peak_gib": rec["memory"]["peak_nonaliased_bytes"] / 2**30,
        "run_s": rec["run_s"],
    }
    print(f"[{arch} x {shape}] {tag}: dom={row['dominant']} "
          f"tm={row['t_memory']:.4f} tc={row['t_compute']:.4f} "
          f"tk={row['t_coll']:.4f} frac={row['frac']:.4f} "
          f"peak={row['peak_gib']:.2f}GiB ({row['run_s']:.1f} s) -- "
          f"{hypothesis}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "perf_log.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")
    return row


def cell_A(**kw):
    """command-r-plus-104b x decode_32k: packed serving, memory-bound,
    the cell most representative of the paper's technique."""
    a, s = "command-r-plus-104b", "decode_32k"
    return [
        run_variant(a, s, "hc0", "baseline: packed paper_mixed weights, "
                    "dense bf16 KV cache read whole each step", **kw),
        run_variant(a, s, "hc_kvq", "posit8 KV codes read by the "
                    "flash_decode kernel over the live prefix only: the "
                    "cache's bytes per step fall ~2x against bf16",
                    quantized_kv=True, **kw),
        run_variant(a, s, "hc_bf16", "control: dense bf16 weights (the "
                    "pre-paper serving baseline) read by library GEMMs: "
                    "weight bytes ~3.5x the packed plan's",
                    policy_name="bf16", **kw),
        run_variant(a, s, "hc_fp4", "uniform fp4 weights + posit8 KV (both "
                    "planes packed): the fewest bytes of the ladder",
                    policy_name="fp4", quantized_kv=True, **kw),
    ]


def cell_B(**kw):
    """qwen2-0.5b x prefill_32k: a small model whose read-out dominates
    a long prefill."""
    a, s = "qwen2-0.5b", "prefill_32k"
    return [
        run_variant(a, s, "hc0", "baseline: logits at every position",
                    **kw),
        run_variant(a, s, "hc_lastlogit", "last-position logits only: the "
                    "read-out runs on 1 of S positions, so the (B, S, V) "
                    "logits are never built and FLOPs and bytes fall",
                    last_logit_only=True, **kw),
        run_variant(a, s, "hc_chunk", "attention chunks of 4096 queries: "
                    "fewer, larger score blocks -- the same FLOPs, a larger "
                    "transient", last_logit_only=True, seq_chunk=4096, **kw),
    ]


def cell_C(**kw):
    """kimi-k2-1t-a32b x train_4k: QAT on a 1T-parameter MoE, the worst
    memory pressure."""
    a, s = "kimi-k2-1t-a32b", "train_4k"
    return [
        run_variant(a, s, "hc0", "baseline: microbatch 4", microbatch=4,
                    **kw),
        run_variant(a, s, "hc_mb8", "microbatch 8: half the rows per "
                    "microbatch, so the activation transient halves; the "
                    "same FLOPs", microbatch=8, **kw),
        run_variant(a, s, "hc_noqat", "QAT off: isolates the bytes the "
                    "fake-quant of every weight adds per microbatch",
                    microbatch=4, qat=False, **kw),
        run_variant(a, s, "hc_comp", "posit8 gradient compression with "
                    "error feedback: the port sums the gradients over the "
                    "data axis in f32 (DTensor) and compresses the summed "
                    "leaf, so the wire bytes do not fall; the residuals "
                    "add one f32 shard per weight and their gathers",
                    microbatch=4,
                    grad_compression="posit8", **kw),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="all", choices=["A", "B", "C", "all"])
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--reduced", action="store_true",
                    help="the configs' reduced (CPU-test) variants")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    kw = dict(out_dir=args.out, reduced=args.reduced,
              mesh_shape=tuple(int(x) for x in args.mesh.split("x")))
    for name, fn in (("A", cell_A), ("B", cell_B), ("C", cell_C)):
        if args.cell in (name, "all"):
            fn(**kw)


if __name__ == "__main__":
    main()
