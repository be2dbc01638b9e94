"""Where the RMMEC kernels' time goes, on the card: ``csrc/rmmec_matmul.cu``
as committed and copies with one ingredient taken out, each built with
nvcc into ``build/rmmec_ablation/`` and timed at qwen2-0.5b's projection
shapes under paper_mixed (posit8 q, FP4 gate and down; stacked slices,
bf16 x, per-channel scales) at M = 8 (split-K), 256 and 1024 (tiles),
two rounds in turns; the committed copy also without the L2 flush.

  python -m repro_torch.benchmarks.rmmec_ablation

A copy that drops work computes wrong numbers on purpose; its error
against the plain version is printed beside its times.  Exits non-zero
without a card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from ..kernels import _build
from ..kernels import rmmec_matmul as rm

OUT_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "rmmec_ablation")
MMA = """      mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
      mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);"""
STORE = """        if (m < op.M && n < op.N)
          op.out[(size_t)m * op.N + n] ="""

# name -> [(text of the committed source, its replacement), ...]; the tile
# kernel's copies, decode and stores, the split-K fold, or the MMAs of both
VARIANTS = {
    "committed": [],
    "no_mma": [(MMA, "      acc[mt][nt][0] += __uint_as_float(a[mt][0] ^ b[0]);\n"
                     "      acc[mt][nt + 1][0] += __uint_as_float(a[mt][1] ^ b[2]);")],
    "no_decode": [("  const uint32_t w4[4] = {words.x, words.y, words.z, words.w};",
                   "  if (k >= 0) return;\n"
                   "  const uint32_t w4[4] = {words.x, words.y, words.z, words.w};")],
    "no_tile_wait": [("    cp_async_wait_all();\n    // chunk c decoded", "    // chunk c decoded")],
    "no_fold": [("  if (!last) return;", "  if (last >= 0) return;")],
    "no_x_stage": [("      stage_x<BM, NTH>(op, xs + (c % S) * (T::X_BYTES / 2), m0, c * KC, xvec);\n",
                    "")],
    "no_w_stage": [("      for (int j = 0; j < DP; ++j) stage_words(c, j);\n", "      {}\n")],
    "one_chunk": [("  const int nchunks = (op.K + KC - 1) / KC;\n  const bool wvec",
                   "  const int nchunks = 1;\n  const bool wvec")],
    "no_store": [(STORE, STORE.replace("m < op.M", "m < 0"))],
    "tile64_4_warps": [("using Tile64 = Tile<64, 64, 4, 2>;", "using Tile64 = Tile<64, 64, 2, 2>;")],
}


def _sources():
    with open(os.path.join(_build.CSRC_DIR, "rmmec_matmul.cu")) as f:
        src = f.read()
    out = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: the committed source no longer "
                                   f"holds {old[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build_all():
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, text in _sources().items():
        cu = os.path.join(OUT_DIR, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", os.path.join(OUT_DIR, name + ".so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name == "committed":
            print(log, file=sys.stderr)
        lib = ctypes.CDLL(os.path.join(OUT_DIR, name + ".so"))
        for fn, types in rm._ARGTYPES.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _time_ms(fn, iters: int = 20, flush: bool = True) -> float:
    """Median of CUDA-event intervals, each after a 128 MB L2-evicting
    write (unless ``flush`` is off) and a spin kernel (as
    ``chip_smoke.time_ms``)."""
    buf = torch.empty(32 << 20, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush:
            buf.add_(1)
        torch.cuda._sleep(400_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _inputs():
    from ..core import formats as fmt
    from ..kernels.ops import pack_tensor
    gen = torch.Generator("cuda").manual_seed(7)
    calls, checks = {}, {}
    for spec, k, n, tag in ((fmt.POSIT8, 896, 896, "q"),
                            (fmt.FP4, 896, 4864, "gate"),
                            (fmt.FP4, 4864, 896, "down")):
        t = pack_tensor(spec, torch.randn((2, k, n), generator=gen,
                                          device="cuda") * 0.05)[1]
        for m in (8, 256, 1024):
            x = torch.randn((m, k), generator=gen, device="cuda") \
                .to(torch.bfloat16)
            calls[f"{tag}_m{m}"] = (lambda x=x, t=t, n=n: rm.rmmec_matmul(
                x, t.words, t.scales, t.mask, t.spec, n))
            checks[f"{tag}_m{m}"] = rm.rmmec_matmul_plain(x, t.words,
                                                          t.scales, t.spec, n)
    return calls, checks


def main() -> int:
    if not torch.cuda.is_available():
        print("rmmec_ablation: no CUDA device", file=sys.stderr)
        return 2
    libs = _build_all()
    calls, want = _inputs()
    committed = rm._lib
    print("variant,round,max_err," + ",".join(f"{k}_ms" for k in calls))
    try:
        for rnd in (1, 2):
            for name, lib in libs.items():
                rm._lib = lambda lib=lib: lib
                for c in rm._COUNTERS.values():   # a variant may leave them dirty
                    c.zero_()
                err = max((calls[k]() - want[k]).abs().max().item()
                          for k in calls)
                times = [_time_ms(fn) for fn in calls.values()]
                print(f"{name},{rnd},{err:.2e},"
                      + ",".join(f"{t:.4f}" for t in times), flush=True)
            rm._lib = lambda lib=libs["committed"]: lib
            times = [_time_ms(fn, flush=False) for fn in calls.values()]
            print(f"committed_warm_l2,{rnd},0," + ",".join(
                f"{t:.4f}" for t in times), flush=True)
    finally:
        rm._lib = committed
    return 0


if __name__ == "__main__":
    sys.exit(main())
