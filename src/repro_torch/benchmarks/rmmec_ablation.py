"""Where the RMMEC kernels' time goes, on the card: ``csrc/rmmec_matmul.cu``
as committed and copies with one ingredient taken out, each built with
nvcc into ``build/rmmec_ablation/``.

The tensor-core routes: timed at qwen2-0.5b's projection shapes under
paper_mixed (posit8 q, FP4 gate and down; stacked slices, bf16 x,
per-channel scales) at M = 8 (split-K), 256 and 1024 (tiles), two rounds
in turns; the committed copy also without the L2 flush.

The streaming route (``stream_kernel``, warp strips, and
``stream_narrow_kernel``, block strips): timed at command-r-plus-104b's
posit16 read-out (12288 x 256000, a packed 4096-column slab tiled across
N) at M = 4 and 16 and musicgen-medium's (1536 x 2048) at M = 2, beside
each shape's bytes bound: as committed, without the decode (the words'
bits summed raw), without the fmaf loop, with the loads only, with three
steps of loads in flight in place of two, at three blocks an SM in place
of four, with a block barrier every two or every sixteen steps (also
with the loads only), with loads that skip L1, and the committed library
at other strips (``WIDE_BN``: warp strips; 32 and 128: block strips);
then the SIMT kernel at M = 17 and 32 as committed (64-row tiles) and with
its former 8-row tiles.

  python -m repro_torch.benchmarks.rmmec_ablation [--only tensor|stream]

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
    # the streaming route
    "stream_no_decode": [
        ("      decode_piece<BITS>(lut, cp, rw, v);\n",
         "      for (int i = 0; i < P; ++i) v[i] = __uint_as_float((&rw.x)[i % 4]);\n"),
        ("        decode_piece<BITS>(lut, cp, reinterpret_cast<const uint4*>(slot)[p], v);\n",
         "        const uint4 q4 = reinterpret_cast<const uint4*>(slot)[p];\n"
         "        for (int i = 0; i < P; ++i) v[i] = __uint_as_float((&q4.x)[i % 4]);\n")],
    "stream_no_fma": [
        ("        for (int r = 0; r < RS; ++r) fma_rows<MB>(acc, bx + r * MB, wv[r]);\n",
         "        for (int r = 0; r < RS; ++r) acc[0] += wv[r];\n"),
        ("          if (r < rows) fma_rows<MB>(acc, bx + r * MB, wv[r]);\n",
         "          if (r < rows) acc[0] += wv[r];\n"),
        ("        for (int i = 0; i < 8; ++i) fma_rows<MB>(acc, xr + (r + i) * MB, wv[i]);\n",
         "        for (int i = 0; i < 8; ++i) acc[0] += wv[i];\n"),
        ("      for (; r < s1; ++r) fma_rows<MB>(acc, xr + r * MB, wcol[r * ldw]);\n",
         "      for (; r < s1; ++r) acc[0] += wcol[r * ldw];\n")],
    "stream_loads_only": [
        ("  auto step = [&](int st, int j) {\n",
         "  auto step = [&](int st, int j) {\n"
         "    acc[0] += __uint_as_float(raw[j].x ^ raw[j].y ^ raw[j].z ^ raw[j].w);\n"
         "    fetch(st + S, j);\n"
         "    if (st >= 0) return;\n"),
        ("    if (ch + 1 < nchunks) stage(ch + 1, (ch + 1) & 1);\n    chain(ch, ch & 1);\n",
         "    acc[0] += __uint_as_float(reinterpret_cast<const uint32_t*>(\n"
         "        ring + ((ch + 1) % STREAM_SETS) * Slot::BYTES)[tid]);\n")],
    "stream_sets_3": [("  static constexpr int SETS = 2;  // steps whose loads are in flight",
                       "  static constexpr int SETS = 3;  // steps whose loads are in flight")],
    "stream_3_blocks": [("__launch_bounds__(WIDE_THREADS, BITS == 16 && MB <= 4 ? 4 : 2)",
                         "__launch_bounds__(WIDE_THREADS, BITS == 16 && MB <= 4 ? 3 : 2)")],
    "stream_block_sync": [
        ("  if (n0 >= op.N) return;\n", ""),
        ("  for (int s0 = 0; s0 < nsteps; s0 += S) {\n",
         "  for (int s0 = 0; s0 < nsteps; s0 += S) {\n    __syncthreads();\n")],
    "stream_sync_16": [
        ("  if (n0 >= op.N) return;\n", ""),
        ("  for (int s0 = 0; s0 < nsteps; s0 += S) {\n",
         "  for (int s0 = 0; s0 < nsteps; s0 += S) {\n    if (s0 % 16 == 0) __syncthreads();\n")],
    "stream_ldcg": [("      raw[j] = __ldg(reinterpret_cast<const uint4*>(src));",
                     "      raw[j] = __ldcg(reinterpret_cast<const uint4*>(src));")],
    "simt_8_rows": [("  dim3 grid((a.N + SIMT_BN - 1) / SIMT_BN, (a.M + 63) / 64);\n",
                     "  if (a.M <= 32) {\n"
                     "    dim3 g8((a.N + SIMT_BN - 1) / SIMT_BN, (a.M + 7) / 8);\n"
                     "    simt_kernel<F, TX, 8, 1, 2><<<g8, SIMT_THREADS, 0, a.stream>>>(\n"
                     "        x, a.w, a.scales, a.mask, a.out, a.M, a.K, a.N, a.Np, a.group, a.mk,\n"
                     "        a.mn, a.mask_cols);\n"
                     "    return cudaGetLastError();\n"
                     "  }\n"
                     "  dim3 grid((a.N + SIMT_BN - 1) / SIMT_BN, (a.M + 63) / 64);\n")],
}
TENSOR_VARIANTS = [v for v in VARIANTS if not v.startswith(("stream_", "simt_"))]
STREAM_VARIANTS = ["committed", "stream_no_decode", "stream_no_fma",
                   "stream_loads_only", "stream_sets_3", "stream_3_blocks",
                   "stream_block_sync", "stream_sync_16", "stream_ldcg",
                   "stream_block_sync_loads_only",
                   "stream_sync_16_loads_only"]
# copies made of two others' patches
for _name in ("stream_block_sync", "stream_sync_16"):
    VARIANTS[_name + "_loads_only"] = VARIANTS[_name] \
        + VARIANTS["stream_loads_only"]
STRIPS = (32, 128, rm.WIDE_BN)


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


def _build_all(names):
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, text in _sources().items():
        if name not in names:
            continue
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


def _readout(k: int, n: int, gen):
    """A posit16 read-out (k, n), per-channel scales: a packed slab of
    4096 seeded columns tiled across N (no 12.6 GB f32 draw)."""
    from ..core import formats as fmt
    from ..kernels.ops import PackedTensor, pack_tensor
    t = pack_tensor(fmt.POSIT16, torch.randn((k, 4096), generator=gen,
                                             device="cuda") * 0.05)
    reps = -(-n // 4096)
    return PackedTensor(t.words.repeat(1, reps)[:, : n // 2].contiguous(),
                        t.scales.repeat(1, reps)[:, :n].contiguous(),
                        torch.ones((1, 1), dtype=torch.int32, device="cuda"),
                        (k, n), fmt.POSIT16, None)


def _plain_slabs(x, t, slab: int = 1 << 15):
    return torch.cat([rm.rmmec_matmul_plain(
        x, t.words[:, c // 2:(c + slab) // 2].contiguous(),
        t.scales[:, c:c + slab].contiguous(), t.spec, min(slab, t.shape[1] - c))
        for c in range(0, t.shape[1], slab)], dim=1)


def _stream_inputs():
    """(calls, plain outputs, bytes bounds in ms) of the streaming shapes,
    and the SIMT shapes (M = 17, 32 at qwen2-vl-7b's read-out)."""
    gen = torch.Generator("cuda").manual_seed(11)
    calls, want, bound, simt = {}, {}, {}, {}
    for tag, k, n, ms in (("commandr", 12288, 256000, (4, 16)),
                          ("musicgen", 1536, 2048, (2,)),
                          ("qwen2vl", 3584, 152064, (17, 32))):
        t = _readout(k, n, gen)
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda") \
                .to(torch.bfloat16)
            fn = (lambda x=x, t=t, n=n: rm.rmmec_matmul(
                x, t.words, t.scales, t.mask, t.spec, n))
            if m > rm.SPLIT_K_MAX_M:
                simt[f"{tag}_m{m}"] = fn
                continue
            calls[f"{tag}_m{m}"] = fn
            want[f"{tag}_m{m}"] = _plain_slabs(x, t)
            nbytes = (x.numel() * 2 + t.words.numel() * 4
                      + t.scales.numel() * 4 + t.mask.numel() * 4 + m * n * 4)
            bound[f"{tag}_m{m}"] = max(nbytes / 3.35e12,
                                       2.0 * m * k * n / 67e12) * 1e3
    return calls, want, bound, simt


def _tensor_section(libs) -> None:
    calls, want = _inputs()
    print("variant,round,max_err," + ",".join(f"{k}_ms" for k in calls))
    for rnd in (1, 2):
        for name in TENSOR_VARIANTS:
            rm._lib = lambda lib=libs[name]: lib
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


def _stream_section(libs) -> None:
    calls, want, bound, simt = _stream_inputs()
    print("variant,round,max_err," + ",".join(f"{k}_ms" for k in calls))
    print("bytes_bound,0,0," + ",".join(f"{bound[k]:.4f}" for k in calls))
    committed_strip = rm.stream_strip
    try:
        for rnd in (1, 2):
            for name in STREAM_VARIANTS:
                rm._lib = lambda lib=libs[name]: lib
                err = max((calls[k]() - want[k]).abs().max().item()
                          for k in calls)
                times = [_time_ms(fn) for fn in calls.values()]
                print(f"{name},{rnd},{err:.2e},"
                      + ",".join(f"{t:.4f}" for t in times), flush=True)
            rm._lib = lambda lib=libs["committed"]: lib
            for bn in STRIPS:   # the committed kernel at other strips
                rm.stream_strip = lambda n, bits, sms=0, bn=bn: bn
                err = max((calls[k]() - want[k]).abs().max().item()
                          for k in calls)
                times = [_time_ms(fn) for fn in calls.values()]
                print(f"strip_{bn},{rnd},{err:.2e},"
                      + ",".join(f"{t:.4f}" for t in times), flush=True)
            rm.stream_strip = committed_strip
    finally:
        rm.stream_strip = committed_strip
    print("variant,round," + ",".join(f"{k}_ms" for k in simt))
    for rnd in (1, 2):
        for name in ("committed", "simt_8_rows"):
            rm._lib = lambda lib=libs[name]: lib
            times = [_time_ms(fn, iters=5) for fn in simt.values()]
            print(f"{name},{rnd}," + ",".join(f"{t:.4f}" for t in times),
                  flush=True)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("tensor", "stream"),
                    help="one section (default both)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rmmec_ablation: no CUDA device", file=sys.stderr)
        return 2
    names = {"tensor": TENSOR_VARIANTS,
             "stream": STREAM_VARIANTS + ["simt_8_rows"]}
    libs = _build_all(set(names.get(args.only, VARIANTS)))
    committed = rm._lib
    try:
        if args.only in (None, "tensor"):
            _tensor_section(libs)
        if args.only in (None, "stream"):
            _stream_section(libs)
    finally:
        rm._lib = committed
    return 0


if __name__ == "__main__":
    sys.exit(main())
