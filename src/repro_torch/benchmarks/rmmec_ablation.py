"""Where the RMMEC kernels' time goes, on the card: ``csrc/rmmec_matmul.cu``
as committed and copies with one ingredient taken out, each built with
nvcc into ``build/rmmec_ablation/``.

The tensor-core routes: timed at qwen2-0.5b's projection shapes under
paper_mixed (posit8 q, FP4 gate and down; stacked slices, bf16 x,
per-channel scales) at M = 8 (split-K), 256 and 1024, two rounds in
turns, beside each shape's bound: the committed copy on the plan's routes
(also without the L2 flush), on ``wgmma_kernel`` wherever it can go and
on ``tile_kernel`` (tile_kernel's copies run there on tile_kernel); the
wgmma kernel without its decode, without its wgmmas, with its
loads alone, with one consumer warpgroup, with a block per tile in place
of the persistent grid, and its launch alone (the barriers and the table,
then every thread returns).  Then the probe (``wgmma_probe.cu``: the
committed source and one more kernel, built here only): the same bf16
chunk chains (normal values, exponents spread over 2^-40 .. 2^40,
cancelling pairs, signed zeros, FP4 codes) through wgmma and mma.sync k16
steps, compared bit for bit.

The route choice (``--only routes``): ``wgmma_kernel`` and the tile route
the plan would take otherwise, each forced, over M = 32 .. 2048 at twelve
(K, N) of qwen2-0.5b's, gemma-2b's and command-r-plus-104b's projections
in both formats (posit8 and FP4 codes drawn at random), beside the waves
each grid takes, the cost of a wave that each point implies, and whether
``wgmma_faster`` chose the faster kernel; then the host microseconds a
call over 1000 calls (wgmma, the same call forced onto the tiles, a tile64
and a split-K call, the plan alone), in turns.

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

  python -m repro_torch.benchmarks.rmmec_ablation [--only tensor|stream|probe|routes]

A copy that drops work computes wrong numbers on purpose; its error
against the plain version is printed beside its times.  Exits non-zero
without a card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..kernels import _build
from ..kernels import rmmec_matmul as rm

OUT_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "rmmec_ablation")
PROBE_CU = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "wgmma_probe.cu")
PROBE_ARGTYPES = {"rmmec_wgmma_probe": [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p]}
MMA = """      mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
      mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);"""
STORE = """        if (m < op.M && n < op.N)
          op.out[(size_t)m * op.N + n] ="""
WG_DECODE = """    wg_decode<BITS>(op, lutp, raw + dstage * L::RAW_BYTES, slots + bslot * L::B_BYTES,
                    dc * KC, (dt % ntn) * WG_BN);
"""
WG_MMA = """      if (rows)
        wg_chunk_mma(acc,"""

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
    # the wgmma route
    "wgmma_no_decode": [(WG_DECODE, "")],
    "wgmma_no_mma": [(WG_MMA, WG_MMA.replace("if (rows)", "if (rows && c < 0)"))],
    "wgmma_loads_only": [(WG_DECODE, ""),
                         (WG_MMA, WG_MMA.replace("if (rows)", "if (rows && c < 0)"))],
    "wgmma_one_consumer": [("constexpr int WG_CONSUMERS = 2;", "constexpr int WG_CONSUMERS = 1;")],
    "wgmma_non_persistent": [("const int grid = std::min(tiles, sm_count());",
                              "const int grid = tiles;")],
    "wgmma_launch_only": [("  if (threadIdx.x == 0) {\n    for (int s = 0; s < WG_STAGES; ++s) {\n",
                           "  if (threadIdx.x < WG_THREADS) return;\n"
                           "  if (threadIdx.x == 0) {\n    for (int s = 0; s < WG_STAGES; ++s) {\n")],
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
    texts = _sources()
    with open(PROBE_CU) as f:     # includes the committed rmmec_matmul.cu
        texts["probe"] = f.read()
    for name, text in texts.items():
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
        argtypes = dict(rm._ARGTYPES, **(PROBE_ARGTYPES if name == "probe"
                                         else {}))
        for fn, types in argtypes.items():
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
    calls, checks, bounds = {}, {}, {}
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
            nbytes = (x.numel() * 2 + t.words.numel() * 4
                      + t.scales.numel() * 4 + t.mask.numel() * 4 + m * n * 4)
            bounds[f"{tag}_m{m}"] = max(nbytes / 3.35e12,
                                        2.0 * m * k * n / 989e12) * 1e3
    return calls, checks, bounds


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
    calls, want, bounds = _inputs()
    print("variant,round,max_err," + ",".join(f"{k}_ms" for k in calls))
    print("bound,0,0," + ",".join(f"{bounds[k]:.4f}" for k in calls))
    aligned, faster = rm.tma_aligned, rm.wgmma_faster

    def row(name, lib, flush=True):
        rm._lib = lambda lib=lib: lib
        for c in rm._COUNTERS.values():   # a variant may leave them dirty
            c.zero_()
        err = max((calls[k]() - want[k]).abs().max().item() for k in calls)
        times = [_time_ms(fn, flush=flush) for fn in calls.values()]
        print(f"{name},{rnd},{err:.2e}," + ",".join(f"{t:.4f}" for t in times),
              flush=True)

    try:
        for rnd in (1, 2):
            for name in TENSOR_VARIANTS:
                # tile_kernel's copies keep their shapes on tile_kernel; the
                # wgmma copies take the wgmma route wherever it can go
                rm.tma_aligned = aligned if name == "committed" \
                    or name.startswith("wgmma_") else (lambda *a: False)
                rm.wgmma_faster = (lambda *a: True) \
                    if name.startswith("wgmma_") else faster
                row(name, libs[name])
            rm.tma_aligned, rm.wgmma_faster = aligned, (lambda *a: True)
            row("wgmma_kernel", libs["committed"])
            rm.wgmma_faster = faster
            row("committed_warm_l2", libs["committed"], flush=False)
            rm.tma_aligned = lambda *a: False   # the route before wgmma
            row("tile_kernel", libs["committed"])
            rm.tma_aligned = aligned
    finally:
        rm.tma_aligned, rm.wgmma_faster = aligned, faster
        rm._lib = lambda lib=libs["committed"]: lib


def _probe_cases(chunks: int, gen):
    """name -> (a (chunks, 64, KC), b (chunks, KC, 128)) bf16 chunk chains."""
    from ..core import formats as fmt
    from ..kernels.ops import pack_tensor, to_dense

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def bf(t):
        return t.to(torch.bfloat16).contiguous()

    kc, shape_a, shape_b = rm.KC, (chunks, 64, rm.KC), (chunks, rm.KC, 128)
    cases = {"normal": (bf(randn(*shape_a)), bf(randn(*shape_b)))}
    ea = torch.randint(-40, 41, shape_a, generator=gen, device="cuda")
    eb = torch.randint(-40, 41, shape_b, generator=gen, device="cuda")
    cases["spread"] = (bf(randn(*shape_a) * torch.exp2(ea.float())),
                       bf(randn(*shape_b) * torch.exp2(eb.float())))
    a, b = randn(*shape_a), randn(*shape_b)
    a[..., kc // 2:] = -a[..., :kc // 2]          # pairs that cancel
    b[:, kc // 2:] = b[:, :kc // 2]
    b[:, kc - 28:] *= 1.0 + 2.0 ** -6
    cases["cancel"] = (bf(a), bf(b))
    b = randn(*shape_b)
    b[..., ::2] = 0.0
    b[..., 1::4] = -0.0
    cases["signed_zeros"] = (bf(-torch.rand(shape_a, generator=gen,
                                             device="cuda")), bf(b))
    t = pack_tensor(fmt.FP4, randn(chunks * kc, 128) * 0.05)
    cases["fp4_codes"] = (bf(randn(*shape_a)), bf(
        (to_dense(t) / t.scales[0, :128]).reshape(shape_b)))
    return cases


def _probe_section(lib) -> None:
    """wgmma k16 chains vs mma.sync k16 chains, bit for bit."""
    chunks = 32
    gen = torch.Generator("cuda").manual_seed(5)
    print("probe_case,bits_differ_scale_d0,bits_differ_zero_init,elements,"
          "rel_err_wgmma,rel_err_mma_sync")
    for name, (a, b) in _probe_cases(chunks, gen).items():
        outs = [torch.empty((chunks, 64, 128), device="cuda")
                for _ in range(3)]
        err = lib.rmmec_wgmma_probe(
            a.data_ptr(), b.data_ptr(), *(o.data_ptr() for o in outs), chunks,
            rm.KC * 128, 1024, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rmmec_wgmma_probe: CUDA error {err}")
        torch.cuda.synchronize()
        w, z, m = (o.view(torch.int32) for o in outs)
        ref = torch.matmul(a.double(), b.double())
        scale = ref.abs().max().item()
        print(f"{name},{int((w != m).sum())},{int((z != m).sum())},{m.numel()},"
              f"{(outs[0].double() - ref).abs().max().item() / scale:.3e},"
              f"{(outs[2].double() - ref).abs().max().item() / scale:.3e}",
              flush=True)


SWEEP_SHAPES = ((896, 896), (896, 128), (896, 4864), (4864, 896),
                (2048, 2048), (2048, 256), (2048, 16384), (16384, 2048),
                (12288, 12288), (12288, 1024), (12288, 33792),
                (33792, 12288))
SWEEP_M = (32, 64, 128, 256, 512, 768, 1024, 2048)


def _waves(route: str, m: int, n: int, sms: int) -> int:
    """Waves of ``route``'s grid for an (m, n) output (wgmma and tile128: a
    block an SM; tile64: two blocks an SM)."""
    bm, bn, _ = rm.TILES[route]
    tiles = -(-m // bm) * -(-n // bn)
    return -(-tiles // (2 * sms if route == "tile64" else sms))


def _routes_section() -> None:
    """wgmma_kernel against the tile route over M, K, N and the format,
    and what ``wgmma_faster`` chose at each point."""
    from ..core import formats as fmt
    gen = torch.Generator("cuda").manual_seed(3)
    sms = rm._sms(torch.device("cuda"))
    aligned, faster = rm.tma_aligned, rm.wgmma_faster
    print("format,k,n,m,wgmma_ms,tile_ms,tile_route,wgmma_waves,tile_waves,"
          "wave_cost,rule,rule_right")
    costs, wrong = {}, []
    try:
        for spec in (fmt.POSIT8, fmt.FP4):
            per = 32 // spec.bits
            for k, n in SWEEP_SHAPES:
                words = torch.randint(-2 ** 31, 2 ** 31 - 1, (k, n // per),
                                      dtype=torch.int32, device="cuda",
                                      generator=gen)
                scales = torch.ones((1, n), device="cuda")
                mask = torch.ones((1, 1), dtype=torch.int32, device="cuda")
                for m in SWEEP_M:
                    x = torch.randn((m, k), generator=gen, device="cuda") \
                        .to(torch.bfloat16)

                    def call():
                        return rm.rmmec_matmul(x, words, scales, mask, spec,
                                               n)
                    rm.wgmma_faster = lambda *a: True
                    assert rm.call_plan(x, words, spec, n).route == "wgmma"
                    wg = _time_ms(call, iters=10)
                    rm.wgmma_faster, rm.tma_aligned = faster, \
                        (lambda *a: False)
                    route = rm.call_plan(x, words, spec, n).route
                    tl = _time_ms(call, iters=10)
                    rm.tma_aligned = aligned
                    ww, tw = _waves("wgmma", m, n, sms), \
                        _waves(route, m, n, sms)
                    alone = route == "tile64" \
                        and -(-m // 64) * -(-n // 64) <= sms
                    cost = (tl / tw) / (wg / ww)
                    costs.setdefault("tile64_alone" if alone else route,
                                     []).append(cost)
                    rule = faster(m, n, sms)
                    right = rule == (wg < tl)
                    if not right:
                        wrong.append((spec.name, k, n, m, wg, tl))
                    print(f"{spec.name},{k},{n},{m},{wg:.4f},{tl:.4f},"
                          f"{route},{ww},{tw},{cost:.3f},"
                          f"{'wgmma' if rule else route},{int(right)}",
                          flush=True)
                del words
    finally:
        rm.tma_aligned, rm.wgmma_faster = aligned, faster
    for key, vals in sorted(costs.items()):
        print(f"wave_cost {key}: median {np.median(vals):.3f}, "
              f"min {min(vals):.3f}, max {max(vals):.3f}, points "
              f"{len(vals)} (WAVE_COST: {rm.WAVE_COST.get(key)})")
    print(f"rule chose the slower kernel at {len(wrong)} of "
          f"{2 * len(SWEEP_SHAPES) * len(SWEEP_M)} points"
          + "".join(f"; {f} K={k} N={n} M={m}: wgmma {wg:.4f} ms, tiles "
                    f"{tl:.4f} ms" for f, k, n, m, wg, tl in wrong))


def _host_section(calls: int = 1000) -> None:
    """Host microseconds a call of qwen2-0.5b's q projection (posit8, 896
    x 896): at M = 1024 on the wgmma route and on tile64 (the same call
    with x 2 bytes off 16-byte alignment, so TMA cannot take it), at M =
    256 (tile64) and M = 8 (split-K), and the plan alone.  ``calls``
    rounds, each case once a round in turns, each call timed on its own;
    medians, and the loop's wall time a call."""
    from ..core import formats as fmt
    from ..kernels.ops import pack_tensor
    gen = torch.Generator("cuda").manual_seed(9)
    t = pack_tensor(fmt.POSIT8, torch.randn((896, 896), generator=gen,
                                            device="cuda") * 0.05)
    xs = {m: torch.randn((m, 896), generator=gen, device="cuda")
          .to(torch.bfloat16) for m in (8, 256, 1024)}
    off = torch.empty(1024 * 896 + 8, dtype=torch.bfloat16, device="cuda")
    xs["off"] = off[1:1 + 1024 * 896].view(1024, 896)
    xs["off"].copy_(xs[1024])

    def call(key):
        return lambda: rm.rmmec_matmul(xs[key], t.words, t.scales, t.mask,
                                       t.spec, 896)
    cases = {"wgmma_m1024": call(1024), "tile64_m1024_offset": call("off"),
             "tile64_m256": call(256), "split_k_m8": call(8),
             "plan_m1024": lambda: rm.call_plan(xs[1024], t.words, t.spec,
                                                896),
             "plan_m8": lambda: rm.call_plan(xs[8], t.words, t.spec, 896)}
    routes = {key: rm.call_plan(xs[key], t.words, t.spec, 896).route
              for key in (1024, "off", 256, 8)}
    assert routes == {1024: "wgmma", "off": "tile64", 256: "tile64",
                      8: "split_k"}, routes
    assert torch.equal(call(1024)(), call("off")())
    got = {name: [] for name in cases}
    for fn in cases.values():
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        for name, fn in cases.items():
            a = time.perf_counter_ns()
            fn()
            got[name].append(time.perf_counter_ns() - a)
    wall = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    print(f"case,host_us_median,host_us_p90 ({calls} calls each in turns; "
          f"a round of all {len(cases)} took {wall:.2f} us)")
    for name, ns in got.items():
        print(f"{name},{np.median(ns) / 1e3:.2f},"
              f"{np.percentile(ns, 90) / 1e3:.2f}", flush=True)


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
    ap.add_argument("--only", choices=("tensor", "stream", "probe",
                                       "routes"),
                    help="one section (default all; tensor ends with the "
                         "probe)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rmmec_ablation: no CUDA device", file=sys.stderr)
        return 2
    names = {"tensor": TENSOR_VARIANTS + ["probe"],
             "stream": STREAM_VARIANTS + ["simt_8_rows"],
             "probe": ["probe"], "routes": ["committed"]}
    libs = _build_all(set(names.get(args.only, [*VARIANTS, "probe"])))
    committed = rm._lib
    try:
        if "committed" in libs:
            rm._lib = lambda lib=libs["committed"]: lib
        if args.only in (None, "tensor"):
            _tensor_section(libs)
        if args.only in (None, "tensor", "probe"):
            _probe_section(libs["probe"])
        if args.only in (None, "routes"):
            _routes_section()
            _host_section()
        if args.only in (None, "stream"):
            _stream_section(libs)
    finally:
        rm._lib = committed
    return 0


if __name__ == "__main__":
    sys.exit(main())
