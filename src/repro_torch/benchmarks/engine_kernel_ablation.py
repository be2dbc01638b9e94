"""Where the engine-plane kernels' time goes, on the card: ``csrc/dequant.cu``
and ``csrc/quire_dot.cu`` as committed, copies with one ingredient taken
out (built with nvcc into ``build/engine_kernel_ablation/``), and the
committed library driven down another of its routes, timed at
``chip_smoke.py``'s shapes, two rounds in turns.

  python -m repro_torch.benchmarks.engine_kernel_ablation

dequant (posit8 K=N=1024 per channel and group 32; qwen2-0.5b's FP4 FFN
slice 896 x 4864 per channel):
  committed            the strip route as built
  word_route           the first design: a thread per 4-byte word, its
                       scales read one by one (the committed word_kernel)
  lane_chunks          each lane stores its own vector's outputs, so a
                       warp's store writes 32 pieces of 16 bytes, 64 or
                       128 bytes apart, not 512 contiguous bytes
  no_scale_reuse       every row reloads its scales
  stores_then_loads    a warp issues the next row's loads after this
                       row's stores, not before
  plain_stores         float4 stores without the streaming hint
  decoder              codes decoded in registers, not through the table
  bands_half / _x2     half or twice the plan's bands of rows (grid y)
quire_dot (64 x 1024, the bench's row; 4096 x 4096):
  committed            a block per row, 16-byte loads, ROW_UNROLL 8
  scalar_route         the first design: 4-byte loads, table first
  table_first          the table built before the loads are issued
  row_unroll_1 / _4    1 or 4 int4 loads of an operand in flight a thread
  row_threads_128      128 threads a block
  row_512x4            512 threads a block, 4 loads each
  ldg_loads            loads through the read-only path, not streaming
and ``launch_floor``: a kernel that does no work, timed the same way (the
least any row above can take).

Every variant's output is checked bit for bit against the plain version
(a variant that changes only the order of work must still be exact).
Prints CSV; exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from ..kernels import _build
from ..kernels import codec as kcodec
from ..kernels import quire_dot as kquire

OUT_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR),
                       "engine_kernel_ablation")

NEXT_LOAD = """    const int rn = r + STEP;  // the next row's loads before this row's stores
    const uint4 nxt = live && rn < r1 ? __ldg(w + static_cast<size_t>(rn) * nv + c) : zero;
"""
ROW_LOADS = """  load(threadIdx.x);  // the first loads out before the table
  fill_table(table, ROW_THREADS);
  __syncthreads();
"""
UNROLL = "constexpr int ROW_UNROLL = 8; "
ROW_THREADS = "constexpr int ROW_THREADS = 256; "

# name -> (source, [(text of the committed source, its replacement), ...])
VARIANTS = {
    "committed": (None, []),
    "lane_chunks": ("dequant", [
        ("const int col = n0 + 4 * (j * 32 + lane);",
         "const int col = n0 + 4 * (lane * NCH + j);"),
        ("const int q = j * 32 + lane, col = n0 + 4 * q;",
         "const int q = lane * NCH + j, col = n0 + 4 * q;")]),
    "no_scale_reuse": ("dequant", [
        ("if (group > 0 && r / group != gcur) {\n      gcur = r / group;",
         "if (true) {\n      gcur = group > 0 ? r / group : 0;")]),
    "stores_then_loads": ("dequant", [
        (NEXT_LOAD, ""),
        ("    cur = nxt;\n", NEXT_LOAD + "    cur = nxt;\n")]),
    "plain_stores": ("dequant", [
        ("__stcs(reinterpret_cast<float4*>(dst + col), make_float4(v[0], v[1], "
         "v[2], v[3]));",
         "*reinterpret_cast<float4*>(dst + col) = make_float4(v[0], v[1], "
         "v[2], v[3]);")]),
    "decoder": ("dequant", [("constexpr bool LUT = F::BITS <= 8;",
                             "constexpr bool LUT = false;")]),
    "table_first": ("quire_dot", [
        (ROW_LOADS, "  fill_table(table, ROW_THREADS);\n  __syncthreads();\n"
                    "  load(threadIdx.x);\n")]),
    "row_unroll_1": ("quire_dot", [(UNROLL, "constexpr int ROW_UNROLL = 1; ")]),
    "row_unroll_4": ("quire_dot", [(UNROLL, "constexpr int ROW_UNROLL = 4; ")]),
    "row_threads_128": ("quire_dot", [(ROW_THREADS,
                                       "constexpr int ROW_THREADS = 128; ")]),
    "row_512x4": ("quire_dot", [(ROW_THREADS, "constexpr int ROW_THREADS = 512; "),
                                (UNROLL, "constexpr int ROW_UNROLL = 4; ")]),
    "ldg_loads": ("quire_dot", [("__ldcs(", "__ldg(")]),
}
# the committed library down another route or grid: name -> (kernel,
# route, factor on the strip route's bands)
ROUTE_VARIANTS = {
    "word_route": ("dequant", "word", None),
    "bands_half": ("dequant", "strip", 0.5),
    "bands_x2": ("dequant", "strip", 2.0),
    "scalar_route": ("quire_dot", "scalar", None),
}


def _sources():
    """{variant: {source name: text}} for the variants that rebuild."""
    base = {}
    for name in ("dequant", "quire_dot"):
        with open(os.path.join(_build.CSRC_DIR, name + ".cu")) as f:
            base[name] = f.read()
    out = {}
    for variant, (src, patches) in VARIANTS.items():
        texts = dict(base)
        for old, new in patches:
            if old not in texts[src]:
                raise RuntimeError(f"{variant}: the committed {src}.cu no "
                                   f"longer holds {old[:60]!r}")
            texts[src] = texts[src].replace(old, new)
        out[variant] = texts
    return out


def _build_all():
    """{variant: {source name: CDLL}}, every nvcc started at once."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for variant, texts in _sources().items():
        for name, text in texts.items():
            if variant != "committed" and VARIANTS[variant][0] != name:
                continue
            cu = os.path.join(OUT_DIR, f"{variant}-{name}.cu")
            with open(cu, "w") as f:
                f.write(text)
            procs[variant, name] = subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
                 "-o", cu[:-3] + ".so", cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (variant, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {variant}-{name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT_DIR, f"{variant}-{name}.so"))
        table = kcodec._ARGTYPES if name == "dequant" else kquire._ARGTYPES
        for fn, types in table.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        libs.setdefault(variant, {})[name] = lib
    committed = libs["committed"]
    return {v: {**committed, **libs.get(v, {})}
            for v in [*VARIANTS, *ROUTE_VARIANTS]}


def _time_ms(fn, iters: int = 20) -> float:
    """Median of CUDA-event intervals, each after a 128 MB L2-evicting
    write and a spin kernel (as ``chip_smoke.time_ms``)."""
    buf = torch.empty(32 << 20, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
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


def _dequant_call(lib, t, route=None, bands=None):
    """A dequant launch of packed slice ``t`` through ``lib``, down the
    plan's route or ``route`` (with ``bands`` times the plan's bands);
    returns (call, output)."""
    spec = t.spec
    k, n = t.shape
    kp = t.words.shape[0]
    np_ = t.scales.shape[1]
    g = t.scales.shape[0]
    plan = kcodec.dequant_plan(k, n, np_, spec.bits, True,
                               kcodec._sms(t.words.device))
    if route is not None:
        plan = plan._replace(route=route)
    if bands is not None:
        y = min(-(-k // kcodec.STRIP_WARPS), max(1, round(plan.grid[1] * bands)))
        plan = plan._replace(grid=(plan.grid[0], y))
    out = torch.empty((k, n), dtype=torch.float32, device="cuda")
    args = (t.words.data_ptr(), t.scales.data_ptr(), out.data_ptr(), k, n,
            np_, kp // g if g > 1 else 0, kcodec.KIND[spec.kind], spec.bits,
            spec.es, spec.ebits, spec.mbits, int(spec.has_nan),
            spec.frac_bits, kcodec.ROUTES[plan.route], *plan.grid, 0,
            torch.cuda.current_stream().cuda_stream)

    def call():
        err = lib.dequant(*args)
        if err:
            raise RuntimeError(f"dequant launch failed: CUDA error {err}")
    return call, out


def _quire_call(lib, a, b, route=None):
    bsz, k = a.shape
    route = route or kquire.quire_route(k)
    hi = torch.empty((bsz, 1), dtype=torch.int32, device="cuda")
    lo = torch.empty((bsz, 1), dtype=torch.int32, device="cuda")
    args = (a.data_ptr(), b.data_ptr(), hi.data_ptr(), lo.data_ptr(), bsz, k,
            kquire.ROUTES[route], torch.cuda.current_stream().cuda_stream)

    def call():
        err = lib.quire_dot(*args)
        if err:
            raise RuntimeError(f"quire_dot launch failed: CUDA error {err}")
    return call, (hi, lo)


def _inputs():
    from ..core import formats as fmt
    from ..kernels.ops import pack_tensor
    gen = torch.Generator("cuda").manual_seed(6)
    p8 = pack_tensor(fmt.POSIT8, torch.randn((1024, 1024), generator=gen,
                                             device="cuda"))
    p8g = pack_tensor(fmt.POSIT8, torch.randn((1024, 1024), generator=gen,
                                              device="cuda"), group_size=32)
    w = torch.randn((2, 896, 4864), generator=gen, device="cuda") * 0.05
    ffn = pack_tensor(fmt.FP4, w, group_size=None)[1]
    dq = {"dequant_p8": p8, "dequant_p8_g32": p8g, "dequant_ffn": ffn}
    codes = {}
    for tag, (bsz, k) in (("quire_64x1024", (64, 1024)),
                          ("quire_4096", (4096, 4096))):
        codes[tag] = tuple(torch.randint(0, 256, (bsz, k), generator=gen,
                                         device="cuda", dtype=torch.int32)
                           for _ in range(2))
    return dq, codes


def main() -> int:
    if not torch.cuda.is_available():
        print("engine_kernel_ablation: no CUDA device", file=sys.stderr)
        return 2
    from ..kernels.codec import dequant_plain
    libs = _build_all()
    dq, codes = _inputs()
    want = {tag: dequant_plain(t.words, t.scales, t.spec, *t.shape)
            for tag, t in dq.items()}
    want.update({tag: kquire.quire_dot_plain(*ab)
                 for tag, ab in codes.items()})
    cols = [*dq, *codes]
    print("variant,round,exact," + ",".join(f"{c}_ms" for c in cols))
    for rnd in (1, 2):
        floor = _time_ms(lambda: torch.cuda._sleep(0))
        print(f"launch_floor,{rnd},True," + ",".join(
            f"{floor:.4f}" for _ in cols), flush=True)
        for variant, lib in libs.items():
            kernel, route, bands = ROUTE_VARIANTS.get(variant,
                                                      (None, None, None))
            times, exact = [], True
            for tag in cols:
                if tag in dq:
                    if kernel == "quire_dot":
                        times.append(float("nan"))
                        continue
                    call, out = _dequant_call(lib["dequant"], dq[tag], route,
                                              bands)
                else:
                    if kernel == "dequant":
                        times.append(float("nan"))
                        continue
                    call, out = _quire_call(lib["quire_dot"], *codes[tag],
                                            route)
                call()
                torch.cuda.synchronize()
                ref = want[tag]
                same = torch.equal(out, ref) if tag in dq else (
                    torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]))
                exact = exact and same
                times.append(_time_ms(call))
            print(f"{variant},{rnd},{exact}," + ",".join(
                f"{t:.4f}" for t in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
