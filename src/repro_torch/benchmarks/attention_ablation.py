"""Where the attention kernels' time goes, on the card: ``csrc/flash_decode.cu``
as committed and copies with one ingredient taken out or changed, each
built with nvcc into ``build/attention_ablation/`` and timed at
``chip_smoke.py``'s shapes (qwen2-0.5b: B=8 paged decode at positions
255..700 over 128-slot pages, contiguous decode at T=256 pos 159, a
256-token prefill chunk at start 512), two rounds in turns.

  python -m repro_torch.benchmarks.attention_ablation

A copy that drops work (``no_mma``, ``no_exp``, ``no_dequant``,
``one_q_term``) computes wrong numbers on purpose; its error against the
plain version is printed beside its times.  Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from ..kernels import _build
from ..kernels import flash_decode as fd

OUT_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "attention_ablation")
TEAMS = "  static constexpr int TEAMS = DH >= 128 ? 1 : 2;"
MMA = """  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));"""

# name -> [(text of the committed source, its replacement), ...]
VARIANTS = {
    "committed": [],
    "no_mma": [(MMA, "  c[0] += __uint_as_float(a[0] ^ b0);"
                     " c[1] += __uint_as_float(a[1] ^ b1);")],
    "no_exp": [("const float p = expf(sc[j][e] - m[e / 2]);",
                "const float p = sc[j][e] - m[e / 2];")],
    "no_dequant": [
        ("      dequant_page<DH, NT>(s, s.stage + (t % 2) * sbytes, pg, Kh, h, Gs);",
         "      ;"),
        ("    dequant_page<DH, TEAM>(s, s.stage, FULL ? MAXS : page, Kh, h, Gs);",
         "    ;")],
    "one_q_term": [("  return (all & 2) ? 3 : (all & 1) ? 2 : 1;", "  return 1;")],
    "generic_width": [("if (page == max_sub(W))", "if (false)")],
    "prefill_teams_1": [(TEAMS, "  static constexpr int TEAMS = 1;")],
    "prefill_teams_4": [(TEAMS, "  static constexpr int TEAMS = DH >= 128 ? 2 : 4;")],
}


def _sources():
    with open(os.path.join(_build.CSRC_DIR, "flash_decode.cu")) as f:
        src = f.read()
    # the MMA wrapper lives in the shared header: inline it, so a variant
    # can change it for this file alone
    with open(os.path.join(_build.CSRC_DIR, "mma.cuh")) as f:
        header = f.read().replace("#pragma once\n", "")
    src = src.replace('#include "mma.cuh"\n', header)
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
        lib = ctypes.CDLL(os.path.join(OUT_DIR, name + ".so"))
        for fn, types in fd._ARGTYPES.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


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


def _inputs():
    from ..kernels.ref import quantize_kv
    gen = torch.Generator("cuda").manual_seed(4)
    b, kh, g, dh, page, npp = 8, 2, 7, 64, 128, 8
    kv = torch.randn((2, b * npp + 1, page, kh, dh), generator=gen,
                     device="cuda")
    pool = (*quantize_kv(kv[0], None), *quantize_kv(kv[1], None))
    pt = (torch.randperm(b * npp, generator=torch.Generator().manual_seed(0))
          + 1).reshape(b, npp).to(torch.int32).cuda()
    pos = torch.tensor([383, 511, 639, 700, 450, 300, 600, 255],
                       dtype=torch.int32, device="cuda")
    ckv = torch.randn((2, b, 256, kh, dh), generator=gen, device="cuda")
    contig = (*quantize_kv(ckv[0], None), *quantize_kv(ckv[1], None))
    q = torch.randn((b, kh, g, dh), generator=gen, device="cuda")
    q5 = torch.randn((1, 256, kh, g, dh), generator=gen, device="cuda")
    q5_bf16 = q5.to(torch.bfloat16).float()  # main-path q: one nonzero term
    st = torch.tensor([512], dtype=torch.int32, device="cuda")
    calls = {
        "paged_decode": lambda: fd.paged_flash_decode(q, *pool, pt, pos),
        "flash_decode": lambda: fd.flash_decode(q, *contig, 159),
        "prefill": lambda: fd.paged_flash_prefill(q5, *pool, pt[:1], st),
        "prefill_bf16_q": lambda: fd.paged_flash_prefill(q5_bf16, *pool,
                                                         pt[:1], st),
    }
    want = fd.paged_flash_prefill_plain(q5, *pool, pt[:1], st)
    return calls, lambda: (calls["prefill"]() - want).abs().max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_ablation: no CUDA device", file=sys.stderr)
        return 2
    libs = _build_all()
    calls, prefill_err = _inputs()
    committed = fd._lib
    print("variant,round,prefill_err," + ",".join(f"{k}_ms" for k in calls))
    try:
        for rnd in (1, 2):
            for name, lib in libs.items():
                fd._lib = lambda lib=lib: lib
                times = [_time_ms(fn) for fn in calls.values()]
                print(f"{name},{rnd},{prefill_err():.2e},"
                      + ",".join(f"{t:.4f}" for t in times), flush=True)
    finally:
        fd._lib = committed
    return 0


if __name__ == "__main__":
    sys.exit(main())
