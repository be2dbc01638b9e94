#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any miss:

  1. build: compile every CUDA source of ``src/repro_torch/csrc`` with
     nvcc (one process per source, all at once);
  2. kernels vs their plain PyTorch versions on the card, at the shapes
     of the main path: ``rmmec_matmul`` (FP4, posit8, posit16; per-channel
     and K-group 32 scales; M in {8, 1024}; both packed layouts; a weight
     with an all-zero mask block; then posit8 and FP4 x {per channel,
     group 32, group 64} x {stacked, 2-D} at K=1100, N=300 for M in {1,
     3, 8, 16, 17, 64, 256, 1024}, gated chunks among them), bitwise row
     invariance on every route (rows of an M=1024 call equal the same
     rows at M=256, 16, 8, 3 and 1, and a row equals itself among other
     rows; f32 x and posit16 stream at M <= 16, among them a 3584 x 8200
     posit16 weight with one gated block and f32 x with FP4 and posit8),
     every posit16 code decoded by the streaming kernel bitwise as by
     simt_kernel and the plain version, times of one layer's seven
     projections at M=8, 256 and 1024; the wgmma route (M > 16): rows of
     every route bitwise at qwen2's shapes and with gated chunks at K =
     1152, and one layer of qwen2-0.5b and gemma-2b (M = 256, 1024) and
     command-r-plus-104b (M = 256) at full width timed on wgmma_kernel and
     tile_kernel (each forced) beside the plan's route, torch.matmul and
     the bound, their rows bitwise each other's, and the projections the
     plan sent to the slower of the two;
     and ``flash_decode`` (qwen2-0.5b's B=8, Kh=2, G=7, Dh=64 over T=256
     slots, with pad and softcap; and over caches of 100, 66 and 67 slots,
     whose KV blocks are 4, 2 and 1 slots);
  3. the main path at full width: ``ServeEngine`` serving qwen2-0.5b
     (24 layers, d=896, vocab 151936) with the paper's mixed posit8/FP4
     policy and a posit8 KV cache, random weights from a seed, batch 8,
     prompt 128, 32 greedy steps; the launch counters must show every
     projection and every decode attention went through the kernels, and
     q/o/gate/up/down of the prefill (M = 1024) the wgmma route: 120
     launches (``wgmma_route.launches``); the static prefill is timed on
     the plan's routes and on the tiles alone;
  4. the reduced config (float32) served on the card and on the CPU
     (plain versions) from the same weights: logits and tokens must agree,
     also at max_len 100 and 66 (KV blocks of 4 and 2 slots) and at
     head_dim 256 (gemma-2b's width) and 320 (the wide route), with the
     decode kernel's launches counted.

and, for continuous batching over the paged posit8 KV pool:

  2b. ``paged_flash_decode`` and ``paged_flash_prefill`` vs their plain
      versions and the naive oracles at qwen2-0.5b's shapes (page 128,
      8 pages per request; positions 0, 127, 128, 1023, the first slots
      of pages and a parked row; chunks of 128 and 256, one at a start
      that is not page-aligned, one padded past the table's last
      column), bitwise against ``flash_decode`` over a shuffled scatter
      of a contiguous cache, ``flash_decode`` with a left pad bitwise
      against the decode entry point over the same cache as pages, and
      C=1 prefill bitwise against paged decode; pages of 24, 16, 4, 2 and
      1 slots (the kernels' generic-width path) against the plain versions
      too, the last three also bitwise against ``flash_decode``; pages of
      256 and 131 slots (walked as sub-pages), decode at page 256 bitwise
      against decode at page 128 and contiguous decode at blk 128; heads
      of 256 (gemma-2b: Kh=1, G=8), 112 and 40 columns at page 128, each
      timed beside SDPA; heads of 320, 512 and 300 columns (the wide
      route): contiguous decode, paged decode at pages 128 and 256 and
      256-token prefill chunks against the plain versions, bitwise paged
      == contiguous decode at page == blk and C=1 prefill == decode, Dh
      320 and 512 timed beside SDPA;
  2d. ``paged_kv_write`` (the paged posit8 KV write) at
      deepseek-67b.chat's heads (Kh 8, Dh 128, bf16 rows, pages of 128):
      a decode batch of 128 and a 256-token chunk bitwise the plain
      version in one launch each, timed (cold L2) beside the plain chain
      and the bytes bound, with the wrapper's host time a call;
  3b. ``ContinuousEngine`` serving full-width qwen2-0.5b (paper_mixed
      weights, 20 pages of 128 slots, prefix cache, 256-token chunks) a
      16-request mix with a shared preamble and staggered arrivals, at
      K=1 and K=4 decode steps per dispatch under the sync guard: equal
      tokens, a preemption and a prefix hit, exact launch counts; then
      K=1 on 10 pages of 256 slots: tokens equal the page-128 run's for
      every request neither run preempted;
  3c. ``DisaggEngine`` on phase 3b's traffic and weights (20 prefill + 20
      decode pages of 128 slots): K=4 under the sync guard, then K=1 on
      the first 4 requests with 8 decode pages and a depth-1 channel
      (bounces): tokens equal phase 3b's, handoff bytes equal pages x
      ``page_handoff_bytes``, exact launch counts; ``last_decode_step_s``
      p50/p99 printed beside phase 3b's ms per decode iteration;
  4b. the reduced config (float32): the carry context against the static
      engine, the card against the CPU, and prefix cache on against off;
      the serving CLI with ``--continuous --prefill-chunk 256`` (its page
      is the chunk) on the card;

and, for the recurrent, hybrid and MoE families (posit8 state slabs):

  3d. rwkv6-1.6b at full width and ``RWKV_DEPTH`` = 12 of its 24
      layers (d=2048, vocab 65536; cut from full size to keep the
      script well inside its time limit with phase 8 and phase 2's
      wgmma timings),
      ``paper_mixed``, 8 requests of 64-256 prompt tokens and 32 new
      ones, 128-token chunks: per-request static ``generate`` with
      posit8 state, ``ContinuousEngine`` at K=1 and K=4, K=1 on 3 state
      slabs for 8 batch slots (slab-gated admission), ``DisaggEngine`` at
      K=4 and at K=1 with one forced bounce (snapshot and resume): every
      run's tokens equal the static ones, exact launch counts (0
      attention), ``export_state`` bytes == ``state_slab_bytes``; ms per
      forward / decode iteration, the static step's device-busy share,
      peak memory; first the posit16 read-out at M = 8 timed beside its
      bytes bound (rows bitwise those of an M=64 call);
  3e. jamba-v0.1 at full width, depth 8 (one group: 7 Mamba, 1 attention,
      4 MoE of 16 experts top-2, 4 dense SwiGLU layers; MoE capacity 8.0),
      weights drawn and packed block by block on the card: every expert
      format's slices through ``dequant`` == ``to_dense`` bitwise, then
      3d's runs on 6 requests of 16 new tokens (traffic cut for time)
      plus K=1 on 8 KV pages (a running request preempted and
      resumed from its snapshot), exact launch counts (``flash_decode``
      per static step, ``paged_flash_decode`` per iteration, ``dequant``
      per expert slice); the read-out timed at M = 6 as in 3d;
  4c. reduced rwkv6, jamba and kimi-k2 in float32 (``paper_mixed``), card
      against CPU: prefill logits within 1e-4, greedy tokens equal, posit8
      state codes equal but for values straddling a rounding boundary
      (counted);

and, for the paper's SIMD-MAC engine plane:

  2c. ``dequant`` bit for bit against its plain version for every format
      RMMEC decodes x {per-channel, group 32, group 64} at K=N=1024 and
      on qwen2-0.5b's FP4 FFN slice (896 x 4864, stacked layout), and the
      ``quire_dot`` limbs bit for bit against theirs (random 64 x 1024
      codes with NaR, the cancellation case also against
      ``core.quire.quire_dot_exact``, 4096 x 4096), each kernel timed at
      both of its shapes beside its bound;
  5.  the engine plane's entry point at its own full size: the Table II
      and Table III bench twins (``repro_torch.benchmarks``) on the card,
      their CSV rows logged, with exact launch counts of ``rmmec_matmul``,
      ``dequant`` and ``quire_dot``;

and, for the paper's accuracy plane:

  6.  the ``bench_accuracy`` and ``bench_model_size`` twins on the card at
      the reference's sizes and steps (rows logged), then the card against
      the CPU: five AdamW steps of each perception model from one init
      (losses within 1e-4 relative), and ``quantize_tree`` bitwise equal
      on both devices under every policy of the sweep, with the quantized
      models' metrics within 1e-5;

and, for LM training:

  7.  the reference's quickstart (``repro_torch.examples.quickstart``,
      one entry point) at qwen2-0.5b's full width (24 layers,
      d=896, vocab 151936, remat "full"; seeded weights on the card;
      ``TokenStream`` seed 0, batch 16 x 256 over the reference
      quickstart's 512 ids): one calibration gradient,
      the layer-adaptive policy (at most 6.0 bits per quantized weight,
      scale groups of 32 so QAT and the packed plane share one grid), 20
      QAT steps (lr 3e-3, warmup 5, microbatch 2, posit8 moments, posit8
      gradient compression; every loss finite, the last below the first
      by 0.5) with ms per step, peak memory and one step profiled; an
      async checkpoint after step 10 restored bitwise into a fresh state,
      the data iterator resumed bitwise, steps 11-20 rerun within 1e-3 of
      the first run's losses; the trained tree packed (each packed leaf
      bitwise its fake-quantized leaf) and served (batch 2, prompt 8, 8
      greedy steps, posit8 KV) with exact ``rmmec_matmul`` /
      ``flash_decode`` launch counts; then three steps of the same step
      on the reduced float32 config on the card and on the CPU (losses
      within 1e-4 with f32 moments, 1e-3 with posit8 moments and
      compression);
  7b. rwkv6-1.6b at full width and ``RWKV_DEPTH`` = 12 layers (d 2048,
      d_ff 7168, vocab 65536; cut from full size with phase 8) trains
      with phase 7's feature set (mixed QAT, posit8 compression and
      moments, remat "full", the scans checkpointed per
      64-token chunk), batch 8 x 256, microbatch 2, 6 steps over the
      reduced vocab's ids: every loss finite, the last below the first;
      ms per step, launches and busy share of one profiled step, peak
      memory; then phase 7's three reduced steps, card against CPU, for
      rwkv6 and jamba;
  7c. the multi-device plane at world size 1: an NCCL group of one rank
      and ``make_host_mesh(1, 1)`` on the card; two sharded all-features
      steps of reduced float32 qwen2 and rwkv6 bitwise equal to the
      unsharded step (metrics and every state leaf); a checkpoint saved
      from the mesh restored bitwise on the mesh and unsharded;
      ``pipeline_apply`` at one stage equal to the stage;

and, for the other five architectures (weights drawn and packed layer by
layer on the card, ``paper_mixed``, posit8 KV):

  2b. more shapes: the decode entry point against its plain version and
      the naive oracle at the heads of qwen2-vl-7b (Kh 4, G 7, Dh 128),
      musicgen-medium (24, 1, 64), deepseek-67b (8, 8, 128) and
      command-r-plus-104b (8, 12, 128), each timed beside SDPA and the
      bytes bound; ``dequant`` of musicgen's posit16 1536 x 2048 read-out
      to bf16, bitwise;
  3f. gemma-2b at full size (18 layers, d 2048, MQA at Dh 256, GeGLU,
      vocab 256000 tied): static serving as phase 3, the carry context
      on its prompts equal to the static tokens, continuous serving on
      phase 3b's traffic at K=1 and K=4 (tokens equal), exact launch
      counts, each projection against plain at M = 1, 8, 128;
  3g. qwen2-vl-7b (vision, M-RoPE) and musicgen-medium (audio) at full
      width through ``zoo.apply_model`` / ``zoo.decode_model`` (the
      engines take token prompts only): 32 greedy steps, exact launch
      counts (musicgen's code embed through ``dequant``), finite logits,
      each projection and the posit16 read-out against plain at M = 2,
      qwen2-vl's read-out timed at M = 1, 2, 4, 8 and 16;
  3h. deepseek-67b and command-r-plus-104b at full width, depth 2: their
      widest projections against plain at M = 1, 8, 128, the posit16
      read-out (up to 12288 x 256000, RMMEC's streaming route) timed
      beside its bytes bound, its rows bitwise those of an M=64 call,
      static serving with exact launch counts (the streaming route's
      too);
  4d. the five configs reduced in float32, card against CPU: prefill and
      4 decode steps' logits within 1e-5 of max|logit|, gemma's
      continuous tokens equal.

and, for the port's last modules:

  8.  ``roofline.hw.detect()`` names the card's entry (``H100_SXM``); the
      decode, serve and e2e bench twins at qwen2-0.5b's full width (the
      serve twin's state cohort: rwkv6-1.6b full size) through
      ``repro_torch.benchmarks.run --only ... --full``, every token, byte
      and count assertion live, their rows logged, the two latency claims
      (chunked vs monolithic p99, disaggregated vs interleaved decode
      p99) printed with their numbers and ``met``, the kernels' launches
      counted; the dry run (``repro_torch.launch.dryrun``, fake tensors,
      two subprocesses on the host CPU started after the build) of
      phase 3's static cell and of
      phase 7's QAT step at mesh 1x1, each estimated peak within [0.67,
      1.5] of the peak phase 3 / phase 7 measured; ``vio_serve
      --continuous`` and ``train_lm`` (``repro_torch.examples``) at the
      reference's sizes.

The last lines are the card's name and power limit, one JSON line with
each kernel's launches, error and times, and ``{"ok": true, ...}``.
Without a CUDA card, or outside the repository, it exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import inspect
import io
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

RMMEC_SRC = "src/repro_torch/csrc/rmmec_matmul.cu"
FLASH_SRC = "src/repro_torch/csrc/flash_decode.cu"
RMMEC_TPU = "src/repro/kernels/rmmec_matmul.py:127"
FLASH_TPU = "src/repro/kernels/flash_decode.py:203"
PAGED_DECODE_TPU = "src/repro/kernels/flash_decode.py:289"
PAGED_PREFILL_TPU = "src/repro/kernels/flash_decode.py:383"
DEQUANT_SRC = "src/repro_torch/csrc/dequant.cu"
DEQUANT_TPU = "src/repro/kernels/codec.py:45"
QUIRE_SRC = "src/repro_torch/csrc/quire_dot.cu"
QUIRE_TPU = "src/repro/kernels/quire_dot.py:65"
KV_WRITE_SRC = "src/repro_torch/csrc/kv_write.cu"   # replaces no TPU kernel


def log(msg: str) -> None:
    print(msg, flush=True)


def _flush_l2(buf: torch.Tensor) -> None:
    buf.add_(1)   # touch 128 MB: evicts the 50 MB L2


SPIN_CYCLES = 400_000  # ~0.2 ms of device time at the H100's clocks


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms with a cold L2 before each call
    (CUDA events around each call).  A spin kernel after the flush keeps
    the stream busy while the host issues ``fn``'s launches, so the
    interval holds device work only, not the host's launch overhead; the
    median keeps one interval the host stalled past the spin from moving
    a 0.01 ms kernel's time."""
    buf = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        _flush_l2(buf)
        torch.cuda._sleep(SPIN_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    dt = time.perf_counter() - t0
    log(f"[build] {len(reports)} sources built in {dt:.1f} s "
        f"(nvcc {_build.nvcc_path()})")
    for name, rep in reports.items():
        used = [ln.strip() for ln in rep.splitlines() if "Used" in ln]
        spills = [ln.strip() for ln in rep.splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores")]
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in used]
        log(f"[build] {name}: {len(used)} kernels, registers max "
            f"{max(regs) if regs else 'n/a'}, lines reporting spills: "
            f"{len(spills)}")
        for ln in spills[:4]:
            log(f"[build]   {ln}")
        for fn, used in _ptxas_kernels(rep):   # every instantiation's
            log(f"[build]   {used} <- {fn[:110]}")


def _ptxas_kernels(report: str):
    """(kernel name, its 'Used N registers ...' line) from an nvcc
    -Xptxas -v report, names demangled where c++filt is on the path."""
    found, name = [], None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "Used" in ln and name is not None:
            found.append((name, ln.split("ptxas info    :")[-1].strip()))
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in found),
                               capture_output=True, text=True, timeout=30,
                               check=True).stdout.splitlines()
        if len(names) == len(found):
            found = [(n, u) for n, (_, u) in zip(names, found)]
    except (OSError, subprocess.SubprocessError):
        pass
    return found


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

RMMEC_RTOL = 1e-4   # |err| / max|plain|: f32 sums in another order, K <= 4864
FLASH_ATOL = 1e-4   # outputs are O(1) averages of V; exp/tanh and sum order


def _rmmec_case(spec, group, m, k, n, stacked, zero_block, gen, fails):
    from repro_torch.kernels.ops import pack_tensor
    from repro_torch.kernels.rmmec_matmul import (call_plan, default_blocks,
                                                  rmmec_matmul,
                                                  rmmec_matmul_plain)
    w = torch.randn((2, k, n) if stacked else (k, n), generator=gen,
                    device="cuda") * 0.05
    if zero_block:
        # 2-D layout: the first K block of rows (a gated mask block, so
        # gated chunks); stacked: the whole slice (its one gate)
        w[..., : (default_blocks(spec)[1] if not stacked else k), :] = 0.0
    t = pack_tensor(spec, w, group_size=group)
    if stacked:
        t = t[1]
    if zero_block and int(t.mask.min()) != 0:
        fails.append(f"rmmec: the zero-block weight has no gated block "
                     f"({spec.name}, stacked={stacked})")
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    got = rmmec_matmul(x, t.words, t.scales, t.mask, t.spec, n)
    want = rmmec_matmul_plain(x, t.words, t.scales, t.spec, n)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ref = want.abs().max().item()
    ok = err <= RMMEC_RTOL * ref and torch.isfinite(got).all().item()
    route = call_plan(x, t.words, t.spec, n).route
    tag = (f"{spec.name:9s} g={str(group):4s} M={m:5d} K={k:5d} N={n:5d} "
           f"{'stacked' if stacked else '2-D':7s} mask={tuple(t.mask.shape)}"
           f" gated={int((t.mask == 0).sum())} route={route}")
    log(f"[rmmec] {tag} max_abs_err={err:.3e} (tol {RMMEC_RTOL * ref:.3e}) "
        f"{'ok' if ok else 'MISS'}")
    if not ok:
        fails.append(f"rmmec {tag}")
    return err, ok, x, t, w


def _rmmec_times(x, t):
    """(kernel ms, plain ms, library ms, bytes, flops) of one projection."""
    from repro_torch.kernels.ops import to_dense
    from repro_torch.kernels.rmmec_matmul import rmmec_matmul, rmmec_matmul_plain
    n = t.shape[1]
    dense = to_dense(t).to(x.dtype).contiguous()
    ms = time_ms(lambda: rmmec_matmul(x, t.words, t.scales, t.mask, t.spec, n))
    plain = time_ms(lambda: rmmec_matmul_plain(x, t.words, t.scales, t.spec, n))
    lib = time_ms(lambda: torch.matmul(x, dense))
    m, k = x.shape
    nbytes = (x.numel() * x.element_size() + t.words.numel() * 4
              + t.scales.numel() * 4 + t.mask.numel() * 4 + m * n * 4)
    return ms, plain, lib, nbytes, 2.0 * m * k * n


def _rmmec_rows(spec, group, k, n, stacked, zero_block, xdtype, gen, fails,
                route=None):
    """Bitwise row invariance: rows of an M=1024 call equal the same rows
    of M=256, 16, 8, 3 and 1 calls (other routes, other tiles), and rows
    equal themselves among other rows of random content; the M=8 call
    within ``RMMEC_RTOL`` of the plain version.  ``zero_block``: True
    zeros the 2-D layout's first K block of rows, "block" its first mask
    block only.  ``route`` "wgmma": its calls above 16 rows on the wgmma
    route wherever it can go (``_on_route``).  Returns the M=8 call's
    error."""
    import contextlib
    with _on_route(route) if route else contextlib.nullcontext():
        return _rmmec_rows_on(spec, group, k, n, stacked, zero_block, xdtype,
                              gen, fails, route)


def _rmmec_rows_on(spec, group, k, n, stacked, zero_block, xdtype, gen, fails,
                   route):
    from repro_torch.kernels.ops import pack_tensor
    from repro_torch.kernels.rmmec_matmul import (call_plan, default_blocks,
                                                  rmmec_matmul,
                                                  rmmec_matmul_plain)
    w = torch.randn((2, k, n) if stacked else (k, n), generator=gen,
                    device="cuda") * 0.05
    _, bk, bn = default_blocks(spec)
    if zero_block == "block":
        w[..., :bk, :bn] = 0.0
    elif zero_block:
        w[..., :bk, :] = 0.0
    t = pack_tensor(spec, w, group_size=group)
    t = t[1] if stacked else t
    x = torch.randn((1024, k), generator=gen, device="cuda").to(xdtype)

    def run(xx):
        return rmmec_matmul(xx.contiguous(), t.words, t.scales, t.mask,
                            t.spec, n)

    full = run(x)
    checks = {m: torch.equal(run(x[:m]), full[:m])
              for m in (256, 16, 8, 3, 1)}
    other = torch.randn((1024, k), generator=gen, device="cuda").to(xdtype)
    for r in (0, 5, 700):       # row r among other rows, at M=1024 and 8
        mixed = other.clone()
        mixed[r] = x[r]
        checks[f"row {r} among others"] = torch.equal(run(mixed)[r], full[r])
        if r < 8:
            checks[f"row {r} among others M=8"] = torch.equal(
                run(mixed[:8])[r], full[r])
    want = rmmec_matmul_plain(x[:8], t.words, t.scales, t.spec, n)
    err = (run(x[:8]) - want).abs().max().item()
    tol = RMMEC_RTOL * want.abs().max().item()
    checks["M=8 vs plain"] = err <= tol
    routes = sorted({call_plan(x[:m], t.words, t.spec, n).route
                     for m in (1024, 256, 16, 8, 3, 1)})
    # not required: a row moved to another place in its 16-row MMA group
    moved = torch.equal(run(x[37:38])[0], full[37])
    ok = all(checks.values())
    tag = (f"{spec.name:9s} g={str(group):4s} K={k} N={n} "
           f"{'stacked' if stacked else '2-D'} gated={int((t.mask == 0).sum())}"
           f" x={str(xdtype).split('.')[-1]} routes={'/'.join(routes)}"
           f"{' (forced)' if route else ''}")
    log(f"[rmmec] bitwise rows {tag}: "
        + ", ".join(f"{c}: {'ok' if v else 'MISS'}" for c, v in checks.items())
        + f" (M=8 max_abs_err {err:.3e}, tol {tol:.3e}; row 37 alone at M=1,"
        f" not required: {moved})")
    if not ok:
        fails.append(f"rmmec bitwise rows {tag}")
    return err


def _posit16_every_code(fails) -> None:
    """Every posit16 code as one row of weights (K=1, N=65536, scales 1,
    x = 1): the streaming kernel's values (M=1) equal simt_kernel's (M=64,
    ``Posit<16,1>::decode``) bit for bit and the plain version's, for bf16
    and f32 x."""
    from repro_torch.core import formats as fmt
    from repro_torch.core.packing import pack
    from repro_torch.kernels.rmmec_matmul import (launch_plan, rmmec_matmul,
                                                  rmmec_matmul_plain)
    spec = fmt.POSIT16
    words = pack(torch.arange(1 << 16, device="cuda")[None], 16)
    scales = torch.ones((1, 1 << 16), device="cuda")
    mask = torch.ones((1, 1), dtype=torch.int32, device="cuda")
    for xdtype in (torch.bfloat16, torch.float32):
        x = torch.ones((64, 1), device="cuda", dtype=xdtype)
        one = rmmec_matmul(x[:1], words, scales, mask, spec)
        simt = rmmec_matmul(x, words, scales, mask, spec)[:1]
        plain = rmmec_matmul_plain(x[:1], words, scales, spec, 1 << 16)
        torch.cuda.synchronize()
        same = torch.equal(one.view(torch.int32), simt.view(torch.int32))
        as_plain = torch.equal(one, plain)
        routes = (launch_plan(1, 1, 1 << 16, xdtype, 16).route,
                  launch_plan(64, 1, 1 << 16, xdtype, 16).route)
        log(f"[rmmec] every posit16 code, x={str(xdtype).split('.')[-1]}: "
            f"{routes[0]} (M=1) == {routes[1]} (M=64) bitwise: {same}; == "
            f"plain: {as_plain}")
        if not (same and as_plain):
            fails.append(f"rmmec: posit16 codes decode differently "
                         f"({xdtype}: simt {same}, plain {as_plain})")


def phase_rmmec(summary, fails) -> None:
    from repro_torch.core import formats as fmt
    gen = torch.Generator("cuda").manual_seed(1)
    shapes = [(896, 896), (896, 128), (896, 4864), (4864, 896)]
    max_err = 0.0
    for spec in (fmt.FP4, fmt.POSIT8, fmt.POSIT16):
        for group in (None, 32):
            for m in (8, 8 * 128):
                for k, n in shapes:
                    for stacked in (True, False):
                        err, *_ = _rmmec_case(spec, group, m, k, n, stacked,
                                              False, gen, fails)
                        max_err = max(max_err, err)
    for stacked in (True, False):
        err, *_ = _rmmec_case(fmt.POSIT8, 32, 8, 896, 896, stacked, True,
                              gen, fails)
        max_err = max(max_err, err)
    # every M of the tensor routes (split-K up to 16, then tiles) at a K
    # that is not a multiple of the chunk (1100) and an N that is not one
    # of the tile (300; stacked: words not a multiple of 4); the 2-D
    # layout's first mask block gated, so gated chunks fold on both routes
    for spec in (fmt.POSIT8, fmt.FP4):
        for group in (None, 32, 64):
            for stacked in (True, False):
                for m in (1, 3, 8, 16, 17, 64, 256, 1024):
                    err, *_ = _rmmec_case(spec, group, m, 1100, 300, stacked,
                                          not stacked, gen, fails)
                    max_err = max(max_err, err)
        err, *_ = _rmmec_case(spec, None, 8, 1100, 300, True, True, gen,
                              fails)                      # a gated slice
        max_err = max(max_err, err)
    # qwen2's shapes (M = 1024 on the wgmma route where the plan sends it,
    # M = 256 on the tiles), k/v and K = 1152 in the 2-D layout with gated
    # chunks on the wgmma route wherever it can go, and K = 1100 (tile64):
    # the rows of every route against each other
    for spec, group, k, n, stacked, zero, route in (
            (fmt.POSIT8, None, 896, 896, True, False, None),
            (fmt.FP4, None, 896, 4864, True, False, None),
            (fmt.FP4, None, 4864, 896, True, False, None),
            (fmt.FP4, 32, 896, 4864, True, False, None),
            (fmt.POSIT8, None, 896, 128, True, False, "wgmma"),
            (fmt.FP4, 64, 1152, 300, False, True, "wgmma"),
            (fmt.POSIT8, None, 1152, 300, False, "block", "wgmma"),
            (fmt.POSIT8, 32, 1100, 300, True, False, None),
            (fmt.FP4, 64, 1100, 300, False, True, None),
            (fmt.POSIT8, None, 1100, 300, False, True, None)):
        _rmmec_rows(spec, group, k, n, stacked, zero, torch.bfloat16, gen,
                    fails, route)
    stream_err = 0.0
    # the f32 FMA routes (streaming M <= 16, SIMT above): f32 x, and
    # posit16 with bf16 x; a read-out-like posit16 shape with ragged edges
    # and one gated block, f32 x with FP4 and posit8 at K=1100, N=300
    for spec, group, k, n, stacked, zero, xdtype in (
            (fmt.POSIT8, None, 896, 896, True, False, torch.float32),
            (fmt.POSIT16, 32, 896, 896, True, False, torch.bfloat16),
            (fmt.POSIT16, None, 3584, 8200, False, "block", torch.bfloat16),
            (fmt.POSIT16, 32, 3584, 8200, False, "block", torch.bfloat16),
            (fmt.POSIT16, None, 3584, 8200, False, "block", torch.float32),
            (fmt.POSIT16, 32, 3584, 8200, False, "block", torch.float32),
            (fmt.FP4, 32, 1100, 300, False, True, torch.float32),
            (fmt.POSIT8, None, 1100, 300, True, False, torch.float32)):
        err = _rmmec_rows(spec, group, k, n, stacked, zero, xdtype, gen,
                          fails)    # its M=8 call streams
        stream_err = max(stream_err, err)
    max_err = max(max_err, stream_err)
    _posit16_every_code(fails)
    summary["rmmec_stream"] = dict(max_abs_err=stream_err)

    # times at the main path's shapes: one layer's seven projections under
    # paper_mixed (posit8 attention, FP4 FFN, per-channel scales), stacked
    # layout, bf16 activations
    proj = [(fmt.POSIT8, 896, 896), (fmt.POSIT8, 896, 128),
            (fmt.POSIT8, 896, 128), (fmt.POSIT8, 896, 896),
            (fmt.FP4, 896, 4864), (fmt.FP4, 896, 4864), (fmt.FP4, 4864, 896)]
    s = summary["rmmec_matmul"] = dict(max_abs_err=max_err)
    for m, label in ((8, "decode"), (256, "chunk"), (8 * 128, "prefill")):
        tot = [0.0] * 5
        for spec, k, n in proj:
            _, _, x, t, _ = _rmmec_case(spec, None, m, k, n, True, False, gen,
                                        fails)
            vals = _rmmec_times(x, t)
            log(f"[rmmec] time {label} {spec.name} M={m} K={k} N={n}: "
                f"kernel {vals[0]:.4f} ms, plain {vals[1]:.4f} ms, "
                f"library {vals[2]:.4f} ms")
            tot = [a + b for a, b in zip(tot, vals)]
        b_ms, b_by = bound_ms(tot[3], tot[4], PEAK_FLOPS["bf16"])
        log(f"[rmmec] one layer's 7 projections, {label} M={m}: kernel "
            f"{tot[0]:.4f} ms, plain {tot[1]:.4f} ms, library {tot[2]:.4f} "
            f"ms, bound {b_ms:.4f} ms ({b_by})")
        if m == 8:
            s.update(ms=tot[0], plain_ms=tot[1], library_ms=tot[2],
                     bound_ms=b_ms, bound_by=b_by)
        else:
            s.update({f"ms_m{m}": tot[0], f"plain_ms_m{m}": tot[1],
                      f"library_ms_m{m}": tot[2], f"bound_ms_m{m}": b_ms,
                      f"bound_by_m{m}": b_by})
    s["max_abs_err"] = max(max_err, _wgmma_layers(s, fails, gen))


# one layer's seven projections of each model the wgmma route is timed at,
# and the M of each: (tag, architecture id, rows)
WGMMA_LAYERS = (("qwen2", "qwen2-0.5b", (256, 1024)),
                ("gemma", "gemma-2b", (256, 1024)),
                ("commandr", "command-r-plus-104b", (256,)))
WGMMA_PLAIN_ALL = ("qwen2",)   # elsewhere the plain version times k alone


def _projections(arch):
    """(name, format, K, N) of one layer's packed projections under
    paper_mixed (posit8 attention, FP4 FFN) at the config's full width."""
    from repro_torch.configs import get_config
    from repro_torch.core import formats as fmt
    cfg = get_config(arch)
    d, q, kv = cfg.d_model, cfg.n_heads * cfg.head_dim, \
        cfg.n_kv_heads * cfg.head_dim
    return (("q", fmt.POSIT8, d, q), ("k", fmt.POSIT8, d, kv),
            ("v", fmt.POSIT8, d, kv), ("o", fmt.POSIT8, q, d),
            ("gate", fmt.FP4, d, cfg.d_ff), ("up", fmt.FP4, d, cfg.d_ff),
            ("down", fmt.FP4, cfg.d_ff, d))


def _on_route(route):
    """A context that sends every call to ``route`` ("wgmma": wherever TMA
    can take it; "tile": the 64- / 128-row tiles) whatever the plan says."""
    import contextlib
    from repro_torch.kernels import rmmec_matmul as rm

    @contextlib.contextmanager
    def ctx():
        saved = rm.wgmma_faster, rm.tma_aligned
        if route == "wgmma":
            rm.wgmma_faster = lambda *a: True
        else:
            rm.tma_aligned = lambda *a: False
        try:
            yield
        finally:
            rm.wgmma_faster, rm.tma_aligned = saved
    return ctx()


def _wgmma_layers(s, fails, gen) -> float:
    """The wgmma route at prefill shapes: one layer's seven projections of
    qwen2-0.5b and gemma-2b (M = 256, 1024) and command-r-plus-104b (M =
    256) at full width, stacked slices, per-channel scales, bf16 x, each
    weight packed once for its every M.  Each projection: the wgmma kernel
    and tile_kernel (each forced), the plan's route, torch.matmul on the
    dense bf16 copy, and the plain version (all of qwen2's; k alone
    elsewhere); the wgmma rows bitwise tile_kernel's, and within
    RMMEC_RTOL of plain where it was timed; which projections the plan
    sent to the slower of the two kernels.  Returns the largest error
    against plain."""
    from repro_torch.kernels.ops import pack_tensor, to_dense
    from repro_torch.kernels.rmmec_matmul import (call_plan, rmmec_matmul,
                                                  rmmec_matmul_plain)
    worst = 0.0
    slower, calls = [], 0
    for tag, arch, ms in WGMMA_LAYERS:
        t_arch = time.perf_counter()
        tots = {m: dict(wgmma=0.0, tile=0.0, kernel=0.0, library=0.0,
                        plain=0.0, bytes=0.0, flops=0.0) for m in ms}
        routes = {m: [] for m in ms}
        for name, spec, k, n in _projections(arch):
            t = pack_tensor(spec, torch.randn(
                (1, k, n), generator=gen, device="cuda") * 0.05)[0]
            dense = to_dense(t).to(torch.bfloat16).contiguous()
            for m in ms:
                tot = tots[m]
                x = torch.randn((m, k), generator=gen,
                                device="cuda").to(torch.bfloat16)

                def call():
                    return rmmec_matmul(x, t.words, t.scales, t.mask, t.spec,
                                        n)
                with _on_route("wgmma"):
                    route = call_plan(x, t.words, t.spec, n).route
                    got = call()
                    wg = time_ms(call)
                with _on_route("tile"):
                    tile = call()
                    tl = time_ms(call)
                routes[m].append(call_plan(x, t.words, t.spec, n).route)
                ms_kernel = time_ms(call)
                lib = time_ms(lambda: torch.matmul(x, dense))
                same = torch.equal(got, tile)
                calls += 1
                if (routes[m][-1] == "wgmma") != (wg < tl):
                    slower.append(f"{tag} M={m} {name} ({routes[m][-1]}: "
                                  f"wgmma {wg:.4f} ms, tiles {tl:.4f} ms)")
                line = (f"[rmmec] wgmma {tag} M={m} {name} {spec.name} "
                        f"K={k} N={n} ({route}): wgmma {wg:.4f} ms, "
                        f"tile_kernel {tl:.4f} ms, routed "
                        f"({routes[m][-1]}) {ms_kernel:.4f} ms, library "
                        f"{lib:.4f} ms; rows == tile_kernel's bitwise: "
                        f"{same}")
                if not same or route != "wgmma":
                    fails.append(f"rmmec wgmma {tag} M={m} {name}: route "
                                 f"{route}, bitwise {same}")
                if tag in WGMMA_PLAIN_ALL or name == "k":
                    plain = time_ms(lambda: rmmec_matmul_plain(
                        x, t.words, t.scales, t.spec, n), iters=5)
                    want = rmmec_matmul_plain(x, t.words, t.scales, t.spec,
                                              n)
                    err = (got - want).abs().max().item()
                    tol = RMMEC_RTOL * want.abs().max().item()
                    worst = max(worst, err)
                    line += (f"; plain {plain:.4f} ms, max_abs_err "
                             f"{err:.3e} (tol {tol:.3e})")
                    if not err <= tol:
                        fails.append(f"rmmec wgmma {tag} M={m} {name} vs "
                                     f"plain")
                    tot["plain"] += plain
                log(line)
                tot["wgmma"] += wg
                tot["tile"] += tl
                tot["kernel"] += ms_kernel
                tot["library"] += lib
                tot["bytes"] += (x.numel() * 2 + t.words.numel() * 4
                                 + t.scales.numel() * 4 + t.mask.numel() * 4
                                 + m * n * 4)
                tot["flops"] += 2.0 * m * k * n
                del x, got, tile
            del t, dense
            torch.cuda.empty_cache()
        for m in ms:
            tot = tots[m]
            b_ms, b_by = bound_ms(tot["bytes"], tot["flops"],
                                  PEAK_FLOPS["bf16"])
            plain_of = "7 projections" if tag in WGMMA_PLAIN_ALL else "k"
            log(f"[rmmec] wgmma one {tag} layer, M={m}: wgmma "
                f"{tot['wgmma']:.4f} ms, tile_kernel {tot['tile']:.4f} ms, "
                f"routed {tot['kernel']:.4f} ms ({'/'.join(routes[m])}), "
                f"library {tot['library']:.4f} ms, plain ({plain_of}) "
                f"{tot['plain']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
                f"wgmma / library {tot['wgmma'] / tot['library']:.2f}, "
                f"wgmma / bound {tot['wgmma'] / b_ms:.2f}")
            key = f"{tag}_m{m}"
            s.update({f"wgmma_ms_{key}": tot["wgmma"],
                      f"tile_ms_{key}": tot["tile"],
                      f"routed_ms_{key}": tot["kernel"],
                      f"library_ms_{key}": tot["library"],
                      f"plain_ms_{key}": tot["plain"],
                      f"bound_ms_{key}": b_ms, f"bound_by_{key}": b_by})
            if key == "qwen2_m1024":
                ratio = tot["wgmma"] / tot["library"]
                log(f"[rmmec] aim: qwen2 layer at M=1024 within 1.5x "
                    f"torch.matmul: {ratio:.2f}x, "
                    f"{'met' if ratio <= 1.5 else 'not met'}")
            if key == "commandr_m256":
                ratio = tot["wgmma"] / b_ms
                log(f"[rmmec] aim: command-r layer at M=256 within 2x its "
                    f"bf16 operations bound: {ratio:.2f}x, "
                    f"{'met' if ratio <= 2.0 else 'not met'}")
        log(f"[time] wgmma layers {tag} (M {', '.join(map(str, ms))}) "
            f"{time.perf_counter() - t_arch:.1f} s")
    log(f"[rmmec] route choice: {calls - len(slower)} of {calls} projections "
        f"on the faster of wgmma_kernel and tile_kernel in this run"
        + "".join(f"; slower: {x}" for x in slower))
    s["routed_to_slower"] = len(slower)
    return worst


def phase_flash(summary, fails) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import (default_kv_block,
                                                  flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.ref import quantize_kv
    from repro_torch.models.attention import dequantize_kv
    gen = torch.Generator("cuda").manual_seed(2)
    b, kh, g, dh, t = 8, 2, 7, 64, 256
    max_err = 0.0
    for group in (None, 32):
        kv = torch.randn((2, b, t, kh, dh), generator=gen, device="cuda")
        kc, ks = quantize_kv(kv[0], group)
        vc, vs = quantize_kv(kv[1], group)
        q = torch.randn((b, kh, g, dh), generator=gen, device="cuda")
        pad = torch.tensor([0, 3, 17, 64, 0, 1, 130, 5], dtype=torch.int32,
                           device="cuda")
        for pos in (0, 100, 159, 255):
            for use_pad in (False, True):
                for softcap in (0.0, 20.0):
                    pd = pad.clamp(max=pos) if use_pad else None
                    got = flash_decode(q, kc, ks, vc, vs, pos, pad=pd,
                                       softcap=softcap)
                    want = flash_decode_plain(q, kc, ks, vc, vs, pos, pd,
                                              softcap)
                    naive = ref.flash_decode_ref(q, kc, ks, vc, vs, pos,
                                                 softcap, pd)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    err_n = (got - naive).abs().max().item()
                    ok = err <= FLASH_ATOL and err_n <= FLASH_ATOL \
                        and torch.isfinite(got).all().item()
                    max_err = max(max_err, err)
                    tag = (f"group={group} pos={pos} pad={use_pad} "
                           f"softcap={softcap}")
                    log(f"[flash] {tag} max_abs_err={err:.3e} vs plain, "
                        f"{err_n:.3e} vs naive (tol {FLASH_ATOL}) "
                        f"{'ok' if ok else 'MISS'}")
                    if not ok:
                        fails.append(f"flash {tag}")
        if group is None:
            # the main path: the last decode step of phase 3 (pos 159)
            pos = 159
            ms = time_ms(lambda: flash_decode(q, kc, ks, vc, vs, pos))
            plain = time_ms(lambda: flash_decode_plain(q, kc, ks, vc, vs, pos))
            kd = dequantize_kv(kc[:, : pos + 1], ks[:, : pos + 1]) \
                .transpose(1, 2).contiguous()
            vd = dequantize_kv(vc[:, : pos + 1], vs[:, : pos + 1]) \
                .transpose(1, 2).contiguous()
            qd = q.reshape(b, kh * g, 1, dh).to(torch.bfloat16)
            lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qd, kd, vd, enable_gqa=True))
            live = pos + 1
            gs = ks.shape[-1]
            nbytes = (2 * b * live * kh * (dh + 2 * gs)
                      + q.numel() * 4 + b * kh * g * dh * 4)
            flops = 4.0 * b * kh * g * live * dh
            b_ms, b_by = bound_ms(nbytes, flops, PEAK_FLOPS["f32"])
            log(f"[flash] time B={b} T={t} pos={pos}: kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, library (SDPA, bf16, dequantized) "
                f"{lib:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
            summary["flash_decode"] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by)
    # caches whose default KV block is below 8 slots (max_len 100 -> 4,
    # 66 -> 2, 67 -> 1): scale blocks that are not whole 16-byte copies
    for t_small in (100, 66, 67):
        kv = torch.randn((2, b, t_small, kh, dh), generator=gen, device="cuda")
        for group in (None, 32):
            kc, ks = quantize_kv(kv[0], group)
            vc, vs = quantize_kv(kv[1], group)
            q = torch.randn((b, kh, g, dh), generator=gen, device="cuda")
            pad = torch.tensor([0, 3, 17, 64, 0, 1, 30, 5], dtype=torch.int32,
                               device="cuda")
            for pos in (0, 37, t_small - 1):
                pd = pad.clamp(max=pos)
                got = flash_decode(q, kc, ks, vc, vs, pos, pad=pd, softcap=20.0)
                want = flash_decode_plain(q, kc, ks, vc, vs, pos, pd, 20.0)
                naive = ref.flash_decode_ref(q, kc, ks, vc, vs, pos, 20.0, pd)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                err_n = (got - naive).abs().max().item()
                ok = err <= FLASH_ATOL and err_n <= FLASH_ATOL \
                    and torch.isfinite(got).all().item()
                max_err = max(max_err, err)
                tag = (f"T={t_small} blk={default_kv_block(t_small)} "
                       f"group={group} pos={pos} pad=True softcap=20.0")
                log(f"[flash] {tag} max_abs_err={err:.3e} vs plain, "
                    f"{err_n:.3e} vs naive (tol {FLASH_ATOL}) "
                    f"{'ok' if ok else 'MISS'}")
                if not ok:
                    fails.append(f"flash {tag}")
    # jamba-v0.1's attention layer as phase 3e's static engine runs it:
    # Kh=8, G=4, Dh=128, a 384-slot cache (blocks of 128), B=1 and B=8
    for bj in (1, 8):
        kv = torch.randn((2, bj, 384, 8, 128), generator=gen, device="cuda")
        for group in (None, 32):
            kc, ks = quantize_kv(kv[0], group)
            vc, vs = quantize_kv(kv[1], group)
            q = torch.randn((bj, 8, 4, 128), generator=gen, device="cuda")
            for pos in (0, 127, 128, 300, 383):
                got = flash_decode(q, kc, ks, vc, vs, pos)
                want = flash_decode_plain(q, kc, ks, vc, vs, pos)
                naive = ref.flash_decode_ref(q, kc, ks, vc, vs, pos)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                err_n = (got - naive).abs().max().item()
                ok = err <= FLASH_ATOL and err_n <= FLASH_ATOL \
                    and torch.isfinite(got).all().item()
                max_err = max(max_err, err)
                tag = (f"jamba Kh=8 G=4 Dh=128 B={bj} T=384 "
                       f"blk={default_kv_block(384)} group={group} pos={pos}")
                log(f"[flash] {tag} max_abs_err={err:.3e} vs plain, "
                    f"{err_n:.3e} vs naive (tol {FLASH_ATOL}) "
                    f"{'ok' if ok else 'MISS'}")
                if not ok:
                    fails.append(f"flash {tag}")
    summary["flash_decode"]["max_abs_err"] = max_err


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def phase_serve(summary, fails) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.rmmec_matmul import (launch_plan, rmmec_matmul,
                                                  wgmma_route)
    from repro_torch.models import zoo
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("qwen2-0.5b")
    b, s0, steps, max_len = 8, 128, 32, 256
    t0 = time.perf_counter()
    params = zoo.init_model(cfg, torch.Generator("cuda").manual_seed(0))
    eng = ServeEngine(cfg, params, max_len=max_len, quantized_kv=True,
                      policy=PrecisionPolicy.paper_mixed())
    del params
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff={cfg.d_ff}, vocab "
        f"{cfg.vocab}; init + pack {time.perf_counter() - t0:.1f} s")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (b, s0))
    eng.generate(toks, 2)                       # warm-up (not counted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(toks, 0)                       # prefill alone
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    rmmec_matmul.launches = 0
    flash_decode.launches = 0
    wgmma_route.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = eng.generate(toks, steps)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"rmmec_matmul": rmmec_matmul.launches,
                "flash_decode": flash_decode.launches}
    # the prefill (M = B x prompt = 1024) sends q, o, gate, up and down to
    # the wgmma route, once a layer (k and v: N = 128, the tiles); decode's
    # M = B rows take split-K
    on_wgmma = [name for name, spec, k, n in _projections(cfg.name)
                if launch_plan(b * s0, k, n, torch.bfloat16, spec.bits,
                               aligned=True).route == "wgmma"]
    want_wgmma = 5 * 24
    log(f"[serve] wgmma route launches {wgmma_route.launches}, expected "
        f"{want_wgmma} (prefill M={b * s0}: q/o/gate/up/down x 24 layers; "
        f"the plan's: {'/'.join(on_wgmma)} x {cfg.n_layers})")
    if wgmma_route.launches != want_wgmma \
            or on_wgmma != ["q", "o", "gate", "up", "down"]:
        fails.append(f"serve: the wgmma route launched "
                     f"{wgmma_route.launches} times for {on_wgmma}, "
                     f"expected {want_wgmma} for q/o/gate/up/down")
    summary["rmmec_matmul"]["launches_wgmma"] = wgmma_route.launches
    decode_s = max(total_s - prefill_s, 1e-9)
    per_tok_ms = decode_s / steps * 1e3
    summary["peak_bytes_serve"] = torch.cuda.max_memory_allocated()
    log(f"[serve] B={b} prompt={s0} steps={steps}: prefill "
        f"{prefill_s * 1e3:.1f} ms, decode {per_tok_ms:.2f} ms/step, "
        f"{b * steps / decode_s:.1f} tok/s, total {total_s * 1e3:.1f} ms, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    n_proj = 7 * cfg.n_layers
    want = {"rmmec_matmul": n_proj * (1 + steps),
            "flash_decode": cfg.n_layers * steps}
    log(f"[serve] launches {launches}, expected {want}")
    for name in want:
        if launches[name] != want[name]:
            fails.append(f"serve: {name} launched {launches[name]} times, "
                         f"expected {want[name]}")
        summary[name]["launches"] = launches[name]
    if out.shape != (b, s0 + steps) or out.min() < 0 \
            or out.max() >= cfg.vocab:
        fails.append(f"serve: bad output {out.shape} "
                     f"[{out.min()}, {out.max()}]")
    log(f"[serve] generated {out.shape}; first row tail "
        f"{out[0, s0:s0 + 8].tolist()}")
    # the static prefill on the plan's routes and with every M > 16 call on
    # the tiles (the routes before wgmma), nine rounds in turns
    pre = {"plan": [], "tiles": []}
    for _ in range(9):
        for key in pre:
            with _on_route("tile") if key == "tiles" \
                    else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.generate(toks, 0)
                torch.cuda.synchronize()
                pre[key].append((time.perf_counter() - t0) * 1e3)
    pre_ms = {key: float(np.median(v)) for key, v in pre.items()}
    log(f"[serve] static prefill M={b * s0}: plan {pre_ms['plan']:.2f} ms, "
        f"tiles only {pre_ms['tiles']:.2f} ms (medians of 9 in turns: "
        + "; ".join(f"{key} " + "/".join(f"{v:.2f}" for v in vals)
                    for key, vals in pre.items()) + ")")
    summary["rmmec_matmul"]["prefill_ms_plan"] = pre_ms["plan"]
    summary["rmmec_matmul"]["prefill_ms_tiles"] = pre_ms["tiles"]
    log("[serve] summary " + json.dumps(dict(
        prefill_ms=prefill_s * 1e3, decode_ms_per_step=per_tok_ms,
        tok_per_s=b * steps / decode_s)))
    profile_decode(eng, toks, per_tok_ms)


def _profile(fn, cpu: bool = True):
    """(wall ms, {kernel name: (device ms, calls)}, {op: host ms}) of one
    call of ``fn`` under torch.profiler (``cpu=False``: device activity
    only, for a step of ~10^5-10^6 launches; the host dict is then
    empty)."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu +
                 [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev, host = {}, {}
    if not cpu:
        # the raw device events: ``key_averages`` parses every event in
        # Python (~70 s for 10^6 of them)
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                ms, n = dev.get(e.name(), (0.0, 0))
                dev[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
        return wall, dev, host
    for ev in prof.key_averages():
        d = getattr(ev, "self_device_time_total", None)
        if d is None:
            d = getattr(ev, "self_cuda_time_total", 0)
        if d and ev.device_type.name == "CUDA":
            dev[ev.key] = (d / 1e3, ev.count)
        elif ev.self_cpu_time_total:
            host[ev.key] = ev.self_cpu_time_total / 1e3
    return wall, dev, host


ATTENTION_KERNELS = ("decode_page_kernel", "decode_fold_kernel",
                     "prefill_kernel")
RMMEC_KERNELS = ("split_k_kernel", "tile_kernel", "simt_kernel",
                 "stream_kernel", "stream_narrow_kernel", "wgmma_kernel")


def _top_and_attention(dev, n: int = 8):
    """The ``n`` kernels with the most device time, then any attention or
    RMMEC kernel of ``csrc/`` not among them."""
    ranked = sorted(dev.items(), key=lambda kv: -kv[1][0])
    return ranked[:n] + [kv for kv in ranked[n:] if any(
        a in kv[0] for a in ATTENTION_KERNELS + RMMEC_KERNELS)]


def _rmmec_share(dev, busy: float, per: float) -> str:
    """RMMEC's device ms (per ``per`` steps) and share of busy time."""
    ms = sum(v[0] for k, v in dev.items()
             if any(r in k for r in RMMEC_KERNELS))
    return (f"rmmec_matmul device {ms / per:.3f} ms of {busy / per:.3f} ms "
            f"busy ({ms / max(busy, 1e-9):.3f})")


def profile_decode(eng, toks, step_ms: float, steps: int = 8) -> None:
    """Where a decode step's time goes: profile prefill alone and prefill
    plus ``steps`` decode steps, and print the difference per step --
    device busy time and its share of the profiled step and of the
    unprofiled one (``step_ms``), kernels by device time, host ops by
    self time."""
    w0, d0, h0 = _profile(lambda: eng.generate(toks, 0))
    w1, d1, h1 = _profile(lambda: eng.generate(toks, steps))
    if not d1:
        log("[profile] the profiler recorded no device time")
        return
    dev = {k: ((v[0] - d0.get(k, (0.0, 0))[0]) / steps,
               (v[1] - d0.get(k, (0.0, 0))[1]) / steps)
           for k, v in d1.items()}
    wall = (w1 - w0) / steps
    busy = sum(v[0] for v in dev.values())
    log(f"[profile] decode step (B={toks.shape[0]}): wall {wall:.2f} ms "
        f"profiled / {step_ms:.2f} ms unprofiled, device busy {busy:.2f} ms, "
        f"busy share {busy / wall:.3f} profiled / {busy / step_ms:.3f} "
        f"unprofiled, kernel launches {sum(v[1] for v in dev.values()):.0f}")
    log(f"[profile] {_rmmec_share(dev, busy, 1)}")
    for k, (ms, n) in _top_and_attention(dev):
        log(f"[profile]   device {ms:8.3f} ms  {n:6.1f} calls  {k[:90]}")
    host = {k: (v - h0.get(k, 0.0)) / steps for k, v in h1.items()}
    for k, ms in sorted(host.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   host   {ms:8.3f} ms  {k[:90]}")


# ---------------------------------------------------------------------------
# phase 4: the whole path, card vs CPU
# ---------------------------------------------------------------------------

LOGIT_ATOL = 1e-3   # float32 config: only sum order differs (TF32 off)


def phase_parity(summary, fails) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import zoo
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    params = zoo.init_model(cfg, torch.Generator("cpu").manual_seed(3))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (4, 40))
    engines = {dev: ServeEngine(cfg, params, max_len=64, quantized_kv=True,
                                policy=PrecisionPolicy.paper_mixed(),
                                device=dev) for dev in ("cpu", "cuda")}
    logits = {}
    for dev, eng in engines.items():
        batch = {"tokens": torch.as_tensor(toks, device=dev)}
        with torch.inference_mode():
            logits[dev] = zoo.apply_model(eng.params, batch, cfg)[0].cpu()
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    lengths = [40, 33, 20, 7]
    outs = {dev: eng.generate(toks, 16, lengths=lengths)
            for dev, eng in engines.items()}
    same = bool(np.array_equal(outs["cpu"], outs["cuda"]))
    log(f"[parity] {cfg.name} (float32): prefill logits max_abs_err "
        f"{err:.3e} (tol {LOGIT_ATOL}); ragged greedy tokens equal: {same}")
    if not err <= LOGIT_ATOL:
        fails.append(f"parity: logits differ by {err}")
    if not same:
        fails.append("parity: greedy tokens differ between cuda and cpu")
    # max_len not a multiple of 8: the decode kernel runs KV blocks of 4
    # (100) and 2 (66) slots
    from repro_torch.kernels.flash_decode import default_kv_block, flash_decode
    steps = 16
    for max_len in (100, 66):
        engs = {dev: ServeEngine(cfg, params, max_len=max_len,
                                 quantized_kv=True,
                                 policy=PrecisionPolicy.paper_mixed(),
                                 device=dev) for dev in ("cpu", "cuda")}
        flash_decode.launches = 0
        outs = {dev: eng.generate(toks, steps, lengths=lengths)
                for dev, eng in engs.items()}
        torch.cuda.synchronize()
        n = flash_decode.launches
        same = bool(np.array_equal(outs["cpu"], outs["cuda"]))
        want = cfg.n_layers * steps
        log(f"[parity] {cfg.name} (float32) max_len={max_len} (KV block "
            f"{default_kv_block(max_len)}): ragged greedy tokens equal: "
            f"{same}; flash_decode launches {n}, expected {want}")
        if not same:
            fails.append(f"parity: max_len={max_len} greedy tokens differ "
                         f"between cuda and cpu")
        if n != want:
            fails.append(f"parity: max_len={max_len} flash_decode launched "
                         f"{n} times, expected {want}")
    # gemma-2b's head width (the 256-wide kernels, 64-slot sub-pages) and
    # a head of 320 columns (the wide route: its launches are the
    # attention_wide entry's)
    from repro_torch.kernels.flash_decode import wide_route
    for head_dim in (256, 320):
        wide = dataclasses.replace(cfg, head_dim=head_dim)
        wparams = zoo.init_model(wide, torch.Generator("cpu").manual_seed(7))
        engs = {dev: ServeEngine(wide, wparams, max_len=64,
                                 quantized_kv=True,
                                 policy=PrecisionPolicy.paper_mixed(),
                                 device=dev) for dev in ("cpu", "cuda")}
        wlogits = {}
        for dev, eng in engs.items():
            batch = {"tokens": torch.as_tensor(toks, device=dev)}
            with torch.inference_mode():
                wlogits[dev] = zoo.apply_model(eng.params, batch,
                                               wide)[0].cpu()
        err = (wlogits["cuda"] - wlogits["cpu"]).abs().max().item()
        flash_decode.launches = wide_route.launches = 0
        outs = {dev: eng.generate(toks, steps, lengths=lengths)
                for dev, eng in engs.items()}
        torch.cuda.synchronize()
        n, n_wide = flash_decode.launches, wide_route.launches
        same = bool(np.array_equal(outs["cpu"], outs["cuda"]))
        want = wide.n_layers * steps
        want_wide = want if head_dim > 256 else 0
        log(f"[parity] {wide.name} (float32) head_dim={head_dim}: prefill "
            f"logits max_abs_err {err:.3e} (tol {LOGIT_ATOL}); ragged greedy "
            f"tokens equal: {same}; flash_decode launches {n}, expected "
            f"{want}; wide route {n_wide}, expected {want_wide}")
        if not err <= LOGIT_ATOL:
            fails.append(f"parity: head_dim={head_dim} logits differ by "
                         f"{err}")
        if not same:
            fails.append(f"parity: head_dim={head_dim} greedy tokens differ "
                         f"between cuda and cpu")
        if n != want or n_wide != want_wide:
            fails.append(f"parity: head_dim={head_dim} flash_decode "
                         f"launched {n} times ({n_wide} wide), expected "
                         f"{want} ({want_wide})")
        if head_dim > 256:
            summary["attention_wide"]["launches"] = n_wide


# ---------------------------------------------------------------------------
# phase 2b: paged kernels vs plain versions
# ---------------------------------------------------------------------------

def _paged_pool(gen, n_pages, page, kh, dh, group):
    from repro_torch.kernels.ref import quantize_kv
    kv = torch.randn((2, n_pages, page, kh, dh), generator=gen, device="cuda")
    return (*quantize_kv(kv[0], group), *quantize_kv(kv[1], group))


def _check(tag, got, want, naive, fails, atol=FLASH_ATOL) -> float:
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    err_n = (got - naive).abs().max().item()
    ok = err <= atol and err_n <= atol and torch.isfinite(got).all().item()
    log(f"[paged] {tag} max_abs_err={err:.3e} vs plain, {err_n:.3e} vs "
        f"naive (tol {atol}) {'ok' if ok else 'MISS'}")
    if not ok:
        fails.append(f"paged {tag}")
    return err


def _bitwise(tag, got, want, fails) -> None:
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    log(f"[paged] bitwise {tag}: {'ok' if same else 'MISS'}")
    if not same:
        fails.append(f"paged bitwise {tag}")


def phase_paged(summary, fails) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import (
        _decode_cuda, flash_decode, paged_flash_decode,
        paged_flash_decode_plain, paged_flash_prefill,
        paged_flash_prefill_plain)
    from repro_torch.kernels.ref import quantize_kv
    gen = torch.Generator("cuda").manual_seed(4)
    b, kh, g, dh, page, npp = 8, 2, 7, 64, 128, 8
    n_pages = b * npp                        # + the parking page 0
    t = npp * page
    rng = np.random.default_rng(4)
    err_d = err_p = 0.0
    for group in (None, 32):
        pool = _paged_pool(gen, n_pages + 1, page, kh, dh, group)
        pt_np = rng.permutation(np.arange(1, n_pages + 1)).reshape(b, npp)
        pt_np[-1] = 0                        # a parked row: all page 0
        pt = torch.tensor(pt_np, dtype=torch.int32, device="cuda")
        q = torch.randn((b, kh, g, dh), generator=gen, device="cuda")
        for positions in ([0, 127, 128, 1023, 5, 300, 777, 0],
                          [1023, 640, 255, 129, 1, 900, 512, 0],
                          [128, 256, 384, 512, 640, 768, 896, 0]):
            pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
            for softcap in (0.0, 20.0):
                got = paged_flash_decode(q, *pool, pt, pos, softcap)
                err_d = max(err_d, _check(
                    f"decode group={group} pos={positions} softcap="
                    f"{softcap}", got,
                    paged_flash_decode_plain(q, *pool, pt, pos, softcap),
                    ref.paged_flash_decode_ref(q, *pool, pt, pos, softcap),
                    fails))
                # C=1 prefill rows are paged decode, bitwise
                one = paged_flash_prefill(q[:, None], *pool, pt, pos, softcap)
                _bitwise(f"C=1 prefill == decode group={group} "
                         f"pos={positions} softcap={softcap}", one[:, 0], got,
                         fails)
        # (B, C, starts): page-aligned chunks, one after a prefix hit (start
        # 200), and a padded final chunk whose rows from 1024 on lie past
        # the table's last column (compared on the rows inside it)
        for bb, c, starts in ((1, 128, [0]), (1, 256, [768]), (1, 256, [256]),
                              (3, 128, [0, 512, 896]), (3, 256, [0, 256, 768]),
                              (1, 128, [200]), (1, 256, [896])):
            q5 = torch.randn((bb, c, kh, g, dh), generator=gen, device="cuda")
            st = torch.tensor(starts, dtype=torch.int32, device="cuda")
            rows = min(c, t - max(starts))
            for softcap in (0.0, 20.0):
                got = paged_flash_prefill(q5, *pool, pt[:bb], st, softcap)
                err_p = max(err_p, _check(
                    f"prefill group={group} B={bb} C={c} start={starts} "
                    f"softcap={softcap} rows<{rows}", got[:, :rows],
                    paged_flash_prefill_plain(q5, *pool, pt[:bb], st,
                                              softcap)[:, :rows],
                    ref.paged_prefill_ref(q5, *pool, pt[:bb], st,
                                          softcap)[:, :rows],
                    fails))
        # a contiguous cache scattered over shuffled pages: paged decode ==
        # flash_decode with blk == page, bitwise
        kv = torch.randn((2, b, t, kh, dh), generator=gen, device="cuda")
        contig = (*quantize_kv(kv[0], group), *quantize_kv(kv[1], group))
        perm = torch.tensor(rng.permutation(np.arange(1, n_pages + 1))
                            .reshape(b, npp), dtype=torch.int32, device="cuda")
        scattered = [_scatter(x, perm, n_pages + 1, page) for x in contig]
        for p_ in (0, 127, 128, 700, 1023):
            pos = torch.full((b,), p_, dtype=torch.int32, device="cuda")
            _bitwise(f"paged == contiguous group={group} pos={p_}",
                     paged_flash_decode(q, *scattered, perm, pos, 20.0),
                     flash_decode(q, *contig, p_, softcap=20.0, blk=page),
                     fails)
        # flash_decode with a left pad (130 skips page 0) == the decode
        # entry point over the same cache as shuffled pages with that pad
        pad = torch.tensor([0, 3, 17, 64, 0, 1, 130, 5], dtype=torch.int32,
                           device="cuda")
        for p_ in (127, 128, 700, 1023):
            pos = torch.full((b,), p_, dtype=torch.int32, device="cuda")
            pd = pad.clamp(max=p_)
            _bitwise(f"flash_decode pad == decode entry over pages "
                     f"group={group} pos={p_}",
                     flash_decode(q, *contig, p_, pad=pd, softcap=20.0,
                                  blk=page),
                     _decode_cuda(q, *scattered, page, npp, perm, pos, pd, 0,
                                  20.0), fails)

    # pages other than 128 slots take the kernels' generic-width path: an
    # odd count of 8-slot tiles (24), a short page (16) with group 8, and
    # the pages below 8 slots of caches whose max_len is not a multiple of
    # 8 (4, 2, 1: part of an 8-slot tile, scale blocks of 16, 8 or 4 bytes)
    for gpage, group in ((24, None), (16, 8), (4, None), (2, 8), (1, 32)):
        gnp = max(6, 48 // gpage)
        gpool = _paged_pool(gen, 3 * gnp + 1, gpage, kh, dh, group)
        gpt = torch.tensor(rng.permutation(np.arange(1, 3 * gnp + 1))
                           .reshape(3, gnp), dtype=torch.int32, device="cuda")
        gpos = torch.tensor([0, 2 * gpage + 5, gnp * gpage - 1],
                            dtype=torch.int32, device="cuda")
        q3 = q[:3].contiguous()
        got = paged_flash_decode(q3, *gpool, gpt, gpos, 20.0)
        err_d = max(err_d, _check(
            f"decode page={gpage} group={group} pos={gpos.tolist()}", got,
            paged_flash_decode_plain(q3, *gpool, gpt, gpos, 20.0),
            ref.paged_flash_decode_ref(q3, *gpool, gpt, gpos, 20.0), fails))
        _bitwise(f"C=1 prefill == decode page={gpage} group={group}",
                 paged_flash_prefill(q3[:, None], *gpool, gpt, gpos, 20.0)[:, 0],
                 got, fails)
        gc = max(2 * gpage, 20)
        q5 = torch.randn((3, gc, kh, g, dh), generator=gen, device="cuda")
        gst = torch.tensor([0, gpage, 3 * gpage], dtype=torch.int32,
                           device="cuda")
        err_p = max(err_p, _check(
            f"prefill page={gpage} group={group} C={gc} "
            f"start={gst.tolist()}", paged_flash_prefill(q5, *gpool, gpt, gst),
            paged_flash_prefill_plain(q5, *gpool, gpt, gst),
            ref.paged_prefill_ref(q5, *gpool, gpt, gst), fails))
        if gpage < 8:
            # paged == contiguous with blk == page, over shuffled pages
            kv = torch.randn((2, 3, gnp * gpage, kh, dh), generator=gen,
                             device="cuda")
            contig = (*quantize_kv(kv[0], group), *quantize_kv(kv[1], group))
            scattered = [_scatter(x, gpt, 3 * gnp + 1, gpage) for x in contig]
            for p_ in (0, gpage, gnp * gpage - 1):
                pos = torch.full((3,), p_, dtype=torch.int32, device="cuda")
                _bitwise(f"paged == contiguous page={gpage} group={group} "
                         f"pos={p_}",
                         paged_flash_decode(q3, *scattered, gpt, pos, 20.0),
                         flash_decode(q3, *contig, p_, softcap=20.0, blk=gpage),
                         fails)

    # pages of more than 128 slots walk as sub-pages: 256 (two of 128) and
    # 131 (prime: 131 sub-pages of one slot)
    for bpage, group in ((256, None), (256, 32), (131, None)):
        bnp = 4 if bpage == 256 else 3
        bpool = _paged_pool(gen, 3 * bnp + 1, bpage, kh, dh, group)
        bpt = torch.tensor(rng.permutation(np.arange(1, 3 * bnp + 1))
                           .reshape(3, bnp), dtype=torch.int32, device="cuda")
        bpos = torch.tensor([0, bpage + 5, bnp * bpage - 1],
                            dtype=torch.int32, device="cuda")
        q3 = q[:3].contiguous()
        got = paged_flash_decode(q3, *bpool, bpt, bpos, 20.0)
        err_d = max(err_d, _check(
            f"decode page={bpage} group={group} pos={bpos.tolist()}", got,
            paged_flash_decode_plain(q3, *bpool, bpt, bpos, 20.0),
            ref.paged_flash_decode_ref(q3, *bpool, bpt, bpos, 20.0), fails))
        _bitwise(f"C=1 prefill == decode page={bpage} group={group}",
                 paged_flash_prefill(q3[:, None], *bpool, bpt, bpos,
                                     20.0)[:, 0], got, fails)
        bc = 256 if bpage == 256 else 96
        q5 = torch.randn((3, bc, kh, g, dh), generator=gen, device="cuda")
        bst = torch.tensor([0, bpage, 2 * bpage], dtype=torch.int32,
                           device="cuda")
        err_p = max(err_p, _check(
            f"prefill page={bpage} group={group} C={bc} "
            f"start={bst.tolist()}", paged_flash_prefill(q5, *bpool, bpt, bst),
            paged_flash_prefill_plain(q5, *bpool, bpt, bst),
            ref.paged_prefill_ref(q5, *bpool, bpt, bst), fails))
        if bpage == 256:
            # one cache scattered over pages of 256 and of 128 slots:
            # decode at page 256 == decode at page 128 == contiguous
            # decode at blk 128, bitwise
            kv = torch.randn((2, 3, bnp * bpage, kh, dh), generator=gen,
                             device="cuda")
            contig = (*quantize_kv(kv[0], group), *quantize_kv(kv[1], group))
            big = [_scatter(x, bpt, 3 * bnp + 1, bpage) for x in contig]
            pt128 = torch.tensor(rng.permutation(np.arange(1, 6 * bnp + 1))
                                 .reshape(3, 2 * bnp), dtype=torch.int32,
                                 device="cuda")
            small = [_scatter(x, pt128, 6 * bnp + 1, 128) for x in contig]
            for p_ in (0, 127, 128, 255, 256, 700, bnp * bpage - 1):
                pos = torch.full((3,), p_, dtype=torch.int32, device="cuda")
                at256 = paged_flash_decode(q3, *big, bpt, pos, 20.0)
                _bitwise(f"page 256 == contiguous blk 128 group={group} "
                         f"pos={p_}", at256,
                         flash_decode(q3, *contig, p_, softcap=20.0, blk=128),
                         fails)
                _bitwise(f"page 256 == page 128 group={group} pos={p_}",
                         at256, paged_flash_decode(q3, *small, pt128, pos,
                                                   20.0), fails)

    # head widths other than 64 at page 128: gemma-2b's attention (Kh=1,
    # G=8, Dh=256: 64-slot sub-pages), 112 (kimi-k2's width, on the
    # 128-wide kernel), 40 (on the 64-wide kernel, staged byte by byte)
    # and jamba-v0.1's attention layer (Kh=8, G=4, Dh=128: phase 3e)
    for wkh, wg, wdh in ((1, 8, 256), (2, 7, 112), (2, 7, 40), (8, 4, 128)):
        wpool = _paged_pool(gen, n_pages + 1, page, wkh, wdh, None)
        wpt = torch.tensor(rng.permutation(np.arange(1, n_pages + 1))
                           .reshape(b, npp), dtype=torch.int32, device="cuda")
        for group in (None, 8):
            if group is not None:
                wpool = _paged_pool(gen, n_pages + 1, page, wkh, wdh, group)
            wq = torch.randn((b, wkh, wg, wdh), generator=gen, device="cuda")
            wpos = torch.tensor([0, 127, 128, 1023, 5, 300, 777, 640],
                                dtype=torch.int32, device="cuda")
            got = paged_flash_decode(wq, *wpool, wpt, wpos, 20.0)
            err_d = max(err_d, _check(
                f"decode Kh={wkh} G={wg} Dh={wdh} group={group}", got,
                paged_flash_decode_plain(wq, *wpool, wpt, wpos, 20.0),
                ref.paged_flash_decode_ref(wq, *wpool, wpt, wpos, 20.0),
                fails))
            _bitwise(f"C=1 prefill == decode Kh={wkh} G={wg} Dh={wdh} "
                     f"group={group}", paged_flash_prefill(
                         wq[:, None], *wpool, wpt, wpos, 20.0)[:, 0], got,
                     fails)
            wq5 = torch.randn((2, 256, wkh, wg, wdh), generator=gen,
                              device="cuda")
            wst = torch.tensor([0, 512], dtype=torch.int32, device="cuda")
            err_p = max(err_p, _check(
                f"prefill Kh={wkh} G={wg} Dh={wdh} group={group} C=256 "
                f"start={wst.tolist()}",
                paged_flash_prefill(wq5, *wpool, wpt[:2], wst, 20.0),
                paged_flash_prefill_plain(wq5, *wpool, wpt[:2], wst, 20.0),
                ref.paged_prefill_ref(wq5, *wpool, wpt[:2], wst, 20.0), fails))
        _paged_times(f"Kh={wkh} G={wg} Dh={wdh}", gen, rng, b, wkh, wg, wdh,
                     page, npp)

    # times at the continuous path's shapes (qwen2-0.5b)
    d, p = _paged_times("", gen, rng, b, kh, g, dh, page, npp)
    summary["paged_flash_decode"] = dict(max_abs_err=err_d, **d)
    summary["paged_flash_prefill"] = dict(max_abs_err=err_p, **p)
    phase_wide(summary, fails, gen, rng)


def phase_wide(summary, fails, gen, rng) -> None:
    """Heads of more than 256 columns (the wide route): Dh 320, 512 and
    300 at qwen2-0.5b's Kh=2, G=7.  Each case: contiguous decode, paged
    decode at pages 128 and 256 and a 256-token prefill chunk against the
    plain versions (1e-4); bitwise paged == contiguous decode at page ==
    blk (128 and 256) and C=1 prefill == decode; times beside SDPA."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_plain, paged_flash_decode,
        paged_flash_decode_plain, paged_flash_prefill,
        paged_flash_prefill_plain, wide_route)
    from repro_torch.kernels.ref import quantize_kv
    b, kh, g = 4, 2, 7
    err = 0.0
    wide_route.launches = 0
    launched = 0
    for dh, group in ((320, None), (320, 32), (512, None), (512, 32),
                      (300, None), (300, 60)):
        tag = f"wide Dh={dh} group={group}"
        q = torch.randn((b, kh, g, dh), generator=gen, device="cuda")
        for page, npp in ((128, 6), (256, 3)):
            t = page * npp
            kv = torch.randn((2, b, t, kh, dh), generator=gen, device="cuda")
            contig = (*quantize_kv(kv[0], group), *quantize_kv(kv[1], group))
            pt = torch.tensor(rng.permutation(np.arange(1, b * npp + 1))
                              .reshape(b, npp), dtype=torch.int32,
                              device="cuda")
            pool = [_scatter(x, pt, b * npp + 1, page) for x in contig]
            positions = [0, page - 1, page + 5, t - 1]
            pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
            got = paged_flash_decode(q, *pool, pt, pos, 20.0)
            launched += 1
            err = max(err, _check(
                f"{tag} paged decode page={page} pos={positions}", got,
                paged_flash_decode_plain(q, *pool, pt, pos, 20.0),
                ref.paged_flash_decode_ref(q, *pool, pt, pos, 20.0), fails,
                atol=FLASH_ATOL))
            _bitwise(f"{tag} C=1 prefill == decode page={page}",
                     paged_flash_prefill(q[:, None], *pool, pt, pos,
                                         20.0)[:, 0], got, fails)
            launched += 1
            for p_ in (0, page, t - 1):
                one = torch.full((b,), p_, dtype=torch.int32, device="cuda")
                contiguous = flash_decode(q, *contig, p_, softcap=20.0,
                                          blk=page)
                launched += 1
                _bitwise(f"{tag} paged == contiguous page=blk={page} "
                         f"pos={p_}", paged_flash_decode(
                             q, *pool, pt, one, 20.0), contiguous, fails)
                launched += 1
            if page == 128:
                p_ = t - 40
                got = flash_decode(q, *contig, p_, softcap=20.0, blk=page)
                launched += 1
                torch.cuda.synchronize()
                want = flash_decode_plain(q, *contig, p_, softcap=20.0,
                                          blk=page)
                e = (got - want).abs().max().item()
                log(f"[paged] {tag} contiguous decode pos={p_} "
                    f"max_abs_err={e:.3e} vs plain (tol {FLASH_ATOL}) "
                    f"{'ok' if e <= FLASH_ATOL else 'MISS'}")
                if not e <= FLASH_ATOL:
                    fails.append(f"paged {tag} contiguous decode")
                err = max(err, e)
            q5 = torch.randn((2, 256, kh, g, dh), generator=gen,
                             device="cuda")
            st = torch.tensor([0, t - 256], dtype=torch.int32, device="cuda")
            err = max(err, _check(
                f"{tag} prefill page={page} C=256 start={st.tolist()}",
                paged_flash_prefill(q5, *pool, pt[:2], st, 20.0),
                paged_flash_prefill_plain(q5, *pool, pt[:2], st, 20.0),
                ref.paged_prefill_ref(q5, *pool, pt[:2], st, 20.0), fails))
            launched += 1
    torch.cuda.synchronize()
    if wide_route.launches != launched:
        fails.append(f"wide route launched {wide_route.launches} times, "
                     f"expected {launched}")
    log(f"[paged] wide route: {wide_route.launches} launches, max_abs_err "
        f"{err:.3e}")
    times = {}
    for dh in (320, 512):
        times[dh] = _paged_times(f"Kh={kh} G={g} Dh={dh} (wide route)", gen,
                                 rng, 8, kh, g, dh, 128, 8)
    d512, p512 = times[512]
    summary["attention_wide"] = dict(
        max_abs_err=err, **d512,
        **{f"{k}_prefill": v for k, v in p512.items()},
        **{f"{k}_dh320": v for k, v in times[320][0].items()},
        **{f"{k}_prefill_dh320": v for k, v in times[320][1].items()})


def _paged_times(tag, gen, rng, b, kh, g, dh, page, npp):
    """Times of both paged kernels at the continuous path's shapes: a
    decode dispatch row set of ``b`` requests mid-generation, and one
    256-token chunk late in a prompt (768 live slots); returns the two
    summaries (ms, plain_ms, library_ms, bound_ms, bound_by)."""
    from repro_torch.kernels.flash_decode import (
        paged_flash_decode, paged_flash_decode_plain, paged_flash_prefill,
        paged_flash_prefill_plain)
    n_pages = b * npp
    pool = _paged_pool(gen, n_pages + 1, page, kh, dh, None)
    pt = torch.tensor(rng.permutation(np.arange(1, n_pages + 1))
                      .reshape(b, npp), dtype=torch.int32, device="cuda")
    gs = pool[1].shape[-1]
    slot_bytes = 2 * kh * (dh + 2 * gs)          # K+V codes and scales
    positions = [383, 511, 639, 700, 450, 300, 600, 255]
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    q = torch.randn((b, kh, g, dh), generator=gen, device="cuda")
    ms = time_ms(lambda: paged_flash_decode(q, *pool, pt, pos))
    plain = time_ms(lambda: paged_flash_decode_plain(q, *pool, pt, pos))
    kd, vd, mask = _gathered_bf16(pool, pt, pos[:, None])
    qd = q.reshape(b, kh * g, 1, dh).to(torch.bfloat16)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True))
    live = sum(p_ + 1 for p_ in positions)
    nbytes = live * slot_bytes + 2 * q.numel() * 4 + pt.numel() * 4 + b * 4
    b_ms, b_by = bound_ms(nbytes, 4.0 * live * kh * g * dh, PEAK_FLOPS["f32"])
    head = f"{tag} " if tag else ""
    log(f"[paged] time decode {head}B={b} positions={positions}: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, library (SDPA, bf16, gathered "
        f"dequantized prefix, masked) {lib:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by})")
    decode = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                  bound_by=b_by)

    c, start = 256, 512
    q5 = torch.randn((1, c, kh, g, dh), generator=gen, device="cuda")
    st = torch.tensor([start], dtype=torch.int32, device="cuda")
    ms = time_ms(lambda: paged_flash_prefill(q5, *pool, pt[:1], st))
    plain = time_ms(lambda: paged_flash_prefill_plain(q5, *pool, pt[:1], st))
    qpos = start + torch.arange(c, device="cuda")
    kd, vd, mask = _gathered_bf16(pool, pt[:1], qpos[None], start + c)
    qd = q5.reshape(1, c, kh * g, dh).transpose(1, 2).to(torch.bfloat16)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True))
    pairs = sum(start + i + 1 for i in range(c))
    nbytes = (start + c) * slot_bytes + 2 * q5.numel() * 4 + npp * 4 + 4
    flops = 4.0 * pairs * kh * g * dh
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_FLOPS["f32"])
    # this design's own: three bf16 MMA terms per f32 product
    tc_ms, tc_by = bound_ms(nbytes, 3 * flops, PEAK_FLOPS["bf16"])
    # the main path hands the kernel bf16 activations: one nonzero q term
    q5b = q5.to(torch.bfloat16).float()
    ms_b = time_ms(lambda: paged_flash_prefill(q5b, *pool, pt[:1], st))
    log(f"[paged] time prefill {head}B=1 C={c} start={start}: kernel "
        f"{ms:.4f} ms (bf16-valued q, the main path's: {ms_b:.4f} ms), plain "
        f"{plain:.4f} ms, library (SDPA, bf16, causal mask) {lib:.4f} ms, "
        f"bound {b_ms:.5f} ms ({b_by}, f32), tensor-core bound {tc_ms:.5f} "
        f"ms ({tc_by}, 3 bf16 terms)")
    prefill = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                   bound_by=b_by)
    return decode, prefill


def _scatter(x, perm, n_pages, page):
    """A contiguous cache tensor (B, T, ...) cut into pages of ``page``
    slots and placed in a pool of ``n_pages`` pages at ``perm`` (B, T/page)."""
    buf = torch.zeros((n_pages, page) + x.shape[2:], dtype=x.dtype,
                      device="cuda")
    buf[perm.reshape(-1).long()] = x.reshape(-1, page, *x.shape[2:])
    return buf


def _gathered_bf16(pool, pt, horizon, width=None):
    """The library yardstick's operands: every request's pages gathered
    and dequantized to bf16 (B, Kh, T, Dh), cut to ``width`` slots, and a
    bool mask (B, 1, R, T) of the slots each query row sees."""
    from repro_torch.kernels.ref import dequant_kv_ref
    kc, ks, vc, vs = pool
    b, npp = pt.shape
    idx = pt.long()

    def gather(codes, scale):
        x = dequant_kv_ref(codes[idx], scale[idx])       # (B, NP, page, Kh, Dh)
        x = x.reshape(b, -1, *x.shape[3:])[:, :width]
        return x.transpose(1, 2).to(torch.bfloat16).contiguous()

    k, v = gather(kc, ks), gather(vc, vs)
    tpos = torch.arange(k.shape[2], device="cuda")
    mask = tpos[None, None, None, :] <= horizon[:, None, :, None]
    return k, v, mask


# ---------------------------------------------------------------------------
# phase 3b: continuous serving at full width
# ---------------------------------------------------------------------------

def _continuous_traffic(vocab: int):
    """16 requests from numpy seed 0: even ones share a 256-token
    preamble followed by 64-384 tokens of their own, odd ones have their
    own prompts of 96-640 tokens; 16-64 new tokens each."""
    rng = np.random.default_rng(0)
    preamble = rng.integers(0, vocab, 256)
    reqs = []
    for i in range(16):
        if i % 2 == 0:
            prompt = np.concatenate(
                [preamble, rng.integers(0, vocab, int(rng.integers(64, 385)))])
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(96, 641)))
        reqs.append((prompt, int(rng.integers(16, 65))))
    return reqs


def _serve_continuous(eng, reqs):
    """Submit the first 8 requests, step 3 times, submit the other 8, and
    drain; returns {request index: output tokens}."""
    rids = [eng.submit(p, n) for p, n in reqs[:8]]
    for _ in range(3):
        eng.step()
    rids += [eng.submit(p, n) for p, n in reqs[8:]]
    out = eng.run()
    return {i: out[r] for i, r in enumerate(rids)}


def _launch_counters():
    from repro_torch.kernels.codec import dequant
    from repro_torch.kernels.flash_decode import (
        flash_decode, paged_flash_decode, paged_flash_prefill)
    from repro_torch.kernels.kv_write import paged_kv_write
    from repro_torch.kernels.quire_dot import quire_dot
    from repro_torch.kernels.rmmec_matmul import rmmec_matmul
    return {"rmmec_matmul": rmmec_matmul, "flash_decode": flash_decode,
            "paged_flash_decode": paged_flash_decode,
            "paged_flash_prefill": paged_flash_prefill,
            "paged_kv_write": paged_kv_write,
            "dequant": dequant, "quire_dot": quire_dot}


def _continuous_run(tag, smi, cfg, params, kw, reqs, k, fails):
    """One ``ContinuousEngine`` run of ``reqs`` (``_serve_continuous``'s
    arrivals) on 20 pages at K=``k`` under the sync guard.  Checks the
    launch counts exactly (7 RMMEC a layer a forward, one paged decode /
    prefill a layer an iteration / chunk, one KV write a layer for each
    of them), every output's length and
    range, and that only the cached prefix pages stay in use after
    draining.  Returns ({request index: tokens}, stats, launches)."""
    from repro_torch.obs import TraceRecorder
    from repro_torch.serve.engine import ContinuousEngine
    rec = TraceRecorder()
    eng = ContinuousEngine(cfg, params, n_pages=20, decode_steps=k,
                           trace=rec, sync_guard=True, **kw)
    torch.cuda.reset_peak_memory_stats()
    out, wall, launches = _counted(lambda: _serve_continuous(eng, reqs))
    sched = eng.scheduler
    chunks = rec.count("PREFILL_CHUNK")
    iters = eng.decode_dispatches * k
    gen = sum(len(o) - len(p) for o, (p, _) in zip(out.values(), reqs))
    dec_ms = sum(e["dur"] for n in ("decode_dispatch", "decode_sync")
                 for e in rec.events(n)) * 1e3
    pre_ms = sum(e["dur"] for e in rec.events("prefill")) * 1e3
    st = dict(
        k=k, wall_s=wall, generated=gen, tok_per_s=gen / wall,
        dispatches=eng.decode_dispatches, decode_iterations=iters,
        ms_per_dispatch=dec_ms / max(eng.decode_dispatches, 1),
        ms_per_decode_iteration=dec_ms / max(iters, 1),
        prefill_chunks=chunks, ms_per_prefill_chunk=pre_ms / max(chunks, 1),
        preemptions=sched.preemption_count,
        preempted=list(sched.preempted_log),   # rid == request index
        prefix_hits=sched.prefix.hits,
        prefill_tokens=eng.prefill_tokens_computed,
        page_table_uploads=eng.page_table_uploads,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[{tag}] {smi}, K={k}: " + json.dumps(st))
    n_layers = cfg.n_layers
    _check_launches(f"{tag} K={k}", launches, {
        "paged_flash_decode": n_layers * iters,
        "paged_flash_prefill": n_layers * chunks,
        "paged_kv_write": n_layers * (iters + chunks),
        "rmmec_matmul": 7 * n_layers * (iters + chunks),
        "flash_decode": 0, "dequant": 0, "quire_dot": 0}, fails)
    if eng.pool.used_pages != len(sched.prefix.cached_pages):
        fails.append(f"{tag} K={k}: {eng.pool.used_pages} pages in use "
                     f"after draining, {len(sched.prefix)} cached")
    for i, (p, n) in enumerate(reqs):
        o = out[i]
        if len(o) != len(p) + n or o.min() < 0 or o.max() >= cfg.vocab:
            fails.append(f"{tag} K={k}: request {i} output {o.shape} "
                         f"[{o.min()}, {o.max()}]")
    return out, st, launches


def phase_continuous(summary, fails) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import zoo
    from repro_torch.serve.engine import ContinuousEngine, _sync_guard
    from repro_torch.serve.paged_kv import page_handoff_bytes

    # the guard the measured runs turn on must really refuse a sync
    try:
        with _sync_guard(True):
            torch.zeros(1, device="cuda").item()
        fails.append("continuous: the sync guard let a .item() through")
    except RuntimeError:
        pass
    cfg = get_config("qwen2-0.5b")
    smi = card()
    t0 = time.perf_counter()
    # paper_mixed, packed once and shared by the engines below
    params = zoo.pack_params(
        zoo.init_model(cfg, torch.Generator("cuda").manual_seed(0)),
        PrecisionPolicy.paper_mixed())
    kw = dict(max_len=1024, page_size=128, max_batch=8,
              prefill_chunk_tokens=256, prefix_cache=True)
    warm = ContinuousEngine(cfg, params, n_pages=8, **kw)
    rng = np.random.default_rng(1)
    for n in (300, 40):
        warm.submit(rng.integers(0, cfg.vocab, n), 3)
    warm.run()
    torch.cuda.synchronize()
    log(f"[cont] {cfg.name} paper_mixed, pool 20 x 128 slots "
        f"({21 * page_handoff_bytes(cfg, 128) / 1e6:.1f} MB with the "
        f"parking page); init, pack and warm-up "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = _continuous_traffic(cfg.vocab)
    counters = _launch_counters()
    outs, stats = {}, {}
    for k in (1, 4):
        outs[k], stats[k], launches = _continuous_run(
            "cont", smi, cfg, params, kw, reqs, k, fails)
        if k == 1:
            for name, n in launches.items():
                if n:
                    summary[name]["launches_continuous"] = n
    if stats[1]["preemptions"] < 1 or stats[1]["prefix_hits"] < 1:
        fails.append(f"continuous: K=1 run had {stats[1]['preemptions']} "
                     f"preemptions and {stats[1]['prefix_hits']} prefix hits")
    differ = [i for i in outs[1] if not np.array_equal(outs[1][i], outs[4][i])]
    log(f"[cont] K=1 and K=4 tokens equal for all {len(reqs)} requests: "
        f"{not differ}")
    if differ:
        fails.append(f"continuous: K=1 and K=4 tokens differ for requests "
                     f"{differ} (preempted: K=1 {stats[1]['preempted']}, "
                     f"K=4 {stats[4]['preempted']})")
    summary["continuous"] = stats
    _continuous_page_256(cfg, params, kw, reqs, outs[1], stats[1], counters,
                         fails)
    # phase 3c before the profiler window, so that both engines' runs
    # precede it
    t0 = time.perf_counter()
    phase_disagg(summary, fails, cfg, params, kw, reqs, outs[1], stats)
    log(f"[time] full-width disaggregated serve "
        f"{time.perf_counter() - t0:.1f} s")
    profile_continuous(cfg, params, kw, reqs)


# ---------------------------------------------------------------------------
# phase 3c: disaggregated serving at full width
# ---------------------------------------------------------------------------

def _serve_disagg(eng, reqs):
    """``_serve_continuous``'s arrivals, stepping by hand to keep each
    step's ``last_decode_step_s`` (steps that decoded); returns
    ({request index: output tokens}, [decode-side seconds per step])."""
    rids = [eng.submit(p, n) for p, n in reqs[:8]]
    dec = []
    for _ in range(3):
        eng.step()
        dec.append(eng.last_decode_step_s)
    rids += [eng.submit(p, n) for p, n in reqs[8:]]
    while eng.has_work:
        before = eng.decode_dispatches
        eng.step()
        if eng.decode_dispatches > before:
            dec.append(eng.last_decode_step_s)
    fin = eng.finished
    return {i: fin[r].output for i, r in enumerate(rids)}, dec


def phase_disagg(summary, fails, cfg, params, kw, reqs, want, cont) -> None:
    """``DisaggEngine`` on phase 3b's traffic and weights: 20 prefill + 20
    decode pages of 128 slots, K=4 under the sync guard, then a short K=1
    run (the first 4 requests, 17 pages of need) on 8 decode pages with
    a depth-1 channel, which bounces.  Tokens of every request equal phase 3b's; handoff
    bytes equal pages x ``page_handoff_bytes``; launch counts exact."""
    from repro_torch.obs import TraceRecorder
    from repro_torch.serve.disagg import DisaggEngine
    from repro_torch.serve.paged_kv import page_handoff_bytes
    counters = _launch_counters()
    smi = card()
    n_layers = cfg.n_layers
    stats = {}
    for tag, k, n_req, extra in (
            ("K=4", 4, len(reqs), dict(decode_pages=20)),
            ("K=1 bounce", 1, 4, dict(decode_pages=8, channel_depth=1))):
        rec = TraceRecorder()
        eng = DisaggEngine(cfg, params, prefill_pages=20, decode_steps=k,
                           trace=rec, sync_guard=True, **kw, **extra)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, dec = _serve_disagg(eng, reqs[:n_req])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        iters = eng.decode_dispatches * k
        chunks = rec.count("PREFILL_CHUNK")
        gen = sum(len(o) - len(p) for o, (p, _) in zip(out.values(), reqs))
        dec_ms = np.asarray(dec) * 1e3
        halves = {n: sum(e["dur"] for e in rec.events(n)) * 1e3
                  / max(eng.decode_dispatches, 1)
                  for n in ("decode_dispatch", "decode_sync", "prefill")}
        st = dict(
            k=k, requests=n_req, wall_s=wall, generated=gen,
            tok_per_s=gen / wall, dispatches=eng.decode_dispatches,
            decode_iterations=iters, prefill_chunks=chunks,
            decode_step_ms_p50=float(np.percentile(dec_ms, 50)),
            decode_step_ms_p99=float(np.percentile(dec_ms, 99)),
            decode_step_ms_per_iteration_p50=float(
                np.percentile(dec_ms, 50)) / k,
            dispatch_ms_mean=halves["decode_dispatch"],
            sync_ms_mean=halves["decode_sync"],
            prefill_step_ms_mean=halves["prefill"],
            handoffs=eng.handoffs, handoff_pages=eng.handoff_pages,
            handoff_bytes=eng.handoff_bytes, bounces=eng.decode_bounces,
            preemptions=eng.prefill.scheduler.preemption_count,
            prefix_hits=eng.prefill.scheduler.prefix.hits,
            page_table_uploads=eng.page_table_uploads)
        stats[tag] = st
        log(f"[disagg] {smi}, {tag}: " + json.dumps(st))
        log(f"[disagg] {tag}: last_decode_step_s p50 "
            f"{st['decode_step_ms_p50']:.2f} ms / p99 "
            f"{st['decode_step_ms_p99']:.2f} ms per step of K={k} "
            f"({st['decode_step_ms_per_iteration_p50']:.2f} ms per iteration) "
            f"beside phase 3b's {cont[k]['ms_per_decode_iteration']:.2f} ms "
            f"per decode iteration at K={k} (interleaved)")
        expect = {"paged_flash_decode": n_layers * iters,
                  "paged_flash_prefill": n_layers * chunks,
                  "paged_kv_write": n_layers * (iters + chunks),
                  "rmmec_matmul": 7 * n_layers * (iters + chunks),
                  "flash_decode": 0, "dequant": 0, "quire_dot": 0}
        log(f"[disagg] {tag} launches {launches}, expected {expect}")
        for name, n in expect.items():
            if launches[name] != n:
                fails.append(f"disagg {tag}: {name} launched "
                             f"{launches[name]} times, expected {n}")
        model = eng.handoff_pages * page_handoff_bytes(cfg, 128)
        if eng.handoff_bytes != model or eng.handoffs < n_req:
            fails.append(f"disagg {tag}: {eng.handoffs} handoffs of "
                         f"{eng.handoff_bytes} bytes, model {model}")
        if tag.endswith("bounce") and eng.decode_bounces < 1:
            fails.append(f"disagg {tag}: the small decode pool bounced "
                         f"nothing")
        if eng.decode.pool.used_pages or eng.prefill.pool.used_pages != len(
                eng.prefill.scheduler.prefix.cached_pages):
            fails.append(f"disagg {tag}: pages left in use after draining")
        differ = [i for i in out if not np.array_equal(out[i], want[i])]
        log(f"[disagg] {tag}: tokens equal phase 3b's for all {n_req} "
            f"requests: {not differ}")
        if differ:
            fails.append(f"disagg {tag}: tokens differ from phase 3b's for "
                         f"requests {differ}")
    summary["disagg"] = stats


def _continuous_page_256(cfg, params, kw, reqs, want, want_stats, counters,
                         fails) -> None:
    """The same traffic at K=1 on pages of 256 slots (10 of them plus the
    parking page: the bytes of 20 of 128), walked by the kernels as
    128-slot sub-pages: tokens equal the page-128 run's for every request
    neither run preempted; launch counts exact."""
    from repro_torch.obs import TraceRecorder
    from repro_torch.serve.engine import ContinuousEngine
    rec = TraceRecorder()
    eng = ContinuousEngine(cfg, params, n_pages=10, decode_steps=1, trace=rec,
                           sync_guard=True, **{**kw, "page_size": 256})
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = _serve_continuous(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    iters, chunks = eng.decode_dispatches, rec.count("PREFILL_CHUNK")
    sched = eng.scheduler
    n_layers = cfg.n_layers
    expect = {"paged_flash_decode": n_layers * iters,
              "paged_flash_prefill": n_layers * chunks,
              "paged_kv_write": n_layers * (iters + chunks),
              "rmmec_matmul": 7 * n_layers * (iters + chunks),
              "flash_decode": 0, "dequant": 0, "quire_dot": 0}
    log(f"[cont] page 256, K=1: wall {wall:.2f} s, {iters} iterations, "
        f"{chunks} prefill chunks, {sched.preemption_count} preemptions "
        f"(requests {list(sched.preempted_log)}), {sched.prefix.hits} prefix "
        f"hits; launches {launches}, expected {expect}")
    for name, n in expect.items():
        if launches[name] != n:
            fails.append(f"continuous page 256: {name} launched "
                         f"{launches[name]} times, expected {n}")
    preempted = set(want_stats["preempted"]) | set(sched.preempted_log)
    differ = [i for i in want if not np.array_equal(want[i], out[i])]
    for i in differ:
        cause = ("preempted (page 128: %s, page 256: %s)" % (
            i in want_stats["preempted"], i in sched.preempted_log)
            if i in preempted else "neither run preempted it")
        log(f"[cont] page 256 vs page 128, request {i}: tokens differ; "
            f"{cause}")
    bad = [i for i in differ if i not in preempted]
    log(f"[cont] page 256 == page 128 tokens for the {len(reqs) - len(preempted)}"
        f" requests neither run preempted: {not bad} ({len(differ)} of "
        f"{len(reqs)} differ in all)")
    if bad:
        fails.append(f"continuous page 256: tokens differ from page 128 for "
                     f"requests {bad}, which neither run preempted")


def profile_continuous(cfg, params, kw, reqs, warm_steps: int = 4,
                       steps: int = 1) -> None:
    """Where a continuous step's time goes: a K=4 engine on the same
    traffic, ``warm_steps`` steps unprofiled, then ``steps`` steps under
    the profiler -- device busy time and share, launches, top kernels."""
    from repro_torch.serve.engine import ContinuousEngine
    eng = ContinuousEngine(cfg, params, n_pages=20, decode_steps=4, **kw)
    for p, n in reqs:
        eng.submit(p, n)
    for _ in range(warm_steps):
        eng.step()

    def window():
        for _ in range(steps):
            eng.step()

    t0 = time.perf_counter()
    wall, dev, host = _profile(window)
    log(f"[cprofile] profiler window and its processing "
        f"{time.perf_counter() - t0:.1f} s")
    busy = sum(v[0] for v in dev.values())
    n = sum(v[1] for v in dev.values())
    log(f"[cprofile] {steps} steps of K=4 (profiled): wall {wall / steps:.2f} "
        f"ms/step, device busy {busy / steps:.2f} ms/step, busy share "
        f"{busy / wall:.3f}, kernel launches {n / steps:.0f}/step")
    log(f"[cprofile] {_rmmec_share(dev, busy, steps)} per step")
    for k, (ms, cnt) in _top_and_attention(dev):
        log(f"[cprofile]   device {ms / steps:8.3f} ms/step {cnt / steps:7.1f} "
            f"calls  {k[:90]}")
    for k, ms in sorted(host.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[cprofile]   host   {ms / steps:8.3f} ms/step  {k[:90]}")


# ---------------------------------------------------------------------------
# phases 3d / 3e: recurrent and hybrid serving at full width
# ---------------------------------------------------------------------------

def _stateful_traffic(vocab: int, n: int, new: int, seed: int):
    """``n`` requests from numpy ``seed``: prompts of 64-256 tokens,
    ``new`` new tokens each."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(64, 257))), new)
            for _ in range(n)]


def _per_forward(params, cfg):
    """(RMMEC, dequant) launches of one forward of ``cfg`` under its
    packed ``params``: one RMMEC per packed 2-D weight a layer reads (and
    the read-out), one dequant per expert slice of a packed expert
    stack."""
    from repro_torch.kernels.ops import PackedTensor
    rmmec = dequant = 0

    def walk(node, path, per):
        nonlocal rmmec, dequant
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}", per)
        elif isinstance(node, PackedTensor):
            if "/experts/" in path:
                dequant += per * node.words.shape[-3]
            else:
                rmmec += per
    for top, sub in params.items():
        if top in ("layers", "groups"):
            walk(sub, top, cfg.n_layers if top == "layers"
                 else cfg.n_layers // cfg.attn_every)
        else:
            walk(sub, top, 1)
    return rmmec, dequant


def _counted(fn):
    """(result, wall s, launches) of ``fn`` with every counter at 0."""
    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, \
        {n: c.launches for n, c in counters.items()}


def _drain(eng, reqs, bounce=False):
    """Submit every request and step to the end; ``bounce``: once a
    request decodes on a disaggregated engine's decode side, bounce the
    youngest.  Returns ({request index: tokens}, most requests running
    at once)."""
    disagg = hasattr(eng, "decode")
    sched = eng.prefill.scheduler if disagg else eng.scheduler
    rids = [eng.submit(p, n) for p, n in reqs]
    peak, bounced = 0, False
    while eng.has_work if disagg else sched.has_work:
        eng.step()
        running = eng.decode.runner.running if disagg else sched.running
        peak = max(peak, len(running))
        if bounce and not bounced:
            run = [r for r in running if not r.done]
            if run:
                eng.decode.runner.bounce(run[-1])
                bounced = True
    fin = eng.finished if disagg else sched.finished
    return {i: fin[r].output for i, r in enumerate(rids)}, peak


def _leaf_paths(tree, path=""):
    """{"/a/b": leaf} of a nested dict (a PackedTensor is one leaf)."""
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _leaf_paths(tree[k], f"{path}/{k}").items()}
    return {path: tree}


def _col_slabs(t, slab: int = 1 << 15):
    """(words, scales, columns) of one 2-D packed slice, ``slab`` columns
    at a time: a read-out of 256000 columns would dequantize to 12.6 GB
    of f32 at once, and each column's arithmetic is its own."""
    from repro_torch.core.packing import lanes_per_word
    per = lanes_per_word(t.spec.bits)
    n = t.shape[1]
    for c in range(0, n, slab):
        yield (t.words[:, c // per:(c + slab) // per].contiguous(),
               t.scales[:, c:c + slab].contiguous(), min(slab, n - c))


def _plain_slabs(x, t) -> torch.Tensor:
    """``rmmec_matmul_plain`` of one 2-D packed slice, by column slabs."""
    from repro_torch.kernels.rmmec_matmul import rmmec_matmul_plain
    return torch.cat([rmmec_matmul_plain(x, w, sc, t.spec, n)
                      for w, sc, n in _col_slabs(t)], dim=1)


def _rmmec_path_cases(tag, params, summary, fails,
                      ms=(1, 8, 128, 256)) -> None:
    """Every packed projection of ``params`` (not the expert stacks,
    which decode through ``dequant``): its first layer's slice through
    the kernel against the plain version at each M of ``ms`` (default: 1,
    8 (decode), 128 (a prefill chunk) and 256 (a whole static prompt)),
    bf16 activations as the path gives them."""
    from repro_torch.kernels.ops import PackedTensor
    from repro_torch.kernels.rmmec_matmul import call_plan, rmmec_matmul
    gen = torch.Generator("cuda").manual_seed(7)
    seen = set()
    worst = 0.0
    for path, t in _leaf_paths(params).items():
        if not isinstance(t, PackedTensor) or "/experts/" in path:
            continue
        while t.words.dim() > 2:
            t = t[0]
        k, n = t.shape
        key = (t.spec.name, t.group, k, n, tuple(t.words.shape))
        if key in seen:
            continue
        seen.add(key)
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            got = rmmec_matmul(x, t.words, t.scales, t.mask, t.spec, n)
            want = _plain_slabs(x, t)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = RMMEC_RTOL * want.abs().max().item()
            ok = err <= tol and torch.isfinite(got).all().item()
            worst = max(worst, err)
            route = call_plan(x, t.words, t.spec, n).route
            log(f"[{tag}] rmmec {path} {t.spec.name} g={t.group} M={m} "
                f"K={k} N={n} route={route}: max_abs_err={err:.3e} (tol "
                f"{tol:.3e}) {'ok' if ok else 'MISS'}")
            if not ok:
                fails.append(f"{tag} rmmec {path} M={m}")
    summary["rmmec_matmul"]["max_abs_err"] = max(
        summary["rmmec_matmul"]["max_abs_err"], worst)


def phase_stateful(summary, fails, tag, cfg, params, reqs, n_pages,
                   preempt_pages=None) -> None:
    """One recurrent or hybrid config at full width: per-request static
    ``generate(quantized_state=True)``, then ``ContinuousEngine`` at K=1
    and K=4, K=1 on 3 state slabs for ``max_batch`` 8 (slab-gated
    admission), K=1 on ``preempt_pages`` KV pages (a running request is
    preempted and resumed from its snapshot), ``DisaggEngine`` at K=4 and
    at K=1 with one forced bounce.  The slab-gated and bounce runs serve
    the first 4 requests (more than the 3 slabs), the others all of them.
    Every run's tokens equal the static ones; launch counts are exact."""
    from repro_torch.obs import TraceRecorder
    from repro_torch.serve.disagg import DisaggEngine
    from repro_torch.serve.engine import ContinuousEngine, ServeEngine
    from repro_torch.serve.paged_kv import state_slab_bytes
    smi = card()
    new = reqs[0][1]
    max_len = -(-(max(len(p) for p, _ in reqs) + new) // 128) * 128
    rm_fwd, dq_fwd = _per_forward(params, cfg)
    attn = cfg.n_attn_layers if cfg.family == "hybrid" else 0
    log(f"[{tag}] per forward: {rm_fwd} rmmec_matmul, {dq_fwd} dequant, "
        f"{attn} attention launches; slab {state_slab_bytes(cfg)} bytes")
    _rmmec_path_cases(tag, params, summary, fails)

    # static oracle, one request at a time
    st = ServeEngine(cfg, params, max_len=max_len, quantized_kv=True,
                     quantized_state=True)
    st.generate(reqs[0][0][None], 2)                 # warm-up
    want, wall, launches = _counted(lambda: {
        i: st.generate(p[None], n)[0] for i, (p, n) in enumerate(reqs)})
    fwd = sum(1 + n for _, n in reqs)
    steps = sum(n for _, n in reqs)
    expect = {"rmmec_matmul": rm_fwd * fwd, "dequant": dq_fwd * fwd,
              "flash_decode": attn * steps, "paged_flash_decode": 0,
              "paged_flash_prefill": 0, "quire_dot": 0}
    stats = {"static": dict(wall_s=wall, forwards=fwd,
                            ms_per_forward=wall / fwd * 1e3)}
    log(f"[{tag}] {smi}, static per request: wall {wall:.2f} s, {fwd} "
        f"forwards ({wall / fwd * 1e3:.2f} ms each); launches {launches}, "
        f"expected {expect}")
    for name, n in expect.items():
        if launches[name] != n:
            fails.append(f"{tag} static: {name} launched {launches[name]} "
                         f"times, expected {n}")
    for i, (p, n) in enumerate(reqs):
        o = want[i]
        if len(o) != len(p) + n or o.min() < 0 or o.max() >= cfg.vocab:
            fails.append(f"{tag} static: request {i} output {o.shape}")
    # a decode step's cost does not depend on the prompt (the state is
    # fixed-size): profile it behind a 16-token one
    profile_decode(st, reqs[0][0][None, :16], wall / fwd * 1e3, steps=4)

    kw = dict(page_size=128, max_batch=8, max_len=max_len,
              prefill_chunk_tokens=128)
    runs = [("K=1", ContinuousEngine, dict(n_pages=n_pages, decode_steps=1),
             reqs),
            ("K=4", ContinuousEngine, dict(n_pages=n_pages, decode_steps=4),
             reqs),
            ("K=1 3 slabs", ContinuousEngine,
             dict(n_pages=n_pages, decode_steps=1, n_state_slabs=3), reqs[:4]),
            ("disagg K=4", DisaggEngine,
             dict(prefill_pages=n_pages, decode_pages=n_pages,
                  decode_steps=4), reqs),
            ("disagg K=1 bounce", DisaggEngine,
             dict(prefill_pages=n_pages, decode_pages=n_pages,
                  decode_steps=1), reqs[:4])]
    if preempt_pages is not None:
        runs.insert(3, (f"K=1 {preempt_pages} pages", ContinuousEngine,
                        dict(n_pages=preempt_pages, decode_steps=1), reqs))
    for run, cls, extra, sub in runs:
        rec = TraceRecorder()
        eng = cls(cfg, params, trace=rec, sync_guard=True, **kw, **extra)
        torch.cuda.reset_peak_memory_stats()
        (out, peak), wall, launches = _counted(
            lambda: _drain(eng, sub, bounce=run.endswith("bounce")))
        k = extra["decode_steps"]
        iters = eng.decode_dispatches * k
        chunks = rec.count("PREFILL_CHUNK")
        dec_ms = sum(e["dur"] for n in ("decode_dispatch", "decode_sync")
                     for e in rec.events(n)) * 1e3
        sched = eng.prefill.scheduler if cls is DisaggEngine \
            else eng.scheduler
        pool = eng.decode.pool if cls is DisaggEngine else eng.pool
        stt = dict(wall_s=wall, decode_iterations=iters,
                   prefill_chunks=chunks,
                   ms_per_decode_iteration=dec_ms / max(iters, 1),
                   preemptions=sched.preemption_count,
                   requests=len(sub), resumes=rec.count("RESUME"),
                   most_running=peak,
                   slab_alloc_peak=pool.slab_alloc_peak,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        if cls is DisaggEngine:
            stt.update(handoffs=eng.handoffs, handoff_bytes=eng.handoff_bytes,
                       bounces=eng.decode_bounces)
        stats[run] = stt
        log(f"[{tag}] {smi}, {run}: " + json.dumps(stt))
        fwd = iters + chunks
        expect = {"rmmec_matmul": rm_fwd * fwd, "dequant": dq_fwd * fwd,
                  "flash_decode": 0, "paged_flash_decode": attn * iters,
                  "paged_flash_prefill": 0, "quire_dot": 0}
        log(f"[{tag}] {run} launches {launches}, expected {expect}")
        for name, n in expect.items():
            if launches[name] != n:
                fails.append(f"{tag} {run}: {name} launched "
                             f"{launches[name]} times, expected {n}")
            if run == "K=1" and n:
                summary[name][f"launches_{tag}"] = launches[name]
        differ = [i for i in out if not np.array_equal(out[i], want[i])]
        log(f"[{tag}] {run}: tokens equal the static ones for all "
            f"{len(out)} requests served: {not differ}")
        if differ:
            fails.append(f"{tag} {run}: tokens differ from static for "
                         f"requests {differ}")
        if run == "K=1 3 slabs" and (peak > 3 or pool.slab_alloc_peak != 3):
            fails.append(f"{tag} {run}: {peak} running at once, slab peak "
                         f"{pool.slab_alloc_peak}")
        if run.endswith("pages") and (sched.preemption_count < 1
                                      or stt["resumes"] < 1):
            fails.append(f"{tag} {run}: {sched.preemption_count} "
                         f"preemptions, {stt['resumes']} snapshot resumes")
        if run.endswith("bounce") and (eng.decode_bounces != 1
                                       or stt["resumes"] != 1):
            fails.append(f"{tag} {run}: {eng.decode_bounces} bounces, "
                         f"{stt['resumes']} resumes")
        if pool.used_slabs:
            fails.append(f"{tag} {run}: {pool.used_slabs} slabs in use "
                         f"after draining")
        if run == "K=1":
            sl = pool.alloc_slab()
            got = sum(v.numel() * v.element_size()
                      for v in _leaf_paths(pool.export_state(sl)).values())
            pool.free_slab(sl)
            log(f"[{tag}] export_state bytes {got}, state_slab_bytes "
                f"{state_slab_bytes(cfg)}")
            if got != state_slab_bytes(cfg):
                fails.append(f"{tag}: export_state holds {got} bytes, "
                             f"state_slab_bytes says {state_slab_bytes(cfg)}")
    summary[tag] = stats


# rwkv6-1.6b's depth in phases 3d and 7b: half its 24 layers since phase 8
# joined the script (both phases are host-bound, ~linear in depth)
RWKV_DEPTH = 12


def phase_rwkv(summary, fails) -> None:
    """Phase 3d: rwkv6-1.6b at its full width (d 2048, vocab 65536) and
    ``RWKV_DEPTH`` layers, ``paper_mixed`` weights, posit8 state slabs; 8
    requests of 64-256 prompt tokens and 32 new ones, 128-token
    chunks."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import zoo
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), n_layers=RWKV_DEPTH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = zoo.init_model(cfg, torch.Generator("cuda").manual_seed(0),
                            policy=PrecisionPolicy.paper_mixed())
    torch.cuda.synchronize()
    log(f"[rwkv6] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"d_ff={cfg.d_ff}, vocab {cfg.vocab}, paper_mixed; init + pack "
        f"{time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _readout_time("rwkv6", params, 8, summary, fails)  # 8 requests decode
    phase_stateful(summary, fails, "rwkv6", cfg, params,
                   _stateful_traffic(cfg.vocab, 8, 32, 0), n_pages=8)


def phase_jamba(summary, fails) -> None:
    """Phase 3e: jamba-v0.1 at its full width (d 4096, 32/8 heads of 128,
    16 experts top-2 of d_ff 14336, vocab 65536), depth cut 32 -> 8 (one
    group: 7 Mamba, 1 attention, 4 MoE, 4 dense SwiGLU layers) and MoE
    capacity 1.25 -> 8.0 (no pair dropped in any batch layout, so the
    schedules compare token for token); traffic 6 requests of 64-256
    prompt tokens and 16 new ones.  Weights drawn and packed block by
    block on the card; each expert slice through the dequant kernel
    equals ``to_dense`` of its stack bitwise for every expert format."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.kernels.ops import PackedTensor, dequant, to_dense
    from repro_torch.models import zoo
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8,
                              capacity_factor=8.0)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = zoo.init_model(cfg, torch.Generator("cuda").manual_seed(0),
                            policy=PrecisionPolicy.paper_mixed())
    torch.cuda.synchronize()
    n_par = sum(int(np.prod(t.words.shape[:-2])) * t.shape[0] * t.shape[1]
                if isinstance(t, PackedTensor) else t.numel()
                for t in _leaf_paths(params).values())
    log(f"[jamba8] {cfg.name} cut to n_layers {cfg.n_layers} (from 32) and "
        f"capacity_factor {cfg.capacity_factor} (from 1.25): "
        f"{n_par / 1e9:.2f}B parameters, paper_mixed; init + pack block by "
        f"block {time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, held "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    experts = {}
    for sub in params["groups"].values():
        if "moe" in sub:
            for leaf in sub["moe"]["experts"].values():
                experts.setdefault(leaf.spec.name, leaf)
    for name, leaf in experts.items():
        stack = leaf[0]
        whole = to_dense(stack, torch.bfloat16)
        same = all(torch.equal(dequant(stack[e], torch.bfloat16), whole[e])
                   for e in range(cfg.n_experts))
        log(f"[jamba8] expert format {name}: {cfg.n_experts} slices through "
            f"dequant == to_dense bitwise: {same}")
        if not same:
            fails.append(f"jamba8: a {name} expert slice through dequant "
                         f"differs from to_dense")
        del whole
    _readout_time("jamba8", params, 6, summary, fails)  # 6 requests decode
    # traffic cut to 6 requests of 16 new tokens (3d serves 8 of 32) to
    # keep the phase's wall time down; the width stays
    phase_stateful(summary, fails, "jamba8", cfg, params,
                   _stateful_traffic(cfg.vocab, 6, 16, 1), n_pages=24,
                   preempt_pages=8)


# ---------------------------------------------------------------------------
# phase 4c: recurrent, hybrid and MoE families, card vs CPU (float32)
# ---------------------------------------------------------------------------

STATE_LOGIT_ATOL = 1e-4


def phase_stateful_parity(fails) -> None:
    """Reduced rwkv6, jamba (capacity 8.0) and kimi-k2 in float32, one
    seeded ``paper_mixed`` tree served on the card and on the CPU:
    prefill logits within 1e-4, greedy tokens equal, and the posit8
    state after prefill equal code for code except where the two f32
    states straddle a rounding boundary (counted)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import zoo
    from repro_torch.serve.engine import ServeEngine
    for name in ("rwkv6-1.6b", "jamba-v0.1-52b", "kimi-k2-1t-a32b"):
        cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32",
                                  capacity_factor=8.0)
        stateful = cfg.family in ("ssm", "hybrid")
        params = zoo.init_model(cfg, torch.Generator("cpu").manual_seed(5),
                                policy=PrecisionPolicy.paper_mixed())
        toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 24))
        logits, raw, outs = {}, {}, {}
        for dev in ("cpu", "cuda"):
            eng = ServeEngine(cfg, params, max_len=64, quantized_kv=True,
                              quantized_state=stateful, device=dev)
            batch = {"tokens": torch.as_tensor(toks, device=dev)}
            with torch.inference_mode():
                logits[dev], raw[dev] = zoo.apply_model(eng.params, batch,
                                                        cfg)
            outs[dev] = eng.generate(toks, 16)
        err = (logits["cuda"].cpu() - logits["cpu"]).abs().max().item()
        same = bool(np.array_equal(outs["cpu"], outs["cuda"]))
        note = ""
        if stateful:
            qs = {dev: _leaf_paths(zoo.quantize_cache(raw[dev], None, True))
                  for dev in raw}
            n_codes = n_diff = 0
            worst = 0
            for key, want in qs["cpu"].items():
                if not key.endswith("_codes") or \
                        key.rsplit("/", 1)[-1].startswith(("k_", "v_")):
                    continue
                got = qs["cuda"][key].cpu()
                diff = got.to(torch.int32) - want.to(torch.int32)
                n_codes += diff.numel()
                n_diff += int((diff != 0).sum())
                worst = max(worst, int(diff.abs().max()))
                sk = key.replace("_codes", "_scale")
                if not torch.equal(qs["cuda"][sk].cpu(), qs["cpu"][sk]):
                    fails.append(f"state parity {name}: {sk} scales differ")
            note = (f"; state codes differing {n_diff} of {n_codes} (each "
                    f"one code step: {worst <= 1})")
            if worst > 1 or n_diff > n_codes // 1000:
                fails.append(f"state parity {name}: {n_diff} of {n_codes} "
                             f"state codes differ, by up to {worst}")
        log(f"[sparity] {cfg.name} (float32): prefill logits max_abs_err "
            f"{err:.3e} (tol {STATE_LOGIT_ATOL}); greedy tokens equal: "
            f"{same}{note}")
        if not err <= STATE_LOGIT_ATOL:
            fails.append(f"state parity {name}: logits differ by {err}")
        if not same:
            fails.append(f"state parity {name}: greedy tokens differ "
                         f"between cuda and cpu")


# ---------------------------------------------------------------------------
# phase 4b: continuous serving parity, reduced config in float32
# ---------------------------------------------------------------------------

def phase_continuous_parity(fails) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import zoo
    from repro_torch.serve.engine import ContinuousEngine, ServeEngine

    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    params = zoo.init_model(cfg, torch.Generator("cpu").manual_seed(5))
    rng = np.random.default_rng(5)
    preamble = rng.integers(0, cfg.vocab, 128)
    reqs = []
    for i, (n, new) in enumerate(((5, 8), (100, 12), (60, 6), (90, 10),
                                  (33, 16), (70, 9))):
        prompt = rng.integers(0, cfg.vocab, n)
        if i % 2:
            prompt = np.concatenate([preamble, prompt])
        reqs.append((prompt, new))
    policy = PrecisionPolicy.paper_mixed()
    kw = dict(n_pages=8, max_len=256, max_batch=4, policy=policy,
              prefill_chunk_tokens=128)

    def serve(device, **extra):
        eng = ContinuousEngine(cfg, params, device=device, **kw, **extra)
        rids = [eng.submit(p, n) for p, n in reqs]
        out = eng.run()
        return [out[r] for r in rids], eng

    carry, eng = serve("cuda", decode_steps=4)
    static = ServeEngine(cfg, params, max_len=256, quantized_kv=True,
                         policy=policy)
    want = [static.generate(p[None], n)[0] for p, n in reqs]
    ok_static = all(np.array_equal(a, b) for a, b in zip(carry, want))
    cpu, _ = serve("cpu", decode_steps=4)
    ok_cpu = all(np.array_equal(a, b) for a, b in zip(carry, cpu))
    on, eng_on = serve("cuda", decode_steps=2, prefix_cache=True)
    off, _ = serve("cuda", decode_steps=2, prefill_context="pages")
    ok_prefix = all(np.array_equal(a, b) for a, b in zip(on, off))
    log(f"[cparity] {cfg.name} (float32), page {eng.page_size}: carry "
        f"context == static engine: {ok_static}; card == CPU: {ok_cpu} "
        f"({eng.scheduler.preemption_count} preemptions); prefix cache on "
        f"== off (pages context, {eng_on.scheduler.prefix.hits} hits): "
        f"{ok_prefix}")
    for ok, what in ((ok_static, "carry context vs static engine"),
                     (ok_cpu, "card vs CPU"),
                     (ok_prefix, "prefix cache on vs off")):
        if not ok:
            fails.append(f"continuous parity: {what} tokens differ")
    if eng_on.scheduler.prefix.hits < 1:
        fails.append("continuous parity: no prefix hit")
    # the CLI's own page choice: --prefill-chunk 256 without --page-size
    # serves on 256-slot pages
    from repro_torch.kernels.flash_decode import paged_flash_decode
    from repro_torch.launch import serve
    argv, buf = sys.argv, io.StringIO()
    paged_flash_decode.launches = 0
    try:
        sys.argv = ["serve", "--reduced", "--continuous", "--batch", "2",
                    "--prompt-len", "12", "--steps", "4", "--n-pages", "6",
                    "--prefill-chunk", "256"]
        with contextlib.redirect_stdout(buf):
            serve.main()
    finally:
        sys.argv = argv
    text = buf.getvalue()
    pool_line = next((ln for ln in text.splitlines()
                      if ln.startswith("pool:")), "")
    ok = "served 4 requests" in text and "x 256 slots" in pool_line \
        and "on cuda" in text and paged_flash_decode.launches > 0
    log(f"[cparity] CLI --continuous --prefill-chunk 256 on the card: "
        f"{pool_line!r}, paged_flash_decode launches "
        f"{paged_flash_decode.launches}: {'ok' if ok else 'MISS'}")
    if not ok:
        fails.append(f"continuous CLI at page 256: {text[-400:]!r}")


# ---------------------------------------------------------------------------
# phase 2d: the paged posit8 KV write
# ---------------------------------------------------------------------------

KV_WRITE_CASES = (   # (tag, requests, tokens a request, start or None)
    ("decode", 128, 1, None),      # deepseek-67b.chat's decode batch
    ("chunk", 1, 256, 512),        # one 256-token chunk at block 4
)


def _kv_write_operands(tag, b, c, start, dh=128, kh=8, gs=1, page=128):
    """A pool of 1369 pages (deepseek-67b.chat's) and one write's rows
    (bf16) at the cell's heads: decode rows at random slots of distinct
    pages, or a chunk from ``start``."""
    gen = torch.Generator("cuda").manual_seed(21)
    n_pages = 1370
    pool = {}
    for name in ("k", "v"):
        pool[f"{name}_codes"] = torch.randint(
            0, 256, (n_pages, page, kh, dh), generator=gen, device="cuda",
            dtype=torch.uint8)
        pool[f"{name}_scale"] = torch.ones((n_pages, page, kh, gs),
                                           dtype=torch.bfloat16, device="cuda")
    shape = (b, kh, dh) if start is None else (b, c, kh, dh)
    k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    cols = 8            # 1024 of the 1369 pages for the decode batch
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda")[
        :b * cols] + 1).to(torch.int32).reshape(b, cols)
    if start is None:
        where = torch.randint(0, cols * page, (b,), generator=gen,
                              device="cuda", dtype=torch.int32)
    else:
        where = torch.full((b,), start, dtype=torch.int32, device="cuda")
    return pool, k, v, table, where


def phase_kv_write(summary, fails) -> None:
    """``paged_kv_write`` at the cell's shapes: bitwise the plain version,
    its device time (cold L2) beside the plain chain's and the bytes
    bound, and the wrapper's host time a call (enqueue, no sync)."""
    from repro_torch.kernels.kv_write import (paged_kv_write,
                                              paged_kv_write_plain)
    out = {}
    for tag, b, c, start in KV_WRITE_CASES:
        pool, k, v, table, where = _kv_write_operands(tag, b, c, start)
        kw = (dict(positions=where) if start is None else dict(start=where))
        want = {key: t.clone() for key, t in pool.items()}
        paged_kv_write_plain(want, k, v, table, **kw)
        launches = paged_kv_write.launches
        paged_kv_write(pool, k, v, table, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(pool[key].view(torch.uint8),
                               want[key].view(torch.uint8)) for key in pool)
        ok = same and paged_kv_write.launches == launches + 1
        ms = time_ms(lambda: paged_kv_write(pool, k, v, table, **kw))
        plain = time_ms(lambda: paged_kv_write_plain(pool, k, v, table,
                                                     **kw), iters=10)
        rows = b * c * 8
        nbytes = 2 * k.numel() * 2 + table.numel() * 4 + b * 4 \
            + 2 * rows * (128 + 2)
        b_ms, b_by = bound_ms(nbytes, 2.0 * k.numel(), PEAK_FLOPS["f32"])
        # host time a call: the wrapper's Python and the launch, the
        # stream kept busy so no call waits for the card
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES * 10)
        n = 200
        t0 = time.perf_counter()
        for _ in range(n):
            paged_kv_write(pool, k, v, table, **kw)
        host_us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        log(f"[kv_write] {tag} B={b} C={c} Kh=8 Dh=128 Gs=1 bf16: bitwise "
            f"plain {same}; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}, {nbytes} B), host "
            f"{host_us:.1f} us a call {'ok' if ok else 'MISS'}")
        if not ok:
            fails.append(f"kv_write {tag}")
        out[tag] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                        host_us=host_us)
    d = out["decode"]
    # the kernels line's launches are phase 3b's (launches_continuous)
    summary["paged_kv_write"] = dict(
        max_abs_err=0.0, ms=d["ms"],
        plain_ms=d["plain_ms"], library_ms=None, bound_ms=d["bound_ms"],
        bound_by=d["bound_by"], host_us=d["host_us"],
        ms_chunk=out["chunk"]["ms"], plain_ms_chunk=out["chunk"]["plain_ms"],
        bound_ms_chunk=out["chunk"]["bound_ms"],
        host_us_chunk=out["chunk"]["host_us"])


# ---------------------------------------------------------------------------
# phase 2c: engine-plane kernels vs plain versions
# ---------------------------------------------------------------------------

NO_LIBRARY = ("no single PyTorch call computes it (packed low-bit words "
              "decoded and scaled; an exact integer posit8 dot)")


def _dequant_case(tag, t, fails, dtype=torch.float32) -> float:
    from repro_torch.kernels.codec import dequant, dequant_plain
    k, n = t.shape
    got = dequant(t.words, t.scales, t.spec, k, n, dtype)
    want = dequant_plain(t.words, t.scales, t.spec, k, n, dtype)
    torch.cuda.synchronize()
    same = got.shape == (k, n) and got.dtype == dtype \
        and torch.equal(got, want)
    err = (got.float() - want.float()).abs().max().item() \
        if got.shape == want.shape else float("inf")
    log(f"[dequant] {tag} out={str(dtype).split('.')[-1]} words="
        f"{tuple(t.words.shape)} scales={tuple(t.scales.shape)} bitwise: "
        f"{'ok' if same else 'MISS'} (max_abs_err {err:.3e})")
    if not same:
        fails.append(f"dequant {tag}")
    return err


def _dequant_times(t, dtype=torch.float32):
    """(kernel ms, plain ms, bound ms, bound_by) of one dequant."""
    from repro_torch.kernels.codec import dequant, dequant_plain
    k, n = t.shape
    ms = time_ms(lambda: dequant(t.words, t.scales, t.spec, k, n, dtype))
    plain = time_ms(lambda: dequant_plain(t.words, t.scales, t.spec, k, n,
                                          dtype))
    nbytes = t.words.numel() * 4 + t.scales.numel() * 4 \
        + k * n * torch.finfo(dtype).bits // 8
    return (ms, plain, *bound_ms(nbytes, float(k * n), PEAK_FLOPS["f32"]))


def _quire_case(tag, a, b, fails, exact=None) -> float:
    from repro_torch.kernels.ops import quire_combine
    from repro_torch.kernels.quire_dot import (QUIRE_FRAC_BITS, quire_dot,
                                               quire_dot_plain)
    from repro_torch.kernels.ref import quire_dot_ref
    hi, lo = quire_dot(a, b)
    phi, plo = quire_dot_plain(a, b)
    torch.cuda.synchronize()
    same = torch.equal(hi, phi) and torch.equal(lo, plo)
    # the limbs hold the float64 row sum exactly (exact below 2^40 terms)
    value = hi[:, 0].double() + lo[:, 0].double() * 2.0 ** -QUIRE_FRAC_BITS
    same_f64 = torch.equal(value, quire_dot_ref(a, b))
    canonical = bool((lo >= 0).all() and (lo < 2 ** QUIRE_FRAC_BITS).all())
    ok = same and same_f64 and canonical
    msg = (f"[quire] {tag}: limbs bitwise vs plain {same}, == float64 row "
           f"sum {same_f64}, 0 <= lo < 2^22 {canonical}")
    if exact is not None:
        got = float(quire_combine(hi, lo)[0])
        ok = ok and got == exact
        msg += f", combined {got!r} == quire_dot_exact {exact!r}: {got == exact}"
    log(msg + (" ok" if ok else " MISS"))
    if not ok:
        fails.append(f"quire {tag}")
    return float(max((hi - phi).abs().max().item(),
                     (lo - plo).abs().max().item()))


def phase_engine_kernels(summary, fails) -> None:
    from repro_torch.core import formats as fmt
    from repro_torch.core.quire import quire_dot_exact
    from repro_torch.kernels.ops import pack_tensor
    from repro_torch.kernels.quire_dot import quire_dot, quire_dot_plain
    gen = torch.Generator("cuda").manual_seed(6)
    max_err = 0.0
    for spec in (fmt.FP4, fmt.POSIT4, fmt.POSIT8, fmt.POSIT16, fmt.FP8_E4M3,
                 fmt.FP8_E5M2, fmt.FXP4, fmt.FXP8):
        for group in (None, 32, 64):
            w = torch.randn((1024, 1024), generator=gen, device="cuda")
            t = pack_tensor(spec, w, group_size=group)
            for dtype in (torch.float32, torch.bfloat16):
                max_err = max(max_err, _dequant_case(
                    f"{spec.name:9s} g={str(group):4s} K=N=1024 2-D", t,
                    fails, dtype))
    # qwen2-0.5b's FFN gate slice under paper_mixed: FP4, per channel,
    # stacked layout (K padded to nothing, N to the word)
    w = torch.randn((2, 896, 4864), generator=gen, device="cuda") * 0.05
    ffn = pack_tensor(fmt.FP4, w, group_size=None)[1]
    max_err = max(max_err, _dequant_case("fp4 FFN slice 896x4864 stacked",
                                         ffn, fails))
    # jamba-v0.1's expert slices (phase 3e's path): FP4 per channel,
    # stacked, gate/up 4096 x 14336 and down 14336 x 4096, written in bf16
    experts = {}
    for k, n in ((4096, 14336), (14336, 4096)):
        w = torch.randn((2, k, n), generator=gen, device="cuda") * 0.02
        experts[k, n] = pack_tensor(fmt.FP4, w, group_size=None)[1]
        del w
        for dtype in (torch.bfloat16, torch.float32):
            max_err = max(max_err, _dequant_case(
                f"fp4 jamba expert slice {k}x{n} stacked", experts[k, n],
                fails, dtype))
    p8 = pack_tensor(fmt.POSIT8, torch.randn((1024, 1024), generator=gen,
                                             device="cuda"))
    # two rounds in turns show the spread; the second is the one recorded
    for rnd in (1, 2):
        for tag, t in (("posit8 K=N=1024 per-channel", p8),
                       ("fp4 FFN slice 896x4864", ffn)):
            ms, plain, b_ms, b_by = _dequant_times(t)
            log(f"[dequant] time round {rnd} {tag}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, bound {b_ms:.5f} ms ({b_by}); library: "
                f"none, {NO_LIBRARY}")
            if rnd == 2 and t is p8:       # the bench's shape
                summary["dequant"] = dict(
                    max_abs_err=max_err, ms=ms, plain_ms=plain,
                    library_ms=None, bound_ms=b_ms, bound_by=b_by)
            elif rnd == 2:
                summary["dequant"].update(ms_ffn=ms, plain_ms_ffn=plain,
                                          bound_ms_ffn=b_ms)
    # an expert slice as phase 3e decodes it (bf16) beside the f32 write
    t = experts[4096, 14336]
    for dtype in (torch.float32, torch.bfloat16):
        ms, plain, b_ms, b_by = _dequant_times(t, dtype)
        name = str(dtype).split(".")[-1]
        log(f"[dequant] time jamba expert slice 4096x14336 out={name}: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by})")
        summary["dequant"].update({f"ms_expert_{name}": ms,
                                   f"plain_ms_expert_{name}": plain,
                                   f"bound_ms_expert_{name}": b_ms})
    del experts, t

    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (64, 1024))
    b = rng.integers(0, 256, (64, 1024))
    a[:, 0] = 128                               # NaR in every row
    codes = [torch.tensor(x, dtype=torch.int32, device="cuda") for x in (a, b)]
    q_err = _quire_case(f"random 64x1024 ({int((a == 128).sum())} + "
                        f"{int((b == 128).sum())} NaR codes)", *codes, fails)
    big, one, neg = (int(c) for c in fmt.encode_table(
        fmt.POSIT8, torch.tensor([64.0, 1.0 / 64, -64.0])))
    row = np.array([[big] + [one] * 512 + [neg]])
    exact = quire_dot_exact(fmt.POSIT8, row[0], row[0])
    rt = torch.tensor(row, dtype=torch.int32, device="cuda")
    q_err = max(q_err, _quire_case("cancellation 64^2 + 512/64^4 + 64^2", rt,
                                   rt, fails, exact))
    a4 = torch.randint(0, 256, (4096, 4096), generator=gen, device="cuda",
                       dtype=torch.int32)
    b4 = torch.randint(0, 256, (4096, 4096), generator=gen, device="cuda",
                       dtype=torch.int32)
    q_err = max(q_err, _quire_case("random 4096x4096", a4, b4, fails))
    for x, y in ((codes[0], codes[1]), (a4, b4)):
        bsz, k = x.shape
        ms = time_ms(lambda: quire_dot(x, y))
        plain = time_ms(lambda: quire_dot_plain(x, y))
        b_ms, b_by = bound_ms(2 * bsz * k * 4 + 2 * bsz * 4, 2.0 * bsz * k,
                              PEAK_FLOPS["f32"])
        log(f"[quire] time B={bsz} K={k}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b_ms:.5f} ms ({b_by}); library: none, "
            f"{NO_LIBRARY}")
        if bsz == 64:
            small = dict(ms_64x1024=ms, plain_ms_64x1024=plain,
                         bound_ms_64x1024=b_ms)
    summary["quire_dot"] = dict(   # the last: 4096 x 4096
        max_abs_err=q_err, ms=ms, plain_ms=plain, library_ms=None,
        bound_ms=b_ms, bound_by=b_by, **small)


# ---------------------------------------------------------------------------
# phase 6: the accuracy plane (the perception models, QAT, the policy)
# ---------------------------------------------------------------------------

ACC_REL = 1e-4    # card vs CPU losses: float32 sums in another order


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_accuracy(fails) -> None:
    """The bench_accuracy and bench_model_size twins on the card at the
    reference's sizes and steps (their rows logged), then the card against
    the CPU: five AdamW steps of each perception model from one init
    (losses within ACC_REL), and one parameter set on both devices:
    ``quantize_tree`` bitwise equal under every policy of the sweep, the
    metrics of the quantized models within 1e-5."""
    from repro_torch.benchmarks import bench_accuracy as B
    from repro_torch.benchmarks import bench_model_size
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.core.qat import quantize_tree
    from repro_torch.data.vio_data import VIOStream
    from repro_torch.models import perception as P
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            bench_model_size.run("cuda")
            B.run("cuda")
    finally:
        for line in buf.getvalue().splitlines():
            log(f"[accuracy] {line}")
    torch.cuda.synchronize()
    rows = [ln.split(",", 2) for ln in buf.getvalue().splitlines()]
    want_rows = 6 + 2 * (len(B.SWEEP) + 2) + 8 + len(B.SWEEP)
    bad = [r for r in rows if len(r) != 3 or not all(
        np.isfinite(float(kv.split("=")[1])) for kv in r[2].split(";"))]
    log(f"[accuracy] {len(rows)} rows in {time.perf_counter() - t0:.1f} s "
        f"(expected {want_rows})")
    if len(rows) != want_rows or bad:
        fails.append(f"accuracy: {len(rows)} rows (expected {want_rows}), "
                     f"not finite: {bad}")

    rng = np.random.default_rng(0)
    templates = rng.normal(size=(10, 16, 16, 3)).astype(np.float32)
    wtrue = rng.normal(size=(128, 2)).astype(np.float32) * 0.3
    models = {
        "classify": (P.classifier_loss,
                     lambda g: P.classifier_init(g, width=8),
                     lambda i, d: B.classify_batch(templates, i, device=d)),
        "vio": (P.vio_loss, P.vio_init,
                lambda i, d: {k: torch.as_tensor(v, device=d) for k, v in
                              VIOStream(batch=64, step=i).next_batch()
                              .items()}),
        "gaze": (B.gaze_loss, P.gaze_init,
                 lambda i, d: B.gaze_batch(wtrue, i, device=d)),
    }
    policies = [PrecisionPolicy.uniform(n) for n in B.SWEEP] \
        + [PrecisionPolicy.paper_mixed()]
    for name, (loss_fn, init, batches) in models.items():
        params = init(torch.Generator("cpu").manual_seed(5))
        losses = {}
        for dev in ("cpu", "cuda"):
            _, _, ls = B.train(loss_fn, _to(params, dev),
                               lambda i: batches(i, dev), lr=1e-3, steps=5)
            losses[dev] = torch.stack(ls).cpu()
        rel = ((losses["cuda"] - losses["cpu"]).abs()
               / losses["cpu"].abs()).max().item()
        log(f"[accuracy] {name}: 5 steps, losses cuda {losses['cuda'].tolist()}"
            f" cpu {losses['cpu'].tolist()}, max rel diff {rel:.2e} "
            f"(tol {ACC_REL})")
        if not rel <= ACC_REL:
            fails.append(f"accuracy: {name} card vs CPU losses differ by "
                         f"{rel:.2e}")
        same, err = True, 0.0
        eval_b = {d: batches(7, d) for d in ("cpu", "cuda")}
        with torch.no_grad():
            for pol in policies:
                q = {d: quantize_tree(_to(params, d), pol)
                     for d in ("cpu", "cuda")}
                for a, b in zip(_flat(q["cpu"]), _flat(q["cuda"])):
                    same &= torch.equal(a, b.cpu())
                m = {d: loss_fn(q[d], eval_b[d]) for d in ("cpu", "cuda")}
                for key in m["cpu"][1]:
                    want = float(m["cpu"][1][key])
                    got = float(m["cuda"][1][key])
                    err = max(err, abs(got - want) / max(abs(want), 1e-30))
        log(f"[accuracy] {name}: quantize_tree card == CPU bitwise over "
            f"{len(policies)} policies: {same}; metrics max rel diff "
            f"{err:.2e} (tol 1e-5)")
        if not same:
            fails.append(f"accuracy: {name} quantize_tree differs card vs CPU")
        if not err <= 1e-5:
            fails.append(f"accuracy: {name} metrics differ card vs CPU by "
                         f"{err:.2e}")


def _flat(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k])
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 5: the engine plane at its own full size (the bench twins)
# ---------------------------------------------------------------------------

def phase_engine_plane(summary, fails) -> None:
    from repro_torch.benchmarks import bench_coprocessor, bench_mac_engine
    from repro_torch.benchmarks.common import time_call
    params = inspect.signature(time_call).parameters
    calls = params["warmup"].default + params["iters"].default
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            bench_mac_engine.run("cuda")
            bench_coprocessor.run("cuda")
    finally:
        for line in buf.getvalue().splitlines():
            log(f"[bench] {line}")
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    rows = [ln.split(",", 2) for ln in buf.getvalue().splitlines()]
    packed = (len(bench_mac_engine.GROUPS) * len(bench_mac_engine.SPECS)
              + len(bench_coprocessor.ARRAYS) * len(bench_coprocessor.SPECS))
    # each packed row: time_call's calls, then one checked product whose
    # weight the decode kernel materializes; the quire row: time_call's
    want = {"rmmec_matmul": packed * (calls + 1), "dequant": packed,
            "quire_dot": calls, "flash_decode": 0, "paged_flash_decode": 0,
            "paged_flash_prefill": 0}
    log(f"[bench] {len(rows)} rows in {time.perf_counter() - t0:.1f} s; "
        f"launches {launches}, expected {want}")
    for name, n in want.items():
        if launches[name] != n:
            fails.append(f"engine plane: {name} launched {launches[name]} "
                         f"times, expected {n}")
    if len(rows) != packed + 2 or not all(
            len(r) == 3 and np.isfinite(float(r[1])) and float(r[1]) > 0
            for r in rows):
        fails.append(f"engine plane: {len(rows)} CSV rows, expected "
                     f"{packed + 2} with positive times")
    for name in ("dequant", "quire_dot"):
        summary[name]["launches"] = launches[name]
    summary["rmmec_matmul"]["launches_engine_plane"] = launches["rmmec_matmul"]


# ---------------------------------------------------------------------------
# phase 7: the quickstart at full width -- calibration gradient, adaptive
# policy, QAT steps, checkpoint and resume, pack, serve
# ---------------------------------------------------------------------------

TRAIN_REL = 1e-3   # resumed vs uninterrupted losses (atomics in the
                   # embedding backward); card vs CPU with posit8 moments
                   # and compression (a value at a rounding boundary)


def _to_dev(tree, device):
    if tree is None or not isinstance(tree, (dict, torch.Tensor)):
        return tree
    if isinstance(tree, dict):
        return {k: _to_dev(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_train(summary, fails) -> None:
    """Phase 7: the quickstart at qwen2-0.5b's full width on the card
    (``quickstart``, one step profiled), then three steps of the
    all-features train step on the reduced float32 config on the card and
    on the CPU from the same weights and batches."""
    from repro_torch.configs import get_config
    from repro_torch.examples.quickstart import quickstart
    cfg = get_config("qwen2-0.5b")
    # the reference quickstart's token stream (the reduced config's 512
    # ids, drawn as ids of the full vocab): over all 151936 ids a band of
    # 2374 next tokens is not learnable in 20 steps (on an H100 the loss
    # went 12.10 -> 12.22 over them), so the 0.5 bar would test the data,
    # not the port
    data_vocab = cfg.reduced().vocab
    torch.cuda.empty_cache()       # the earlier phases' cached blocks
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim}, vocab "
        f"{cfg.vocab}, remat {cfg.remat!r}; token stream over ids "
        f"0..{data_vocab - 1}")
    out = quickstart(fails, cfg, profile_at=4, data_vocab=data_vocab,
                     ckpt_dir=os.path.join(ROOT, "build", "chip_smoke_ckpt"),
                     profile=_profile, log=log)
    if "profile" in out:
        wall, dev = out["profile"]
        busy = sum(v[0] for v in dev.values())
        n = sum(v[1] for v in dev.values())
        log(f"[train] profiled step 4: wall {wall:.1f} ms, device busy "
            f"{busy:.1f} ms, busy share {busy / wall:.3f}, kernel launches "
            f"{n}")
        for k, (ms, calls) in sorted(dev.items(), key=lambda kv: -kv[1][0])[:10]:
            log(f"[train]   device {ms:8.3f} ms  {calls:6d} calls  {k[:90]}")
        out["busy_ms"], out["launches_per_step"] = busy, n
    for name in ("rmmec_matmul", "flash_decode"):
        summary[name]["launches_quickstart"] = out.get("launches", {}).get(name)
    summary["peak_bytes_train"] = out["peak_gib"] * 2 ** 30
    out.pop("profile", None)
    log("[train] summary " + json.dumps(
        {k: v for k, v in out.items()
         if k not in ("losses", "step_ms", "generated")}))

    _card_vs_cpu_steps(fails, dataclasses.replace(
        get_config("qwen2-0.5b").reduced(), dtype="float32"), "train")


def _card_vs_cpu_steps(fails, small, tag) -> None:
    """Three steps of the all-features train step (mixed QAT, microbatch
    2) on ``small`` on the card and on the CPU from the same weights and
    batches: f32 moments within ``ACC_REL``, posit8 moments and
    compression within ``TRAIN_REL``."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.train.loop import TrainState, build_train_step, init_state
    for kw, tol in ((dict(), ACC_REL),
                    (dict(opt_state_dtype="posit8",
                          grad_compression="posit8"), TRAIN_REL)):
        run = RunConfig(arch=small.name, steps=3, lr=3e-3, warmup_steps=1,
                        microbatch=2, qat=True, precision_policy="mixed",
                        checkpoint_every=0, **kw)
        base = init_state(small, run, torch.Generator("cpu").manual_seed(0))
        losses = {}
        for dev in ("cpu", "cuda"):
            st = TrainState(*(_to_dev(getattr(base, f.name), dev)
                              for f in dataclasses.fields(base)))
            step = build_train_step(small, run)
            data = TokenStream(vocab=small.vocab, seq_len=64, global_batch=8,
                               device=dev)
            ls = []
            for _ in range(3):
                st, m = step(st, data.next_batch())
                ls.append(float(m["loss"]))
            losses[dev] = np.array(ls)
        rel = float(np.max(np.abs(losses["cuda"] - losses["cpu"])
                           / np.abs(losses["cpu"])))
        log(f"[{tag}] card vs CPU, reduced float32 {small.name}, mixed QAT, "
            f"microbatch 2, moments {run.opt_state_dtype}, compression "
            f"{run.grad_compression}: losses cuda {losses['cuda'].tolist()} "
            f"cpu {losses['cpu'].tolist()}, max rel diff {rel:.3e} (tol {tol})")
        if not (np.isfinite(losses["cuda"]).all() and rel <= tol):
            fails.append(f"{tag}: card vs CPU losses of {small.name} differ "
                         f"by {rel:.3e} ({run.opt_state_dtype}, "
                         f"{run.grad_compression})")


RWKV_TRAIN_STEPS = 6
RWKV_PROFILE_AT = 3


def phase_train_rwkv(summary, fails) -> None:
    """Phase 7b: rwkv6-1.6b at full width and ``RWKV_DEPTH`` layers trains
    (phase 7's feature set:
    mixed QAT, posit8 compression and moments, remat "full", the scans
    checkpointed per 64-token chunk; batch 8 x 256, microbatch 2, 6 steps
    over the reduced vocab's ids), one step profiled; then three steps of
    reduced float32 rwkv6 and jamba on the card and on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.train.loop import build_train_step, init_state
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), n_layers=RWKV_DEPTH)
    data_vocab = cfg.reduced().vocab       # as phase 7, for its reason
    batch, seq = 8, 256
    gc.collect()
    torch.cuda.empty_cache()
    run = RunConfig(arch=cfg.name, steps=RWKV_TRAIN_STEPS, lr=3e-3,
                    warmup_steps=2, microbatch=2, qat=True,
                    precision_policy="mixed", grad_compression="posit8",
                    opt_state_dtype="posit8", checkpoint_every=0)
    log(f"[train-rwkv] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, remat {cfg.remat!r}, "
        f"ssm_chunk {cfg.ssm_chunk}; batch {batch} x {seq}, microbatch "
        f"{run.microbatch}, token stream over ids 0..{data_vocab - 1}")
    t0 = time.perf_counter()
    state = init_state(cfg, run, torch.Generator("cuda").manual_seed(0))
    step = build_train_step(cfg, run)
    data = TokenStream(vocab=data_vocab, seq_len=seq, global_batch=batch,
                       seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = _n_params(state.params)
    log(f"[train-rwkv] init {time.perf_counter() - t0:.1f} s, {n_params} "
        f"parameters, {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"held")
    out, losses, step_ms, peaks = {}, [], [], []
    for i in range(1, RWKV_TRAIN_STEPS + 1):
        b = data.next_batch()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        if i == RWKV_PROFILE_AT:
            box = {}
            wall, dev, _ = _profile(lambda: box.update(r=step(state, b)),
                                    cpu=False)
            state, m = box.pop("r")   # kept in the box, it outlives its step
            busy = sum(v[0] for v in dev.values())
            n = sum(v[1] for v in dev.values())
            out.update(profiled_wall_ms=wall, busy_ms=busy,
                       busy_share=busy / wall, launches_per_step=n)
            log(f"[train-rwkv] profiled step {i}: wall {wall:.1f} ms, device "
                f"busy {busy:.1f} ms, busy share {busy / wall:.3f}, kernel "
                f"launches {n}")
            for k, (ms, calls) in sorted(dev.items(),
                                         key=lambda kv: -kv[1][0])[:8]:
                log(f"[train-rwkv]   device {ms:8.3f} ms  {calls:7d} calls  "
                    f"{k[:90]}")
        else:
            state, m = step(state, b)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t1) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    timed = [t for i, t in enumerate(step_ms, 1)
             if i > 1 and i != RWKV_PROFILE_AT]
    out.update(ms_per_step=float(np.median(timed)), first_step_ms=step_ms[0],
               peak_gib=max(peaks), losses=losses)
    log(f"[train-rwkv] {RWKV_TRAIN_STEPS} steps: losses "
        f"{[round(x, 4) for x in losses]}; median {out['ms_per_step']:.1f} "
        f"ms/step (first {step_ms[0]:.1f} ms; each {[round(t) for t in step_ms]}"
        f"), peak memory {out['peak_gib']:.2f} GiB (each step "
        f"{[round(x, 2) for x in peaks]}); {card()}")
    log("[train-rwkv] summary " + json.dumps(out))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fails.append(f"train-rwkv: losses {losses} (finite and falling "
                     f"wanted)")
    del state, step, b
    gc.collect()
    torch.cuda.empty_cache()
    for arch in ("rwkv6-1.6b", "jamba-v0.1-52b"):
        _card_vs_cpu_steps(fails, dataclasses.replace(
            get_config(arch).reduced(), dtype="float32"), "train-rwkv")


def phase_mesh(fails) -> None:
    """Phase 7c: the multi-device plane at world size 1 on the card: an
    NCCL group of one rank (a ``FileStore`` in a temporary directory) and
    ``make_host_mesh(1, 1)``; two steps of the sharded all-features step
    of reduced float32 qwen2 and rwkv6 bitwise equal to the unsharded
    step; ``pipeline_apply`` at one stage equal to the stage; a checkpoint
    saved from the mesh restored bitwise unsharded and on the mesh."""
    import tempfile
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.policy import flatten_with_paths
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.parallel.sharding import param_sharding_tree, whole
    from repro_torch.train.loop import TrainState, build_train_step, init_state

    def diff(a, b):
        fa, fb = flatten_with_paths(a), flatten_with_paths(b)
        if [p for p, _ in fa] != [p for p, _ in fb]:
            return ["<paths>"]
        return [p for (p, x), (_, y) in zip(fa, fb)
                if not (whole(x).dtype == whole(y).dtype
                        and torch.equal(whole(x), whole(y)))]

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_host_mesh(1, 1)
            log(f"[mesh] NCCL group of 1, mesh {mesh}")
            for arch in ("qwen2-0.5b", "rwkv6-1.6b"):
                small = dataclasses.replace(get_config(arch).reduced(),
                                            dtype="float32")
                run = RunConfig(arch=arch, steps=2, lr=3e-3, warmup_steps=1,
                                microbatch=2, qat=True,
                                precision_policy="mixed",
                                grad_compression="posit8",
                                opt_state_dtype="posit8", checkpoint_every=0)
                st0 = init_state(small, run,
                                 torch.Generator("cuda").manual_seed(0))
                step_fn, shard_state = build_train_step(small, run, mesh=mesh)
                ref_step = build_train_step(small, run)
                st, ref = shard_state(st0), st0
                data = TokenStream(vocab=small.vocab, seq_len=64,
                                   global_batch=8, device="cuda")
                same = True
                for _ in range(2):
                    b = data.next_batch()
                    st, m = step_fn(st, b)
                    ref, rm = ref_step(ref, b)
                    same &= all(torch.equal(m[k], rm[k])
                                for k in ("loss", "ce", "aux", "grad_norm"))
                bad = [f"{n}/{p}" for n in ("params", "opt_state",
                                            "residuals")
                       for p in diff(getattr(st, n), getattr(ref, n))]
                log(f"[mesh] {arch} sharded step x2: metrics bitwise {same}, "
                    f"state leaves differing {bad}; loss "
                    f"{float(m['loss']):.6f}")
                if not same or bad:
                    fails.append(f"mesh: {arch} sharded step differs from the "
                                 f"unsharded one ({bad})")
            # checkpoint from the mesh (rwkv6's state), restored both ways
            ck = os.path.join(tmp, "ck")
            save_checkpoint(ck, 2, st)
            tmpl = init_state(small, run, torch.Generator("cuda").manual_seed(1))
            sh = TrainState(None, *(param_sharding_tree(mesh, t) for t in (
                tmpl.params, tmpl.opt_state, tmpl.residuals)))
            on_mesh, _, _ = restore_checkpoint(ck, tmpl, shardings=sh)
            plain, _, _ = restore_checkpoint(ck, tmpl)
            bad = diff(on_mesh, st) + diff(plain, st)
            log(f"[mesh] checkpoint restored on the mesh and unsharded: "
                f"leaves differing {bad}")
            if bad:
                fails.append(f"mesh: restored checkpoint differs ({bad})")
            # the pipeline at one stage
            smesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
            gen = torch.Generator("cuda").manual_seed(3)
            w = torch.randn(1, 64, 64, device="cuda", generator=gen) * 0.3
            x = torch.randn(8, 64, device="cuda", generator=gen)
            got = pipeline_apply(smesh, "stage",
                                 lambda p, v: torch.tanh(v @ p["w"]),
                                 {"w": w}, x, 4)
            ok = torch.equal(got, torch.tanh(x @ w[0]))
            log(f"[mesh] pipeline_apply at one stage == the stage: {ok}")
            if not ok:
                fails.append("mesh: one-stage pipeline differs")
        finally:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the other five architectures (gemma-2b, qwen2-vl-7b,
# musicgen-medium, deepseek-67b, command-r-plus-104b)
# ---------------------------------------------------------------------------

# (config, short tag, Kh, G, Dh, B, max_len, last position): each new head
# shape as phases 3g / 3h decode it -- their batch and cache, the position
# of their last decode step
NEW_HEADS = (("qwen2-vl-7b", "qwen2vl", 4, 7, 128, 2, 512, 415),
             ("musicgen-medium", "musicgen", 24, 1, 64, 2, 384, 287),
             ("deepseek-67b", "deepseek", 8, 8, 128, 4, 128, 71),
             ("command-r-plus-104b", "commandr", 8, 12, 128, 4, 128, 71))


def phase_new_heads(summary, fails) -> None:
    """Phase 2b, more shapes: the decode entry point (``flash_decode``)
    against its plain version and the naive oracle at the head shapes of
    qwen2-vl-7b (Kh 4, G 7, Dh 128), musicgen-medium (24, 1, 64),
    deepseek-67b (8, 8, 128) and command-r-plus-104b (8, 12, 128), per
    channel and group-32 scales, positions from the first slot to the
    last; each timed at its phase's last step beside SDPA and the bytes
    bound.  Then ``dequant`` of musicgen's posit16 1536 x 2048 read-out
    to bf16 (its decode embed), bitwise against the plain version."""
    from repro_torch.core import formats as fmt
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import (default_kv_block,
                                                  flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.ops import pack_tensor
    from repro_torch.kernels.ref import quantize_kv
    from repro_torch.models.attention import dequantize_kv
    gen = torch.Generator("cuda").manual_seed(10)
    s = summary["flash_decode"]
    for name, short, kh, g, dh, b, t, last in NEW_HEADS:
        kv = torch.randn((2, b, t, kh, dh), generator=gen, device="cuda")
        for group in (None, 32):
            kc, ks = quantize_kv(kv[0], group)
            vc, vs = quantize_kv(kv[1], group)
            q = torch.randn((b, kh, g, dh), generator=gen, device="cuda")
            for pos in (0, 127, last, t - 1):
                got = flash_decode(q, kc, ks, vc, vs, pos)
                want = flash_decode_plain(q, kc, ks, vc, vs, pos)
                naive = ref.flash_decode_ref(q, kc, ks, vc, vs, pos)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                err_n = (got - naive).abs().max().item()
                ok = err <= FLASH_ATOL and err_n <= FLASH_ATOL \
                    and torch.isfinite(got).all().item()
                s["max_abs_err"] = max(s["max_abs_err"], err)
                tag = (f"{name} Kh={kh} G={g} Dh={dh} B={b} T={t} "
                       f"blk={default_kv_block(t)} group={group} pos={pos}")
                log(f"[heads] {tag} max_abs_err={err:.3e} vs plain, "
                    f"{err_n:.3e} vs naive (tol {FLASH_ATOL}) "
                    f"{'ok' if ok else 'MISS'}")
                if not ok:
                    fails.append(f"flash {tag}")
            if group is not None:
                continue
            ms = time_ms(lambda: flash_decode(q, kc, ks, vc, vs, last))
            plain = time_ms(lambda: flash_decode_plain(q, kc, ks, vc, vs,
                                                       last))
            kd = dequantize_kv(kc[:, : last + 1], ks[:, : last + 1]) \
                .transpose(1, 2).contiguous()
            vd = dequantize_kv(vc[:, : last + 1], vs[:, : last + 1]) \
                .transpose(1, 2).contiguous()
            qd = q.reshape(b, kh * g, 1, dh).to(torch.bfloat16)
            lib = time_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(qd, kd, vd,
                                                        enable_gqa=True))
            live = last + 1
            nbytes = (2 * b * live * kh * (dh + 2 * ks.shape[-1])
                      + q.numel() * 4 + b * kh * g * dh * 4)
            b_ms, b_by = bound_ms(nbytes, 4.0 * b * kh * g * live * dh,
                                  PEAK_FLOPS["f32"])
            log(f"[heads] time {name} Kh={kh} G={g} Dh={dh} B={b} "
                f"pos={last}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"library (SDPA, bf16, dequantized) {lib:.4f} ms, bound "
                f"{b_ms:.5f} ms ({b_by})")
            s.update({f"ms_{short}": ms, f"plain_ms_{short}": plain,
                      f"library_ms_{short}": lib,
                      f"bound_ms_{short}": b_ms})
    w = torch.randn((1536, 2048), generator=gen, device="cuda") * 0.03
    t = pack_tensor(fmt.POSIT16, w)
    err = _dequant_case("posit16 musicgen read-out 1536x2048 2-D", t, fails,
                        torch.bfloat16)
    ms, plain, b_ms, b_by = _dequant_times(t, torch.bfloat16)
    log(f"[dequant] time musicgen decode embed posit16 1536x2048 out=bf16: "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by}); library: none, {NO_LIBRARY}")
    summary["dequant"]["max_abs_err"] = max(summary["dequant"]["max_abs_err"],
                                            err)
    summary["dequant"].update(ms_musicgen_embed=ms,
                              plain_ms_musicgen_embed=plain,
                              bound_ms_musicgen_embed=b_ms)


def _n_params(params) -> int:
    from repro_torch.kernels.ops import PackedTensor
    return sum(int(np.prod(t.words.shape[:-2])) * t.shape[0] * t.shape[1]
               if isinstance(t, PackedTensor) else t.numel()
               for t in _leaf_paths(params).values())


def _init_packed(tag, cfg, seed: int = 0):
    """``cfg``'s seeded weights drawn on the card and packed under
    ``paper_mixed`` one layer at a time; logs the size, time and peak."""
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import zoo
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = zoo.init_model(cfg, torch.Generator("cuda").manual_seed(seed),
                            policy=PrecisionPolicy.paper_mixed())
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff} {cfg.ffn_kind}, vocab {cfg.vocab} "
        f"({'tied' if cfg.tie_embeddings else 'untied'}), frontend "
        f"{cfg.frontend}, rope {cfg.rope_kind}: {_n_params(params) / 1e9:.3f}B "
        f"parameters, paper_mixed; init + pack {time.perf_counter() - t0:.1f}"
        f" s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, held "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (of it "
        f"{before:.2f} GiB held before the draw)")
    return params


def _check_launches(tag, launches, expect, fails) -> None:
    log(f"[{tag}] launches {launches}, expected {expect}")
    for name, n in expect.items():
        if launches[name] != n:
            fails.append(f"{tag}: {name} launched {launches[name]} times, "
                         f"expected {n}")


def _readout_time(tag, params, b, summary, fails, sweep=()) -> None:
    """The untied posit16 read-out at the decode batch ``b`` (RMMEC's
    streaming route): kernel, plain and library (bf16 ``torch.matmul`` on
    a dense copy) times beside the bytes bound; its rows bitwise those of
    an M=64 call (simt_kernel) and within ``RMMEC_RTOL`` of plain; and the
    kernel and library at each M of ``sweep`` beside its bound."""
    from repro_torch.kernels.codec import dequant_plain
    from repro_torch.kernels.rmmec_matmul import launch_plan, rmmec_matmul
    t = params["lm_head"]["w"]
    k, n = t.shape
    x64 = torch.randn((64, k), device="cuda").to(torch.bfloat16)
    x = x64[:b]

    def call(xx):
        return rmmec_matmul(xx, t.words, t.scales, t.mask, t.spec, n)

    got, want = call(x), _plain_slabs(x, t)
    same = torch.equal(got, call(x64)[:b])
    err = (got - want).abs().max().item()
    tol = RMMEC_RTOL * want.abs().max().item()
    del want
    if not (same and err <= tol):
        fails.append(f"{tag}: read-out at M={b}: rows == M=64 {same}, "
                     f"max_abs_err {err:.3e} (tol {tol:.3e})")
    plain = time_ms(lambda: _plain_slabs(x, t), iters=3, warmup=1)
    dense = torch.cat([dequant_plain(w, sc, t.spec, k, ns, torch.bfloat16)
                       for w, sc, ns in _col_slabs(t)], dim=1)
    rows = {}
    for m in sorted({b, *sweep}):
        xm = x64[:m].contiguous()
        ms = time_ms(lambda: call(xm), iters=10)
        lib = time_ms(lambda: torch.matmul(xm, dense), iters=10)
        nbytes = (xm.numel() * 2 + t.words.numel() * 4 + t.scales.numel() * 4
                  + t.mask.numel() * 4 + m * n * 4)
        rows[m] = (ms, lib) + bound_ms(nbytes, 2.0 * m * k * n,
                                       PEAK_FLOPS["f32"]) + (nbytes,)
    del dense
    ms, lib, b_ms, b_by, nbytes = rows[b]
    route = launch_plan(b, k, n, x.dtype, t.spec.bits)
    log(f"[{tag}] read-out {t.spec.name} K={k} N={n} M={b} route="
        f"{route.route} strip={route.strip} grid={route.grid[0]}: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, library (bf16 matmul, dense "
        f"copy) {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes / 1e9:.3f} GB), kernel/bound {ms / b_ms:.2f}; rows == M=64 "
        f"(simt) bitwise: {same}; max_abs_err {err:.3e} (tol {tol:.3e})")
    for m in sweep:
        mm, ml, mb, mby, _ = rows[m]
        log(f"[{tag}] read-out sweep M={m} route="
            f"{launch_plan(m, k, n, x.dtype, t.spec.bits).route}: kernel "
            f"{mm:.4f} ms, library {ml:.4f} ms, bound {mb:.4f} ms ({mby}), "
            f"kernel/bound {mm / mb:.2f}")
        summary["rmmec_stream"].update({f"ms_readout_{tag}_m{m}": mm,
                                        f"library_ms_readout_{tag}_m{m}": ml,
                                        f"bound_ms_readout_{tag}_m{m}": mb})
    entry = {f"ms_readout_{tag}": ms, f"plain_ms_readout_{tag}": plain,
             f"library_ms_readout_{tag}": lib,
             f"bound_ms_readout_{tag}": b_ms}
    summary["rmmec_matmul"].update(entry)
    summary["rmmec_matmul"]["max_abs_err"] = max(
        summary["rmmec_matmul"]["max_abs_err"], err)
    s = summary["rmmec_stream"]
    s.update(entry)
    s["max_abs_err"] = max(s.get("max_abs_err", 0.0), err)
    if tag == "commandr2":   # the line's own numbers: the largest read-out
        s.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                 bound_by=b_by)


def phase_gemma(summary, fails) -> None:
    """Phase 3f: gemma-2b at its full size (arXiv:2403.08295: 18 layers,
    d 2048, 8 heads / 1 KV head of 256, d_ff 16384 GeGLU, vocab 256000
    tied; nothing cut), ``paper_mixed``, posit8 KV.  Each packed
    projection against plain at M = 1, 8, 128; static ``ServeEngine`` as
    phase 3 (batch 8, prompt 128, 32 steps; RMMEC 126 a forward,
    ``flash_decode`` 18 a step) with one profiled step; the carry context
    (``ContinuousEngine``, K=4) on the static prompts equal to the static
    tokens; ``ContinuousEngine`` on phase 3b's 16-request mix (20 pages
    of 128, 256-token chunks, prefix cache) at K=1 and 4: tokens equal,
    a prefix hit, ``paged_flash_decode`` 18 an iteration and
    ``paged_flash_prefill`` 18 a chunk."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ContinuousEngine, ServeEngine
    cfg = get_config("gemma-2b")
    smi = card()
    params = _init_packed("gemma", cfg)
    _rmmec_path_cases("gemma", params, summary, fails, ms=(1, 8, 128))
    per = 7 * cfg.n_layers
    b, s0, steps = 8, 128, 32
    eng = ServeEngine(cfg, params, max_len=256, quantized_kv=True)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (b, s0))
    eng.generate(toks, 2)                        # warm-up
    _, pre_s, _ = _counted(lambda: eng.generate(toks, 0))
    torch.cuda.reset_peak_memory_stats()
    out, wall, launches = _counted(lambda: eng.generate(toks, steps))
    step_ms = (wall - pre_s) / steps * 1e3
    log(f"[gemma] {smi}, static B={b} prompt={s0} steps={steps}: prefill "
        f"{pre_s * 1e3:.1f} ms, decode {step_ms:.2f} ms/step, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _check_launches("gemma static", launches, {
        "rmmec_matmul": per * (1 + steps),
        "flash_decode": cfg.n_layers * steps, "paged_flash_decode": 0,
        "paged_flash_prefill": 0, "dequant": 0, "quire_dot": 0}, fails)
    for name in ("rmmec_matmul", "flash_decode"):
        summary[name]["launches_gemma_static"] = launches[name]
    if out.shape != (b, s0 + steps) or out.min() < 0 \
            or out.max() >= cfg.vocab:
        fails.append(f"gemma static: bad output {out.shape}")
    profile_decode(eng, toks, step_ms)
    stats = {"static": dict(prefill_ms=pre_s * 1e3, ms_per_step=step_ms)}

    kw = dict(max_len=1024, page_size=128, max_batch=8,
              prefill_chunk_tokens=256)
    carry = ContinuousEngine(cfg, params, n_pages=20, decode_steps=4,
                             prefill_context="carry", **kw)
    rids = [carry.submit(p, steps) for p in toks]
    got = carry.run()
    differ = [i for i, r in enumerate(rids)
              if not np.array_equal(got[r], out[i])]
    log(f"[gemma] carry context (K=4) on the static prompts: tokens equal "
        f"the static engine's for all {b}: {not differ}")
    if differ:
        fails.append(f"gemma: carry-context tokens differ from static for "
                     f"requests {differ}")
    del carry

    reqs = _continuous_traffic(cfg.vocab)
    outs = {}
    for k in (1, 4):
        outs[k], stats[f"K={k}"], launches = _continuous_run(
            "gemma", smi, cfg, params, dict(kw, prefix_cache=True), reqs, k,
            fails)
        if k == 1:
            for name in ("rmmec_matmul", "paged_flash_decode",
                         "paged_flash_prefill"):
                summary[name]["launches_gemma_continuous"] = launches[name]
        if stats[f"K={k}"]["prefix_hits"] < 1:
            fails.append(f"gemma continuous K={k}: no prefix hit")
    differ = [i for i in outs[1] if not np.array_equal(outs[1][i], outs[4][i])]
    log(f"[gemma] continuous K=1 and K=4 tokens equal for all {len(reqs)} "
        f"requests: {not differ}")
    if differ:
        fails.append(f"gemma continuous: K=1 and K=4 tokens differ for "
                     f"requests {differ}")
    summary["gemma"] = stats


def _frontend_batch(cfg, b: int, s: int, seed: int):
    """Phase 3g's batch: frame embeddings (audio) or ``n_patches`` patch
    embeddings spliced ahead of ``s - n_patches`` text tokens (vision),
    numpy ``seed``, x 0.02 as ``TokenStream`` makes them."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        emb = rng.standard_normal((b, s, cfg.d_model)) * 0.02
        return {"frame_embeds": torch.as_tensor(emb, dtype=torch.float32,
                                                device="cuda")}
    pe = rng.standard_normal((b, cfg.n_patches, cfg.d_model)) * 0.02
    toks = rng.integers(0, cfg.vocab, (b, s))
    return {"tokens": torch.as_tensor(toks, device="cuda"),
            "patch_embeds": torch.as_tensor(pe, dtype=torch.float32,
                                            device="cuda")}


def _frontend_serve(cfg, params, batch, steps: int, max_len: int):
    """The reference's frontend serving path: ``zoo.apply_model``
    (prefill, last position), ``zoo.quantize_cache`` into a posit8 cache
    of ``max_len`` slots, then ``steps`` greedy ``zoo.decode_model``
    steps.  Returns (prefill logits, [decode logits], tokens (B, steps))."""
    from repro_torch.models import zoo
    with torch.inference_mode():
        logits, cache = zoo.apply_model(params, batch, cfg, last_only=True)
        q = zoo.quantize_cache(cache)
        b, s = q["k_codes"].shape[1:3]
        full = zoo.init_cache(cfg, b, max_len, quantized_kv=True)
        for key, v in q.items():
            full[key][:, :, :s] = v
        del cache, q
        tok = logits[:, -1:].argmax(-1)
        toks, steps_logits = [], []
        for i in range(steps):
            toks.append(tok)
            lg, full = zoo.decode_model(params, tok, cfg, full, s + i)
            tok = lg[:, -1:].argmax(-1)
            steps_logits.append(lg)
    return logits, steps_logits, torch.cat(toks + [tok[:, :0]], dim=1)


def _frontend_phase(summary, fails, tag, cfg, params, batch, steps, max_len,
                    expect_fwd, expect_step, dequant_step) -> None:
    """One frontend config through ``_frontend_serve``: exact launch
    counts of the prefill and the decode steps, finite logits, ms per
    decode step from the launches' run, one profiled step, peak memory."""
    smi = card()
    _frontend_serve(cfg, params, batch, 2, max_len)            # warm-up
    torch.cuda.reset_peak_memory_stats()
    _, pre_s, _ = _counted(
        lambda: _frontend_serve(cfg, params, batch, 0, max_len))
    (pl, dl, toks), wall, launches = _counted(
        lambda: _frontend_serve(cfg, params, batch, steps, max_len))
    step_ms = (wall - pre_s) / steps * 1e3
    b = toks.shape[0]
    expect = {"rmmec_matmul": expect_fwd * (1 + steps),
              "flash_decode": expect_step * steps,
              "dequant": dequant_step * steps, "paged_flash_decode": 0,
              "paged_flash_prefill": 0, "quire_dot": 0}
    _check_launches(tag, launches, expect, fails)
    for name in ("rmmec_matmul", "flash_decode", "dequant"):
        if expect[name]:
            summary[name][f"launches_{tag}"] = launches[name]
    finite = bool(torch.isfinite(pl).all()) and all(
        bool(torch.isfinite(x).all()) for x in dl)
    shape_ok = tuple(pl.shape) == (b, 1, cfg.vocab) and all(
        tuple(x.shape) == (b, 1, cfg.vocab) for x in dl)
    prompt = next(iter(batch.values())).shape[1]
    log(f"[{tag}] {smi}, B={b}, prompt {prompt}, {steps} greedy steps: "
        f"prefill {pre_s * 1e3:.1f} ms, decode {step_ms:.2f} ms/step, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; logits finite "
        f"{finite}, shapes {shape_ok}; tokens {toks[0, :8].tolist()}")
    if not (finite and shape_ok):
        fails.append(f"{tag}: logits finite {finite}, shapes {shape_ok}")
    if not (0 <= int(toks.min()) and int(toks.max()) < cfg.vocab):
        fails.append(f"{tag}: tokens outside the vocabulary")
    w0, d0, _ = _profile(lambda: _frontend_serve(cfg, params, batch, 0,
                                                 max_len))
    w1, d1, _ = _profile(lambda: _frontend_serve(cfg, params, batch, 2,
                                                 max_len))
    if d1:
        busy = (sum(v[0] for v in d1.values())
                - sum(v[0] for v in d0.values())) / 2
        n = (sum(v[1] for v in d1.values())
             - sum(v[1] for v in d0.values())) / 2
        wall_p = (w1 - w0) / 2
        log(f"[{tag}] profiled decode step: wall {wall_p:.2f} ms, device "
            f"busy {busy:.2f} ms, busy share {busy / wall_p:.3f} profiled / "
            f"{busy / step_ms:.3f} unprofiled, kernel launches {n:.0f}")
    else:
        log(f"[{tag}] the profiler recorded no device time")
    summary[tag] = dict(prefill_ms=pre_s * 1e3, ms_per_step=step_ms,
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def phase_frontends(summary, fails) -> None:
    """Phase 3g: the audio and vision frontends at full width, nothing
    cut, through the reference's frontend serving path (the model entry
    points: the engines take token prompts only).  qwen2-vl-7b
    (arXiv:2409.12191: 28 layers, d 3584, 28/4 heads of 128, d_ff 18944,
    vocab 152064 untied, M-RoPE): B=2, 256 patch embeddings (numpy seed
    3) ahead of 128 text tokens; RMMEC 7 x 28 + 1 = 197 a forward (the
    posit16 read-out on the SIMT route), ``flash_decode`` 28 a step.
    musicgen-medium (arXiv:2306.05284: 48 layers, d 1536, 24/24 heads of
    64, d_ff 6144 GELU, vocab 2048): B=2, 256 frame embeddings; RMMEC 6 x
    48 + 1 = 289 a forward, ``flash_decode`` 48 and ``dequant`` 1 (the
    code embed through the posit16 ``lm_head``) a step.  32 greedy steps
    each; every packed projection and the read-out against plain at
    M=2; the read-out's time beside its bytes bound."""
    from repro_torch.configs import get_config
    for arch, tag, per_layer, max_len in (("qwen2-vl-7b", "qwen2vl", 7, 512),
                                          ("musicgen-medium", "musicgen", 6,
                                           384)):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        params = _init_packed(tag, cfg)
        if "embed" in params:       # cast once, as the serving engines do
            params["embed"] = {"table": params["embed"]["table"].to(
                torch.bfloat16)}
        _rmmec_path_cases(tag, params, summary, fails, ms=(2,))
        _readout_time(tag, params, 2, summary, fails,
                      sweep=(1, 2, 4, 8, 16) if tag == "qwen2vl" else ())
        batch = _frontend_batch(cfg, 2, 384 if cfg.frontend == "vision"
                                else 256, 3)
        _frontend_phase(summary, fails, tag, cfg, params, batch, 32, max_len,
                        per_layer * cfg.n_layers + 1, cfg.n_layers,
                        int(cfg.frontend == "audio"))
        del params, batch
        torch.cuda.empty_cache()
        log(f"[time] {arch} (3g) {time.perf_counter() - t0:.1f} s")


def phase_wide_dense(summary, fails) -> None:
    """Phase 3h: deepseek-67b (arXiv:2401.02954: d 8192, 64/8 heads of
    128, d_ff 22016, vocab 102400) and command-r-plus-104b
    (hf:CohereForAI/c4ai-command-r-v01: d 12288, 96/8 heads of 128, d_ff
    33792, vocab 256000) at full width, depth cut to 2 layers (from 95 /
    64: the whole stacks cannot be drawn and packed on one card within
    the run's time; the only cut).  Every packed projection against
    plain at M = 1, 8, 128 (command-r's widest: gate/up 12288 -> 33792,
    down 33792 -> 12288), the posit16 read-out (up to 12288 x 256000 on
    the SIMT route) at M=4 against plain and timed beside its bytes
    bound; static ``ServeEngine`` batch 4, prompt 64, 8 steps (RMMEC 7 x 2
    + 1 a forward, ``flash_decode`` 2 a step)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmmec_matmul import stream_route
    from repro_torch.serve.engine import ServeEngine
    smi = card()
    for arch, tag in (("deepseek-67b", "deepseek2"),
                      ("command-r-plus-104b", "commandr2")):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        params = _init_packed(tag, cfg)
        _rmmec_path_cases(tag, params, summary, fails, ms=(1, 8, 128))
        _readout_time(tag, params, 4, summary, fails)
        b, s0, steps = 4, 64, 8
        eng = ServeEngine(cfg, params, max_len=128, quantized_kv=True)
        del params
        toks = np.random.default_rng(0).integers(0, cfg.vocab, (b, s0))
        eng.generate(toks, 1)                        # warm-up
        _, pre_s, _ = _counted(lambda: eng.generate(toks, 0))
        torch.cuda.reset_peak_memory_stats()
        stream_route.launches = 0
        out, wall, launches = _counted(lambda: eng.generate(toks, steps))
        step_ms = (wall - pre_s) / steps * 1e3
        _check_launches(tag, launches, {
            "rmmec_matmul": (7 * cfg.n_layers + 1) * (1 + steps),
            "flash_decode": cfg.n_layers * steps, "paged_flash_decode": 0,
            "paged_flash_prefill": 0, "dequant": 0, "quire_dot": 0}, fails)
        # the read-out of the prefill (last position) and of each step, at
        # M = b on the streaming route
        log(f"[{tag}] streaming route launches {stream_route.launches}, "
            f"expected {1 + steps}")
        if stream_route.launches != 1 + steps:
            fails.append(f"{tag}: streaming route launched "
                         f"{stream_route.launches} times, expected "
                         f"{1 + steps}")
        summary["rmmec_stream"][f"launches_{tag}"] = stream_route.launches
        summary["rmmec_stream"]["launches"] = stream_route.launches
        for name in ("rmmec_matmul", "flash_decode"):
            summary[name][f"launches_{tag}"] = launches[name]
        if out.shape != (b, s0 + steps) or out.min() < 0 \
                or out.max() >= cfg.vocab:
            fails.append(f"{tag}: bad output {out.shape}")
        log(f"[{tag}] {smi}, static B={b} prompt={s0} steps={steps}: "
            f"prefill {pre_s * 1e3:.1f} ms, decode {step_ms:.2f} ms/step, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"tokens {out[0, s0:].tolist()}")
        summary[tag] = dict(prefill_ms=pre_s * 1e3, ms_per_step=step_ms)
        del eng
        torch.cuda.empty_cache()
        log(f"[time] {arch} depth 2 (3h) {time.perf_counter() - t0:.1f} s")


NEW_LOGIT_REL = 1e-5     # of max|logit|: float32, only sum order differs


def phase_new_parity(fails) -> None:
    """Phase 4d: the five new configs, ``.reduced()`` in float32 with one
    seeded ``paper_mixed`` tree, on the card and on the CPU: logits of the
    prefill and of 4 decode steps on the contiguous posit8 cache (the
    CPU's greedy tokens fed to both) within ``NEW_LOGIT_REL`` x max|logit|;
    gemma also through ``ContinuousEngine`` (pages context, prefix cache,
    K=2), tokens equal on both devices."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import zoo
    from repro_torch.serve.engine import ContinuousEngine
    policy = PrecisionPolicy.paper_mixed()
    for arch in ("gemma-2b", "deepseek-67b", "command-r-plus-104b",
                 "musicgen-medium", "qwen2-vl-7b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        params = zoo.pack_params(
            zoo.init_model(cfg, torch.Generator("cpu").manual_seed(5)),
            policy)
        rng = np.random.default_rng(5)
        b, s = 2, 24
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, s))}
        if cfg.frontend == "audio":
            batch = {"frame_embeds": (rng.standard_normal(
                (b, s, cfg.d_model)) * 0.02).astype(np.float32)}
        elif cfg.frontend == "vision":
            batch["patch_embeds"] = (rng.standard_normal(
                (b, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
        res, toks = {}, []
        for dev in ("cpu", "cuda"):             # the CPU's tokens feed both
            p = _to(params, dev)
            bt = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            with torch.inference_mode():
                lg, cache = zoo.apply_model(p, bt, cfg)
                q = zoo.quantize_cache(cache)
                full = zoo.init_cache(cfg, b, 32, quantized_kv=True,
                                      device=dev)
                for key, v in q.items():
                    full[key][:, :, :s] = v
                logits = [lg.cpu()]
                for i in range(4):
                    if dev == "cpu":
                        toks.append(logits[-1][:, -1:].argmax(-1))
                    lg, full = zoo.decode_model(p, toks[i].to(dev), cfg,
                                                full, s + i)
                    logits.append(lg.cpu())
            res[dev] = logits
        worst = 0.0
        for got, want in zip(res["cuda"], res["cpu"]):
            rel = (got - want).abs().max().item() / max(
                want.abs().max().item(), 1e-30)
            worst = max(worst, rel)
        ok = worst <= NEW_LOGIT_REL
        log(f"[newparity] {cfg.name} (float32, paper_mixed): prefill and 4 "
            f"decode steps, card vs CPU max |diff| / max|logit| {worst:.3e} "
            f"(tol {NEW_LOGIT_REL}) {'ok' if ok else 'MISS'}")
        if not ok:
            fails.append(f"new parity {cfg.name}: logits differ by "
                         f"{worst:.3e} of max|logit|")
        if arch != "gemma-2b":
            continue
        reqs = [(rng.integers(0, cfg.vocab, n), new)
                for n, new in ((10, 9), (40, 12), (70, 6), (33, 8))]
        pre = rng.integers(0, cfg.vocab, 32)
        reqs = [(np.concatenate([pre, p]) if i % 2 else p, n)
                for i, (p, n) in enumerate(reqs)]
        outs = {}
        for dev in ("cpu", "cuda"):
            eng = ContinuousEngine(cfg, _to(params, dev), n_pages=10,
                                   page_size=16, max_batch=3, max_len=128,
                                   prefill_chunk_tokens=32, prefix_cache=True,
                                   decode_steps=2, device=dev)
            rids = [eng.submit(p, n) for p, n in reqs]
            done = eng.run()
            outs[dev] = [done[r] for r in rids]
            hits = eng.scheduler.prefix.hits
        same = all(np.array_equal(a, c) for a, c in zip(outs["cuda"],
                                                         outs["cpu"]))
        log(f"[newparity] {cfg.name} ContinuousEngine (pages, prefix cache, "
            f"K=2, {hits} prefix hits): tokens equal on card and CPU: {same}")
        if not same or hits < 1:
            fails.append(f"new parity {cfg.name}: continuous tokens equal "
                         f"{same}, {hits} prefix hits")


# ---------------------------------------------------------------------------
# phase 8: the last modules -- roofline/, the dry run, the serving bench
# twins and the examples
# ---------------------------------------------------------------------------

PEAK_RATIO = (0.67, 1.5)   # dry-run estimate / measured peak
# examples/train_lm.py at the reference's model, batch and sequence, over
# phase 7's 512 ids: over the whole vocab the loss did not fall in the
# reference's 200 steps on an H100 (12.021 -> 12.043), so the check would
# test the data, not the port; 100 steps cross two checkpoints
TRAIN_LM_STEPS = 100
TRAIN_LM_DATA_VOCAB = 512


def _captured(tag, fn):
    """(return value, stdout lines) of ``fn()``; the lines are logged."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rv = fn()
        except SystemExit as e:
            rv = e.code
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"[{tag}] {line}")
    return rv, lines


DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun_torch")
# the dry-run cells of phase 8c: phase 3's static cell and phase 7's step
DRYRUN_CELLS = {
    "phase3": ("decode_32k", ["--global-batch", "8", "--seq-len", "256",
                              "--prompt-len", "128", "--quantized-kv"]),
    "phase7": ("train_4k", ["--global-batch", "16", "--seq-len", "256",
                            "--microbatch", "2", "--grad-compression",
                            "posit8", "--opt-dtype", "posit8"]),
}


def dryrun_start():
    """Start the dry run of phase 8c's two cells (qwen2-0.5b, mesh 1x1,
    ``paper_mixed``) in two subprocesses on the host CPU: fake tensors,
    no card and nothing allocated, so they run beside the card's
    phases; returns {tag: process}."""
    import atexit
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = {tag: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", shape, "--mesh", "1x1", "--policy",
         "mixed", "--out", DRYRUN_DIR, "--tag", tag] + flags, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tag, (shape, flags) in DRYRUN_CELLS.items()}
    # a run that stops early stops them too
    atexit.register(lambda: [p.kill() for p in procs.values()
                             if p.poll() is None])
    return procs


def dryrun_collect(procs, fails):
    """Wait for :func:`dryrun_start`'s processes; returns {tag: record}."""
    recs = {}
    for tag, proc in procs.items():
        try:
            text, _ = proc.communicate(timeout=400)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        for line in text.splitlines()[-8:]:
            log(f"[dryrun] {tag}: {line}")
        path = os.path.join(DRYRUN_DIR, f"qwen2-0.5b__{DRYRUN_CELLS[tag][0]}"
                            f"__1x1__{tag}.json")
        if proc.returncode != 0 or not os.path.exists(path):
            fails.append(f"dryrun {tag}: exit {proc.returncode}")
            continue
        with open(path) as f:
            recs[tag] = json.load(f)
    return recs


def phase_new_modules(summary, fails, dryrun) -> None:
    """Phase 8: ``roofline.hw.detect()``; the decode / serve / e2e bench
    twins at qwen2-0.5b's full width through ``benchmarks.run`` (their
    assertions live, both latency claims printed with ``met``); the dry
    run of phase 3's and phase 7's cells against their measured peaks;
    ``vio_serve --continuous`` and ``train_lm``."""
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.examples import train_lm, vio_serve
    from repro_torch.roofline.hw import detect
    t0 = time.perf_counter()
    hw = detect()
    log(f"[roofline] detect(): {hw}")
    counters = _launch_counters()
    out_dir = os.path.join(ROOT, "build", "bench_torch")
    for name in ("decode", "serve", "e2e"):
        t1 = time.perf_counter()
        for c in counters.values():
            c.launches = 0
        rv, _ = _captured(f"twin {name}", lambda: bench_run.main(
            ["--only", name, "--full", "--out", out_dir]))
        launches = {n: c.launches for n, c in counters.items()
                    if c.launches}
        log(f"[twin {name}] {time.perf_counter() - t1:.1f} s; launches "
            f"{launches}")
        if rv:
            fails.append(f"twin {name}: exit {rv}")
        for n, k in launches.items():
            summary.setdefault(n, {})[f"launches_twin_{name}"] = k
    with open(os.path.join(out_dir, "BENCH_serve.json")) as f:
        serve = json.load(f)
    for key in ("chunked_prefill", "disagg"):
        c = serve[key]
        nums = {k: round(v, 3) for k, v in c.items() if k.startswith("p99")}
        log(f"[twin serve] claim {c['claim']!r}: {nums}, met={c['met']}")
    log(f"[time] twins (8b) {time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    recs = dryrun_collect(dryrun, fails)
    for tag, key in (("phase3", "peak_bytes_serve"),
                     ("phase7", "peak_bytes_train")):
        if tag not in recs or key not in summary:
            fails.append(f"dryrun {tag}: no estimate or no measured peak")
            continue
        est = recs[tag]["memory"]["peak_nonaliased_bytes"]
        got = summary[key]
        ratio = est / got
        ok = PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]
        log(f"[dryrun] {tag}: estimated peak {est / 2**30:.3f} GiB, measured "
            f"{got / 2**30:.3f} GiB, ratio {ratio:.3f} (within {PEAK_RATIO}: "
            f"{ok}); run {recs[tag]['run_s']:.1f} s, flops "
            f"{recs[tag]['cost']['flops']:.4e}, bytes "
            f"{recs[tag]['cost']['bytes accessed']:.4e}, kernels "
            f"{ {k: v['calls'] for k, v in recs[tag]['kernels'].items()} }")
        if not ok:
            fails.append(f"dryrun {tag}: peak ratio {ratio:.3f}")
    log(f"[time] dry run (8c; started after the build) "
        f"{time.perf_counter() - t1:.1f} s waited")

    t1 = time.perf_counter()
    rv, _ = _captured("vio_serve", lambda: vio_serve.main(["--continuous"]))
    if rv:
        fails.append(f"vio_serve --continuous: exit {rv}")
    log(f"[time] vio_serve --continuous {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    ckpt = os.path.join(ROOT, "build", "chip_smoke_train_lm")
    shutil.rmtree(ckpt, ignore_errors=True)
    rv, _ = _captured("train_lm", lambda: train_lm.main(
        ["--steps", str(TRAIN_LM_STEPS), "--data-vocab",
         str(TRAIN_LM_DATA_VOCAB), "--ckpt", ckpt]))
    if rv:
        fails.append(f"train_lm: exit {rv}")
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"[time] train_lm {TRAIN_LM_STEPS} steps "
        f"{time.perf_counter() - t1:.1f} s; phase 8 "
        f"{time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "card", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              f"root of the repository", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    summary, fails = {}, []
    phase_build()
    dryrun = dryrun_start()
    t0 = time.perf_counter()
    phase_rmmec(summary, fails)
    phase_flash(summary, fails)
    phase_paged(summary, fails)
    phase_kv_write(summary, fails)
    phase_engine_kernels(summary, fails)
    log(f"[time] kernel checks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_new_heads(summary, fails)
    log(f"[time] new head shapes and the audio embed (2b) "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_serve(summary, fails)
    log(f"[time] full-width serve {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_parity(summary, fails)
    log(f"[time] parity {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_continuous(summary, fails)
    log(f"[time] full-width continuous serve {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_continuous_parity(fails)
    log(f"[time] continuous parity {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_rwkv(summary, fails)
    log(f"[time] rwkv6-1.6b depth {RWKV_DEPTH} serving (3d) "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_jamba(summary, fails)
    log(f"[time] jamba-v0.1 depth-8 serving (3e) "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_stateful_parity(fails)
    log(f"[time] recurrent/hybrid/MoE parity (4c) "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_gemma(summary, fails)
    log(f"[time] gemma-2b full size (3f) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_frontends(summary, fails)
    log(f"[time] frontends at full width (3g) "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_wide_dense(summary, fails)
    log(f"[time] deepseek / command-r full width, depth 2 (3h) "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_new_parity(fails)
    log(f"[time] new configs, card vs CPU (4d) "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_engine_plane(summary, fails)
    log(f"[time] engine plane {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_accuracy(fails)
    log(f"[time] accuracy plane {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train(summary, fails)
    log(f"[time] quickstart at full width (7) {time.perf_counter() - t0:.1f} "
        f"s")
    t0 = time.perf_counter()
    phase_train_rwkv(summary, fails)
    log(f"[time] rwkv6-1.6b depth {RWKV_DEPTH} training (7b) "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_mesh(fails)
    log(f"[time] mesh at world size 1 (7c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_new_modules(summary, fails, dryrun)
    log(f"[time] roofline, twins, dry run, examples (8) "
        f"{time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    if fails:
        for f in fails:
            print(f"FAIL {f}", file=sys.stderr)
        return 1
    print(card())
    kernels = []
    for name, src, tpu in (
            ("rmmec_matmul", RMMEC_SRC, RMMEC_TPU),
            ("rmmec_stream", RMMEC_SRC, RMMEC_TPU),
            ("flash_decode", FLASH_SRC, FLASH_TPU),
            ("paged_flash_decode", FLASH_SRC, PAGED_DECODE_TPU),
            ("paged_flash_prefill", FLASH_SRC, PAGED_PREFILL_TPU),
            ("dequant", DEQUANT_SRC, DEQUANT_TPU),
            ("quire_dot", QUIRE_SRC, QUIRE_TPU),
            ("attention_wide", FLASH_SRC, PAGED_DECODE_TPU),
            ("paged_kv_write", KV_WRITE_SRC, None)):
        s = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu,
                        "launches": s.get("launches",
                                          s.get("launches_continuous")),
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"]})
        # the launches of the recurrent and hybrid paths (phases 3d/3e)
        kernels[-1].update({key: v for key, v in s.items()
                            if key.startswith("launches_")})
        if name == "rmmec_matmul":   # the prefill shapes beside decode's
            kernels[-1].update({key: s[key] for key in (
                "ms_m256", "ms_m1024", "library_ms_m1024", "bound_ms_m1024")})
            # the wgmma route at each layer's shapes, and its launches
            kernels[-1].update({key: v for key, v in s.items() if any(
                f"_{tag}_m" in key for tag, _, _ in WGMMA_LAYERS)})
            # the posit16 read-outs of phases 3g / 3h (SIMT route)
            kernels[-1].update({key: v for key, v in s.items()
                                if "_readout_" in key})
        elif name == "flash_decode":   # the new head shapes (phase 2b)
            kernels[-1].update({key: v for key, v in s.items() if key.startswith(
                ("ms_", "plain_ms_", "library_ms_", "bound_ms_"))})
        elif name in ("dequant", "quire_dot"):   # the second timed shape
            kernels[-1].update({key: v for key, v in s.items()
                                if key.startswith(("ms_", "bound_ms_"))})
        elif name == "paged_kv_write":   # the chunk beside decode, host us
            kernels[-1].update({key: v for key, v in s.items()
                                if key not in kernels[-1]})
        elif name == "rmmec_stream":   # the streaming route: every read-out
            kernels[-1].update({key: v for key, v in s.items()
                                if key not in kernels[-1]})
        elif name == "attention_wide":   # prefill and Dh 320 beside decode
            kernels[-1].update({key: v for key, v in s.items()
                                if key not in kernels[-1]
                                and key != "max_abs_err"})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
