#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any miss:

  1. build: compile every CUDA source of ``src/repro_torch/csrc`` with
     nvcc (one process per source, all at once);
  2. kernels vs their plain PyTorch versions on the card, at the shapes
     of the main path: ``rmmec_matmul`` (FP4, posit8, posit16; per-channel
     and K-group 32 scales; M in {8, 1024}; both packed layouts; a weight
     with an all-zero mask block) and ``flash_decode`` (qwen2-0.5b's
     B=8, Kh=2, G=7, Dh=64 over T=256 slots, with pad and softcap);
  3. the main path at full width: ``ServeEngine`` serving qwen2-0.5b
     (24 layers, d=896, vocab 151936) with the paper's mixed posit8/FP4
     policy and a posit8 KV cache, random weights from a seed, batch 8,
     prompt 128, 32 greedy steps; the launch counters must show every
     projection and every decode attention went through the kernels;
  4. the reduced config (float32) served on the card and on the CPU
     (plain versions) from the same weights: logits and tokens must agree.

The last lines are the card's name and power limit, one JSON line with
each kernel's launches, error and times, and ``{"ok": true, ...}``.
Without a CUDA card, or outside the repository, it exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import os
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


def log(msg: str) -> None:
    print(msg, flush=True)


def _flush_l2(buf: torch.Tensor) -> None:
    buf.add_(1)   # touch 128 MB: evicts the 50 MB L2


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms with a cold L2 before each call
    (CUDA events around each call)."""
    buf = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        _flush_l2(buf)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


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


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

RMMEC_RTOL = 1e-4   # |err| / max|plain|: f32 sums in another order, K <= 4864
FLASH_ATOL = 1e-4   # outputs are O(1) averages of V; exp/tanh and sum order


def _rmmec_case(spec, group, m, k, n, stacked, zero_block, gen, fails):
    from repro_torch.kernels.ops import pack_tensor, to_dense
    from repro_torch.kernels.rmmec_matmul import rmmec_matmul, rmmec_matmul_plain
    w = torch.randn((2, k, n) if stacked else (k, n), generator=gen,
                    device="cuda") * 0.05
    if zero_block:
        # 2-D layout: the first K block of rows; stacked: the whole slice
        w[..., : (512 if not stacked else k), :] = 0.0
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
    tag = (f"{spec.name:9s} g={str(group):4s} M={m:5d} K={k:5d} N={n:5d} "
           f"{'stacked' if stacked else '2-D':7s} mask={tuple(t.mask.shape)}"
           f" gated={int((t.mask == 0).sum())}")
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

    # times at the main path's shapes: one layer's seven projections under
    # paper_mixed (posit8 attention, FP4 FFN, per-channel scales), stacked
    # layout, bf16 activations
    proj = [(fmt.POSIT8, 896, 896), (fmt.POSIT8, 896, 128),
            (fmt.POSIT8, 896, 128), (fmt.POSIT8, 896, 896),
            (fmt.FP4, 896, 4864), (fmt.FP4, 896, 4864), (fmt.FP4, 4864, 896)]
    for m, label in ((8, "decode"), (8 * 128, "prefill")):
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
        if label == "decode":
            summary["rmmec_matmul"] = dict(
                max_abs_err=max_err, ms=tot[0], plain_ms=tot[1],
                library_ms=tot[2], bound_ms=b_ms, bound_by=b_by)


def phase_flash(summary, fails) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    from repro_torch.models.attention import dequantize_kv, quantize_kv
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
    summary["flash_decode"]["max_abs_err"] = max_err


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def phase_serve(summary, fails) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.rmmec_matmul import rmmec_matmul
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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = eng.generate(toks, steps)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"rmmec_matmul": rmmec_matmul.launches,
                "flash_decode": flash_decode.launches}
    decode_s = max(total_s - prefill_s, 1e-9)
    per_tok_ms = decode_s / steps * 1e3
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
    log("[serve] summary " + json.dumps(dict(
        prefill_ms=prefill_s * 1e3, decode_ms_per_step=per_tok_ms,
        tok_per_s=b * steps / decode_s)))
    profile_decode(eng, toks, per_tok_ms)


def _profile(fn):
    """(wall ms, {kernel name: (device ms, calls)}, {op: host ms}) of one
    call of ``fn`` under torch.profiler."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev, host = {}, {}
    for ev in prof.key_averages():
        d = getattr(ev, "self_device_time_total", None)
        if d is None:
            d = getattr(ev, "self_cuda_time_total", 0)
        if d and ev.device_type.name == "CUDA":
            dev[ev.key] = (d / 1e3, ev.count)
        elif ev.self_cpu_time_total:
            host[ev.key] = ev.self_cpu_time_total / 1e3
    return wall, dev, host


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
    for k, (ms, n) in sorted(dev.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[profile]   device {ms:8.3f} ms  {n:6.1f} calls  {k[:90]}")
    host = {k: (v - h0.get(k, 0.0)) / steps for k, v in h1.items()}
    for k, ms in sorted(host.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   host   {ms:8.3f} ms  {k[:90]}")


# ---------------------------------------------------------------------------
# phase 4: the whole path, card vs CPU
# ---------------------------------------------------------------------------

LOGIT_ATOL = 1e-3   # float32 config: only sum order differs (TF32 off)


def phase_parity(fails) -> None:
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
    t0 = time.perf_counter()
    phase_rmmec(summary, fails)
    phase_flash(summary, fails)
    log(f"[time] kernel checks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_serve(summary, fails)
    log(f"[time] full-width serve {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_parity(fails)
    log(f"[time] parity {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    if fails:
        for f in fails:
            print(f"FAIL {f}", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    kernels = []
    for name, src, tpu in (("rmmec_matmul", RMMEC_SRC, RMMEC_TPU),
                           ("flash_decode", FLASH_SRC, FLASH_TPU)):
        s = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu, "launches": s["launches"],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
