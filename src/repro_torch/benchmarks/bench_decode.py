"""Decode-plane benchmark: the posit8 KV cache against the bf16 cache (the
counterpart of ``benchmarks/bench_decode.py``, same traffic and rows).

On the same model and prompt it measures:

  * tokens/s of ``ServeEngine.generate`` with a bf16 KV cache against
    the posit8 cache (per-(token, head) and Dh-grouped scales);
  * per-call time of the ``flash_decode`` kernel against its plain
    version on one attention layer's cache (the reference times Pallas
    against its blocked XLA path), and of SDPA over the same cache
    dequantized to bf16 (the library's call, timed and used nowhere);
  * MODELED KV bytes/step (``roofline.analysis.decode_kv_bytes``): the
    posit8 cache must move >= 2x fewer bytes than bf16, and the
    length-aware bytes must not scale with ``max_len`` (asserted).

CSV rows to stdout; the JSON goes to ``build/bench_torch/BENCH_decode.json``.
The config is the reference's reduced qwen2, or qwen2-0.5b at full width
with ``full``.  On a CPU tensor the kernel wrapper runs its plain
version, so both kernel rows then time the plain path.

  python -m repro_torch.benchmarks.bench_decode [--smoke] [--full]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..core.policy import PrecisionPolicy
from ..kernels.flash_decode import (default_kv_block, flash_decode,
                                    flash_decode_plain)
from ..kernels.ref import quantize_kv
from ..models import attention as A
from ..models import zoo
from ..roofline.analysis import decode_kv_bytes
from ..serve.engine import ServeEngine
from .common import (bench_config, device_name, emit, time_call,
                     write_json)

DECODE_ATOL = 1e-4      # the reference's kernel vs blocked tolerance


def _engine_tokens_per_s(cfg, params, toks, steps, max_len, quantized_kv,
                         device, policy=None):
    eng = ServeEngine(cfg, params, max_len=max_len,
                      quantized_kv=quantized_kv, policy=policy,
                      device=device)
    eng.generate(toks, steps=2)                      # warm-up
    t0 = time.perf_counter()
    out = eng.generate(toks, steps=steps)
    dt = time.perf_counter() - t0
    assert np.isfinite(out).all()
    return toks.shape[0] * steps / dt


def _kernel_vs_plain(cfg, max_len, pos, device):
    """Per-call microseconds of the kernel, its plain version and SDPA on
    one layer's posit8 cache; the kernel is checked against the plain
    version."""
    rng = np.random.default_rng(0)
    b, kh, dh = 2, cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // cfg.n_kv_heads
    q = torch.as_tensor(rng.normal(size=(b, kh, g, dh)).astype(np.float32),
                        device=device)
    kv = torch.as_tensor(rng.normal(size=(2, b, max_len, kh, dh)).astype(
        np.float32), device=device)
    kc, ks = quantize_kv(kv[0])
    vc, vs = quantize_kv(kv[1])
    us_k = time_call(flash_decode, q, kc, ks, vc, vs, pos)
    us_p = time_call(flash_decode_plain, q, kc, ks, vc, vs, pos)
    err = (flash_decode(q, kc, ks, vc, vs, pos)
           - flash_decode_plain(q, kc, ks, vc, vs, pos)).abs().max().item()
    assert err <= DECODE_ATOL, f"flash_decode vs plain: {err:.3e}"
    kd = A.dequantize_kv(kc[:, : pos + 1], ks[:, : pos + 1]).to(
        torch.bfloat16).transpose(1, 2).contiguous()
    vd = A.dequantize_kv(vc[:, : pos + 1], vs[:, : pos + 1]).to(
        torch.bfloat16).transpose(1, 2).contiguous()
    qd = q.reshape(b, kh * g, 1, dh).to(torch.bfloat16)
    us_l = time_call(lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, enable_gqa=True))
    return us_k, us_p, us_l, err


def run(device=None, smoke: bool = False, full: bool = False,
        out_dir=None) -> dict:
    dev = resolve_device(device)
    cfg = bench_config(full=full)
    max_len = 256 if smoke else 1024
    steps = 8 if smoke else 32
    prompt = 8
    params = zoo.init_model(cfg, torch.Generator(dev).manual_seed(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, prompt))
    results = {"config": {"arch": cfg.name, "max_len": max_len,
                          "steps": steps, "device": device_name(dev)}}

    # --- end-to-end serving: bf16 KV vs posit8 KV (per-head + grouped)
    tps = {}
    tps["bf16_kv"] = _engine_tokens_per_s(cfg, params, toks, steps, max_len,
                                          False, dev)
    tps["posit8_kv"] = _engine_tokens_per_s(cfg, params, toks, steps, max_len,
                                            True, dev)
    grp = PrecisionPolicy(rules=[], default="fp32",
                          group_size=cfg.resolved_head_dim // 2)
    tps["posit8_kv_grouped"] = _engine_tokens_per_s(
        cfg, params, toks, steps, max_len, True, dev, policy=grp)
    for name, v in tps.items():
        emit(f"decode/generate_{name}", 1e6 / max(v, 1e-9),
             f"tokens_per_s={v:.1f}")
    results["tokens_per_s"] = tps

    # --- the kernel vs its plain version (and SDPA), one layer
    pos = prompt + steps
    us_k, us_p, us_l, err = _kernel_vs_plain(cfg, max_len, pos, dev)
    emit("decode/flash_kernel_layer", us_k, f"pos={pos};max_len={max_len}")
    emit("decode/flash_plain_layer", us_p, f"pos={pos};max_len={max_len}")
    emit("decode/sdpa_bf16_layer", us_l, f"pos={pos};max_len={max_len}")
    results["kernel_us"] = {"flash": us_k, "plain": us_p, "sdpa_bf16": us_l,
                            "max_abs_err": err}

    # --- modeled KV bytes/step: the two roofline claims
    b = int(toks.shape[0])
    blk = default_kv_block(max_len)
    bytes_bf16 = decode_kv_bytes(cfg, b, max_len, pos, quantized=False)
    bytes_q_full = decode_kv_bytes(cfg, b, max_len, pos, quantized=True,
                                   length_aware=False)
    bytes_q = decode_kv_bytes(cfg, b, max_len, pos, quantized=True, blk=blk)
    bytes_q_8x = decode_kv_bytes(cfg, b, 8 * max_len, pos, quantized=True,
                                 blk=blk)
    ratio = bytes_bf16 / bytes_q
    emit("decode/kv_bytes_per_step", 0.0,
         f"bf16={bytes_bf16:.0f};posit8_full={bytes_q_full:.0f};"
         f"posit8_lenaware={bytes_q:.0f};gain={ratio:.2f}x")
    assert bytes_bf16 >= 2 * bytes_q, \
        "quantized KV decode must move >=2x fewer bytes than the bf16 path"
    assert bytes_q == bytes_q_8x, \
        "length-aware decode must not scale with max_len when pos << max_len"
    results["kv_bytes_per_step"] = {
        "bf16_full": bytes_bf16, "posit8_full": bytes_q_full,
        "posit8_lenaware": bytes_q,
        "posit8_lenaware_8x_maxlen": bytes_q_8x,
        "gain_vs_bf16": ratio, "block": blk, "pos": pos,
    }
    write_json(results, "BENCH_decode.json", out_dir)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small shapes / few steps")
    ap.add_argument("--full", action="store_true",
                    help="qwen2-0.5b at full width (default: reduced)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    run(args.device, smoke=args.smoke, full=args.full)


if __name__ == "__main__":
    main()
