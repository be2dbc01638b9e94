"""The paper's headline workload, UL-VIO with layer-adaptive mixed
precision, end to end on the port (the counterpart of
``examples/vio_serve.py``).

1. Train the VIO model (visual + IMU fusion) on synthetic KITTI-like
   sequences.
2. Score layers with the eq. 1-2 sensitivity metric; assign HFP4/Posit
   formats under a 6-bit average budget.
3. Compare FP32 vs Posit8 vs FP4 vs mixed-precision RMSE (the paper's
   Fig. 6) and model bytes (the 13.5 -> 2.42 MB story).
4. Serve a batch of "frames" through the quantized model.

``--continuous`` also serves concurrent perception-narration streams of
very different lengths through the paged-KV ``ContinuousEngine`` (a
shared scene preamble through the prefix cache, a long prompt absorbed
16 tokens at a time by chunked prefill, ``--decode-steps`` K decode
iterations per dispatch, per-stream SLOs from the lifecycle trace);
``--disagg`` serves them through ``DisaggEngine`` instead.

  python -m repro_torch.examples.vio_serve [--continuous [--disagg]
      [--decode-steps 2]] [--steps 400] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..core.policy import PrecisionPolicy, flatten_with_paths, tree_from_paths
from ..core.qat import quantize_tree
from ..core.sensitivity import assign_layer_adaptive
from ..data.vio_data import VIOStream
from ..models import perception as P
from ..models import zoo
from ..obs import TraceRecorder
from ..serve.disagg import DisaggEngine
from ..serve.engine import ContinuousEngine


def _on(batch, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _grads(params, batch):
    """({path: grad}, metrics) of ``vio_loss`` at ``params``."""
    leaves = {p: t.detach().requires_grad_(True)
              for p, t in flatten_with_paths(params)}
    loss, m = P.vio_loss(tree_from_paths(params, leaves), batch)
    got = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, got)), {k: v.detach() for k, v in m.items()}


def train_vio(dev, steps: int = 400, log=print):
    """SGD (lr 1e-3) on ``VIOStream(batch=64)``; returns (params, the
    stream)."""
    stream = VIOStream(batch=64)
    params = P.vio_init(torch.Generator(dev).manual_seed(0))
    log("training UL-VIO on synthetic KITTI-like sequences...")
    for i in range(steps):
        g, m = _grads(params, _on(stream.next_batch(), dev))
        params = tree_from_paths(params, {
            p: t.detach() - 1e-3 * g[p]
            for p, t in flatten_with_paths(params)})
        if (i + 1) % 100 == 0:
            log(f"  step {i+1}: t-RMSE {float(m['t_rmse']):.4f} m, "
                f"r-RMSE {float(m['r_rmse']):.4f} rad")
    return params, stream


def serve_streams(dev, disagg: bool, decode_steps: int, log=print) -> dict:
    """Concurrent XR streams with staggered arrivals through the paged
    engines; returns the engine's counters."""
    recorder = TraceRecorder()
    cfg = get_config("qwen2-0.5b").reduced()
    lm = zoo.init_model(cfg, torch.Generator(dev).manual_seed(7))
    kw = dict(page_size=16, max_batch=4, max_len=64,
              policy=PrecisionPolicy.uniform("posit8_0"),
              prefill_chunk_tokens=16, prefix_cache=True,
              decode_steps=decode_steps, trace=recorder)
    if disagg:
        eng = DisaggEngine(cfg, lm, prefill_pages=32, decode_pages=32,
                           prefill_device=dev, decode_device=dev, **kw)
    else:
        eng = ContinuousEngine(cfg, lm, n_pages=32, device=dev, **kw)
    rng = np.random.default_rng(0)
    scene = rng.integers(0, cfg.vocab, (16,))   # shared scene preamble
    arrivals = [(s, int(rng.integers(3, 12)), int(rng.integers(4, 16)))
                for s in (0, 0, 1, 2, 2, 4)]   # (arrive_step, plen, gen)
    arrivals.append((3, 24, 6))   # a long prompt lands mid-decode
    log(f"\ncontinuous XR streams (arrive@step, tail, gen): {arrivals}")
    pending = sorted(arrivals, key=lambda a: a[0])
    sched = eng.prefill.scheduler if disagg else eng.scheduler
    step = 0
    while pending or (eng.has_work if disagg else sched.has_work):
        while pending and pending[0][0] <= step:
            _, plen, gen = pending.pop(0)
            prompt = np.concatenate(
                [scene, rng.integers(0, cfg.vocab, (plen,))])
            eng.submit(prompt, gen)
        eng.step()
        step += 1
    done = eng.finished if disagg else sched.finished
    px = sched.prefix
    out = {"streams": len(done), "engine_steps": step,
           "prefix_hits": px.hits, "prefix_hit_tokens": px.hit_tokens,
           "decode_dispatches": eng.decode_dispatches}
    if disagg:
        log(f"served {len(done)} streams in {step} engine steps; pool peaks "
            f"prefill {eng.prefill.pool.alloc_peak}/"
            f"{eng.prefill.pool.n_pages} decode {eng.decode.pool.alloc_peak}/"
            f"{eng.decode.pool.n_pages} pages; prefix cache {px.hits} hits "
            f"({px.hit_tokens} prefill tokens skipped)")
        log(f"handoff: {eng.handoffs} handoffs, {eng.handoff_pages} posit8 "
            f"pages, {eng.handoff_bytes} bytes over the channel, "
            f"{eng.decode_bounces} decode bounces")
        out.update(handoffs=eng.handoffs, handoff_bytes=eng.handoff_bytes)
    else:
        log(f"served {len(done)} streams in {step} engine steps; peak pool "
            f"use {eng.pool.alloc_peak}/{eng.pool.n_pages} pages, "
            f"preemptions {sched.preemption_count}; prefix cache {px.hits} "
            f"hits ({px.hit_tokens} prefill tokens skipped)")
    log(f"decode loop: K={eng.decode_steps}, {eng.decode_dispatches} "
        f"dispatches, {eng.page_table_uploads} page-table uploads, "
        f"{eng.token_host_bytes} token bytes to host")
    log("stream SLOs (ms):")
    for name, s in recorder.slo_summary().items():
        log(f"  {name:>17}: p50 {s['p50']:8.2f}  p95 {s['p95']:8.2f}  "
            f"p99 {s['p99']:8.2f}  (n={s['n']})")
    util = eng.metrics.value(
        "decode/pool/utilization" if disagg else "pool/utilization")
    log(f"pool utilization at drain: {util:.2f}; "
        f"{recorder.count('PREFILL_CHUNK')} prefill chunks traced across "
        f"{len(recorder)} ring events")
    out["n_arrivals"] = len(arrivals)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--continuous", action="store_true",
                    help="also serve staggered LM streams through the "
                         "paged-KV ContinuousEngine")
    ap.add_argument("--decode-steps", type=int, default=2,
                    help="decode iterations per dispatch of the "
                         "--continuous demo (temperature-0 tokens are "
                         "identical for every K)")
    ap.add_argument("--disagg", action="store_true",
                    help="serve the --continuous stream mix through the "
                         "disaggregated prefill/decode engine instead "
                         "(implies --continuous)")
    ap.add_argument("--steps", type=int, default=400,
                    help="VIO training steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    args.continuous = args.continuous or args.disagg
    dev = resolve_device(args.device)

    params, stream = train_vio(dev, args.steps)
    test = _on(stream.next_batch(), dev)
    grads, _ = _grads(params, test)
    policy = assign_layer_adaptive(params, tree_from_paths(params, grads),
                                   target_avg_bits=6.0)

    rows = [("fp32", PrecisionPolicy.uniform("fp32")),
            ("posit8", PrecisionPolicy.uniform("posit8_0")),
            ("fp4", PrecisionPolicy.uniform("fp4")),
            ("mxp(eq.1-2)", policy)]
    print(f"\n{'policy':>12s} {'t-RMSE':>8s} {'r-RMSE':>8s} {'MB':>6s}")
    base = None
    with torch.no_grad():
        for name, pol in rows:
            _, m = P.vio_loss(quantize_tree(params, pol), test)
            mb = pol.model_bytes(params) / 1e6
            t, r = float(m["t_rmse"]), float(m["r_rmse"])
            if base is None:
                base = (t, r)
            print(f"{name:>12s} {t:8.4f} {r:8.4f} {mb:6.2f}"
                  f"   (dt {100*(t-base[0]):+.2f}pp, "
                  f"dr {100*(r-base[1]):+.2f}pp)")
        pose = P.vio_apply(quantize_tree(params, policy), test)
    if not torch.isfinite(pose).all():
        print("FAIL non-finite pose estimates", file=sys.stderr)
        return 1
    print(f"\nserved {pose.shape[0]} frame-pairs; first pose estimate: "
          f"{pose[0].cpu().numpy()}")
    if args.continuous:
        out = serve_streams(dev, args.disagg, args.decode_steps)
        if out["streams"] != out["n_arrivals"]:
            print(f"FAIL served {out['streams']} of {out['n_arrivals']} "
                  f"streams", file=sys.stderr)
            return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
