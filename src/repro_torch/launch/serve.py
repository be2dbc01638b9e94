"""Serving CLI of the port: static batched generation with the packed
weight plane and an optional posit8 KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --policy mixed --batch 8 --prompt-len 128 --steps 32 --quantized-kv

It runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path
(use ``--reduced`` there).  Weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..core.policy import PrecisionPolicy
from ..models import zoo
from ..serve.engine import ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--policy", default="mixed",
                    help="mixed (the paper's posit8/FP4 scheme), a format "
                         "name for a uniform policy, or fp32/none")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--quantized-kv", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device).manual_seed(args.seed)
    params = zoo.init_model(cfg, gen)
    policy = None
    if args.policy not in ("fp32", "none"):
        policy = (PrecisionPolicy.paper_mixed() if args.policy == "mixed"
                  else PrecisionPolicy.uniform(args.policy))
    eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.steps + 8,
                      quantized_kv=args.quantized_kv, policy=policy,
                      device=device)
    toks = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (args.batch, args.prompt_len))
    t0 = time.perf_counter()
    out = eng.generate(toks, steps=args.steps, temperature=args.temperature,
                       generator=gen)
    dt = time.perf_counter() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s) on {device}")
    print(out[:, args.prompt_len:][:2])


if __name__ == "__main__":
    main()
