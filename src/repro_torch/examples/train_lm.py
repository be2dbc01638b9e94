"""End-to-end example: train a ~100M-param LM with the full production
feature set -- QAT (paper mixed precision), posit8 gradient compression
with error feedback, 8-bit (posit8) Adam, microbatch accumulation and
async checkpoint/restart (the counterpart of ``examples/train_lm.py``).

~100M params: qwen2-0.5b geometry at 8 layers / d=512 (vocab dominates).
The loop checkpoints every 50 steps into ``--ckpt`` and resumes from the
newest checkpoint there, so a long run survives interruption.  The loss
must fall from the first logged step to the last.

  python -m repro_torch.examples.train_lm [--steps 200] [--seq 256]
      [--batch 16] [--ckpt DIR] [--reduced] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given; ``--reduced``
takes the model's CPU-test variant (vocab 512).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from .. import resolve_device
from ..configs import get_config
from ..configs.base import RunConfig
from ..data.tokens import TokenStream
from ..train.loop import train_loop

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "build", "train_lm_ckpt")


def model_config(reduced: bool = False):
    cfg = dataclasses.replace(
        get_config("qwen2-0.5b"),
        name="qwen2-100m", n_layers=8, d_model=512, n_heads=8, n_kv_heads=2,
        head_dim=64, d_ff=2048, vocab=151936, remat="none", seq_chunk=128)
    return cfg.reduced() if reduced else cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ckpt", default=CKPT_DIR)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data-vocab", type=int, default=None,
                    help="draw the token stream over the first N ids "
                         "(default: the whole vocab)")
    ap.add_argument("--reduced", action="store_true",
                    help="the model's CPU-test variant")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = model_config(args.reduced)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params on {dev}",
          flush=True)
    run = RunConfig(
        arch=cfg.name, steps=args.steps, lr=1e-3, warmup_steps=20,
        microbatch=2, qat=True, precision_policy="mixed",
        grad_compression="posit8", opt_state_dtype="posit8",
        checkpoint_every=50, checkpoint_dir=args.ckpt)
    data = TokenStream(vocab=args.data_vocab or cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, device=dev.type)
    t0 = time.perf_counter()
    state, hist = train_loop(cfg, run, data, log_every=args.log_every,
                             device=dev)
    wall = time.perf_counter() - t0
    if len(hist["loss"]) < 2:
        print(f"nothing to train: resumed at step {int(state.step)} of "
              f"{args.steps} from {args.ckpt}")
        return 0
    print(f"done: loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f} at "
          f"step {int(state.step)} in {wall:.1f} s")
    if not hist["loss"][-1] < hist["loss"][0]:
        print("FAIL training must reduce the loss", file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
