"""Training CLI of the port (the counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --steps 100 --batch 8 --seq 128 --policy mixed --qat \
      [--reduced] [--grad-compression posit8] [--opt-dtype posit8] \
      [--microbatch 2]

With ``--policy mixed --qat --grad-compression posit8 --opt-dtype posit8
--microbatch 2 --batch 16 --seq 256 --lr 1e-3`` it trains with the
feature set of the reference's ``examples/train_lm.py`` (QAT under the
paper's mixed policy, posit8 gradient compression with error feedback,
8-bit AdamW moments, microbatch accumulation, async checkpoints).  It
checkpoints every ``--checkpoint-every`` steps into ``--checkpoint-dir``
and resumes from the newest checkpoint there.

It runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path
(use ``--reduced`` there).  Every family trains.
"""

from __future__ import annotations

import argparse

from .. import resolve_device
from ..configs import get_config
from ..configs.base import RunConfig
from ..data.tokens import TokenStream
from ..train.loop import train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--policy", default="fp32")
    ap.add_argument("--qat", action="store_true")
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--opt-dtype", default="float32")
    ap.add_argument("--checkpoint-dir", default="build/train_ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="use the test-sized config (CPU-friendly)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    run = RunConfig(
        arch=args.arch, steps=args.steps, lr=args.lr,
        microbatch=args.microbatch, qat=args.qat,
        precision_policy=args.policy, grad_compression=args.grad_compression,
        opt_state_dtype=args.opt_dtype, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every)
    data = TokenStream(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, frontend=cfg.frontend,
                       d_model=cfg.d_model, n_patches=cfg.n_patches,
                       device=str(device))
    state, hist = train_loop(cfg, run, data, device=device)
    print(f"final loss: {hist['loss'][-1]:.4f} at step {int(state.step)} "
          f"on {device}")


if __name__ == "__main__":
    main()
