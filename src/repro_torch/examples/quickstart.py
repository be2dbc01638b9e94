"""Quickstart: the XR-NPE pipeline end to end on the port (the
counterpart of ``examples/quickstart.py``).

1. Build a model (qwen2-0.5b reduced, or at full width with ``--full``),
   take one calibration gradient.
2. Derive the layer-adaptive precision policy (paper eq. 1-2; scale
   groups of ``KV_GROUP``).
3. QAT-train with fake-quantized weights (STE), microbatch 2, posit8
   AdamW moments and posit8 gradient compression, with an async
   checkpoint restored into a fresh state and the steps after it rerun.
4. Pack the weights for serving (each packed leaf == its fake-quant
   bitwise) and generate with a posit8 KV cache; on the card the packed
   projections and the decode attention run the hand kernels.

  python -m repro_torch.examples.quickstart [--full] [--device cpu]
      [--steps 30] [--seq 64] [--batch 8]

It runs on the CUDA card unless ``--device cpu`` is given; it exits
non-zero if a check misses.  ``chip_smoke.py`` phase 7 calls
:func:`quickstart` at qwen2-0.5b's full width.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..configs.base import RunConfig
from ..core.policy import flatten_with_paths
from ..core.sensitivity import assign_layer_adaptive
from ..data.tokens import TokenStream
from ..kernels.flash_decode import flash_decode
from ..kernels.ops import PackedTensor, to_dense
from ..kernels.rmmec_matmul import rmmec_matmul
from ..models import zoo
from ..serve.engine import ServeEngine
from ..train.loop import build_train_step, grads_of, init_state

TRAIN_REL = 1e-3   # resumed vs uninterrupted losses (atomics in the
                   # embedding backward)
KV_GROUP = 32      # one scale grid for QAT and the packed plane
CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "build", "quickstart_ckpt")


def _rmmec_per_forward(params, cfg) -> int:
    """RMMEC launches of one forward: one per packed 2-D weight a layer
    reads (the stacked layers' once per layer) and the read-out."""
    return sum(cfg.n_layers if path.startswith("layers/") else 1
               for path, node in flatten_with_paths(params, keep_packed=True)
               if isinstance(node, PackedTensor))


def quickstart(fails, cfg, device="cuda", seq=256, batch=16, steps=20,
               save_at=10, ckpt_dir=None, profile_at=None, data_vocab=None,
               profile=None, log=print, min_drop=0.5):
    """``examples/quickstart.py`` on the port: one calibration gradient ->
    the layer-adaptive policy (6.0 bits, scale groups of ``KV_GROUP``) ->
    ``steps`` QAT steps (lr 3e-3, warmup 5, microbatch 2, posit8 AdamW
    moments, posit8 gradient compression) with an async checkpoint after
    step ``save_at``, restored into a fresh state and rerun to the end ->
    the trained tree packed (each leaf == its fake-quant bitwise) ->
    ``ServeEngine.generate`` with a posit8 KV cache, batch 2, prompt 8, 8
    greedy steps.  ``data_vocab``: the token stream's vocab (None: the
    model's).  ``profile(fn)`` -> (wall ms, device dict, host dict) times
    step ``profile_at``; ``log`` prints; the last loss must lie
    ``min_drop`` below the first.  Appends a message to ``fails`` for
    each miss; returns the measured numbers."""

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = {}
    ckpt_dir = ckpt_dir or CKPT_DIR
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    run = RunConfig(arch=cfg.name, steps=steps, lr=3e-3, warmup_steps=5,
                    microbatch=2, qat=True, precision_policy="adaptive",
                    grad_compression="posit8", opt_state_dtype="posit8",
                    checkpoint_every=0)
    stream = dict(vocab=data_vocab or cfg.vocab, seq_len=seq,
                  global_batch=batch, seed=0, device=device)
    t0 = time.perf_counter()
    state = init_state(cfg, run, torch.Generator(device).manual_seed(0))
    grads, loss0, _, _ = grads_of(state.params,
                                  TokenStream(**stream).next_batch(), cfg)
    policy = assign_layer_adaptive(state.params, grads,
                                   target_avg_bits=run.target_avg_bits)
    policy.group_size = KV_GROUP
    del grads
    # the target holds for the weights the policy quantizes; the tree's
    # average also counts the leaves kept in f32 (the embedding above all)
    formats, n_q, bits_q = {}, 0, 0
    for path, leaf in flatten_with_paths(state.params):
        spec = policy.format_for(path)
        formats[spec.name] = formats.get(spec.name, 0) + 1
        if spec.kind != "native":
            n_q += leaf.numel()
            bits_q += leaf.numel() * spec.bits
    out["avg_bits"] = bits_q / max(n_q, 1)
    out["avg_bits_all"] = policy.average_bits(state.params)
    out["packed_bytes"] = policy.model_bytes(state.params)
    sync()
    log(f"[train] {cfg.name}: calibration loss {float(loss0):.4f}; adaptive "
        f"policy {out['avg_bits']:.3f} bits per quantized weight (target "
        f"{run.target_avg_bits}; {out['avg_bits_all']:.3f} over the whole "
        f"tree with its f32 leaves), packed {out['packed_bytes'] / 1e6:.2f} "
        f"MB, leaves per format {formats}; init + calibration "
        f"{time.perf_counter() - t0:.1f} s")
    if not out["avg_bits"] <= run.target_avg_bits:
        fails.append(f"train: adaptive policy {out['avg_bits']} bits > "
                     f"{run.target_avg_bits}")

    step = build_train_step(cfg, run, policy)
    data = TokenStream(**stream)
    mgr = CheckpointManager(ckpt_dir, keep=2, async_save=True)
    losses, step_ms, batches = [], [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for i in range(1, steps + 1):
        b = data.next_batch()
        batches.append(b)
        sync()
        t1 = time.perf_counter()
        if i == profile_at and profile is not None:
            box = {}
            wall, dev, _ = profile(lambda: box.update(r=step(state, b)))
            state, m = box.pop("r")   # kept in the box, it outlives its step
            out["profile"] = (wall, dev)
        else:
            state, m = step(state, b)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if i == save_at:
            saved = state
            mgr.save(i, state, {"data": data.state_dict()})
    out["losses"], out["step_ms"] = losses, step_ms
    timed = [ms for i, ms in enumerate(step_ms[1:], 2) if i != profile_at]
    out["ms_per_step"] = float(np.median(timed))
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] {steps} QAT steps (batch {batch} x {seq}, microbatch 2): "
        f"losses {[round(x, 4) for x in losses]}; median "
        f"{out['ms_per_step']:.1f} ms/step (first {step_ms[0]:.1f} ms), "
        f"peak memory {out.get('peak_gib', float('nan')):.2f} GiB")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0] - min_drop):
        fails.append(f"train: losses {losses[0]} -> {losses[-1]} (finite, "
                     f"a drop of {min_drop} wanted)")

    # checkpoint: restore into a fresh state, resume the data, rerun
    mgr.wait()
    fresh = init_state(cfg, run, torch.Generator(device).manual_seed(1))
    restored, extra, at = mgr.restore(fresh)
    del fresh
    got, want = flatten_with_paths(restored), flatten_with_paths(saved)
    same = [p for p, _ in got] == [p for p, _ in want] and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for (_, a), (_, b) in zip(got, want))
    del saved, got, want
    data2 = TokenStream(**stream)
    data2.load_state_dict(extra["data"])
    nb = data2.next_batch()
    same_batch = data2.step == save_at + 1 and all(
        torch.equal(nb[k], batches[save_at][k]) for k in nb)
    data2.load_state_dict(extra["data"])
    state2, resumed = restored, []
    for _ in range(save_at, steps):
        state2, m = step(state2, data2.next_batch())
        resumed.append(float(m["loss"]))
    del state2, restored
    ref = np.array(losses[save_at:])
    rel = float(np.max(np.abs(np.array(resumed) - ref) / np.abs(ref)))
    out["resume_rel"], out["resume_bitwise"] = rel, resumed == list(ref)
    log(f"[train] async checkpoint at step {at} restored into a fresh state "
        f"bitwise: {same}; data resumed at step {extra['data']['step']}, next "
        f"batch bitwise: {same_batch}; steps {save_at + 1}-{steps} rerun: "
        f"losses {[round(x, 4) for x in resumed]}, max rel diff {rel:.3e} "
        f"(tol {TRAIN_REL}; bitwise: {out['resume_bitwise']}; "
        f"deterministic algorithms off)")
    if not same:
        fails.append("train: restored checkpoint differs from the saved state")
    if not same_batch:
        fails.append("train: data iterator did not resume bitwise")
    if not rel <= TRAIN_REL:
        fails.append(f"train: resumed losses differ by {rel:.3e}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # pack: the serving plane == the QAT plane, leaf for leaf
    with torch.no_grad():
        fake = dict(flatten_with_paths(
            zoo.quantize_params_fake(state.params, policy)))
        packed = zoo.pack_params(state.params, policy)
        n_packed, bad = 0, []
        for path, node in flatten_with_paths(packed, keep_packed=True):
            if isinstance(node, PackedTensor):
                n_packed += 1
                if not torch.equal(to_dense(node, torch.float32),
                                   fake[path]):
                    bad.append(path)
    del fake, packed
    out["n_packed"] = n_packed
    log(f"[train] pack: {n_packed} packed leaves, to_dense == "
        f"quantize_params_fake bitwise for {n_packed - len(bad)}")
    if bad or not n_packed:
        fails.append(f"train: packed leaves differ from fake-quant: {bad}")

    # serve the trained tree
    eng = ServeEngine(cfg, state.params, max_len=32, quantized_kv=True,
                      policy=policy, device=device)
    prompt = batches[0]["tokens"][:2, :8].cpu().numpy()
    new = 8
    if cuda:
        kernels = (rmmec_matmul, flash_decode)
        for k in kernels:
            k.launches = 0
        sync()
        t1 = time.perf_counter()
        toks = eng.generate(prompt, new)
        sync()
        wall = time.perf_counter() - t1
        want_l = {"rmmec_matmul": _rmmec_per_forward(eng.params, cfg)
                  * (1 + new), "flash_decode": cfg.n_layers * new}
        got_l = {k.__name__: k.launches for k in kernels}
        out["launches"] = got_l
        log(f"[train] served {toks.shape} in {wall * 1e3:.1f} ms: "
            f"{toks[:, 8:].tolist()}; launches {got_l}, expected {want_l}")
        if got_l != want_l:
            fails.append(f"train: serve launches {got_l}, expected {want_l}")
    else:
        toks = eng.generate(prompt, new)
    if toks.shape != (2, 8 + new) or toks.min() < 0 \
            or toks.max() >= cfg.vocab:
        fails.append(f"train: bad served tokens {toks.shape}")
    out["generated"] = toks[:, 8:]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="qwen2-0.5b at full width (default: reduced)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=CKPT_DIR,
                    help="checkpoint directory (emptied first)")
    ap.add_argument("--min-drop", type=float, default=0.5,
                    help="the last QAT loss must lie this far below the "
                         "first")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("qwen2-0.5b")
    cfg = cfg if args.full else cfg.reduced()
    fails = []
    out = quickstart(fails, cfg, device=dev.type, seq=args.seq,
                     batch=args.batch, steps=args.steps,
                     save_at=max(args.steps // 2, 1), ckpt_dir=args.ckpt,
                     data_vocab=cfg.reduced().vocab,
                     min_drop=args.min_drop)
    print(f"QAT losses {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}; "
          f"policy {out['avg_bits']:.2f} bits per quantized weight, packed "
          f"{out['packed_bytes'] / 1e6:.2f} MB")
    print("generated:", out["generated"].tolist())
    for f in fails:
        print(f"FAIL {f}", file=sys.stderr)
    if fails:
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
