"""Training loop: QAT, microbatch accumulation, compression, recovery (the
counterpart of ``repro.train.loop``).

``build_train_step`` assembles the step for a (ModelConfig, RunConfig)
pair:

  fake-quant params per PrecisionPolicy (QAT plane, STE), one layer at a
  time inside the layer loop
  -> loss and grads (autograd; remat per ``cfg.remat``)
  -> microbatch accumulation (unrolled, summed in microbatch order)
  -> posit8 gradient compression with error feedback
  -> global-norm clip -> warmup-cosine LR -> AdamW (8-bit moments)

``train_loop`` adds checkpoint/restart (atomic, async), preemption
recovery (a step that raises is retried from the newest checkpoint) and
``on_step`` hooks.  The step runs eagerly on the device of the state;
the reference's jit and donation have no counterpart.

With a ``mesh`` (a torch ``DeviceMesh`` over an initialised process
group) the step is sharded as the reference's: parameters, moments and
residuals are DTensors laid out by ``param_sharding_tree``, each rank
takes its rows of the global batch by ``batch_pspec`` and gathers one
layer's weights at a time, and the gradients arrive in the shards
(summed over the data axes).  The reductions over a leaf (the RMS scale
of the compression, the global norm, the posit8 moments' block scales)
run on the whole leaf, gathered one leaf at a time, so they equal the
unsharded step's.  Ranks along the model axis compute the same rows:
the model axis shards storage, not compute.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..configs.base import ModelConfig, RunConfig
from ..core import sensitivity
from ..core.policy import (PrecisionPolicy, flatten_with_paths,
                           tree_from_paths)
from ..models import zoo
from ..optim import OptConfig, adamw_init, warmup_cosine
from ..optim.adamw import adamw_leaf, bias_correction, map_leaves, unzip3
from ..parallel import collectives
from ..parallel.sharding import (batch_ranks, batch_rows, param_sharding_tree,
                                 part, place, use_mesh, whole)

__all__ = ["TrainState", "build_train_step", "train_loop", "make_policy",
           "init_state"]


@dataclasses.dataclass
class TrainState:
    """The reference's fields, so checkpoint paths agree
    (``step``, ``params/...``, ``opt_state/...``, ``residuals/...``)."""
    step: torch.Tensor     # int32 scalar
    params: Any
    opt_state: Any
    residuals: Any         # grad-compression error feedback (None if unused)


def make_policy(run: RunConfig, params=None, grads=None) -> PrecisionPolicy:
    name = run.precision_policy
    if name == "mixed":
        return PrecisionPolicy.paper_mixed()
    if name == "adaptive":
        if params is None or grads is None:
            raise ValueError("the adaptive policy needs a calibration "
                             "gradient (params and grads)")
        return sensitivity.assign_layer_adaptive(
            params, grads, target_avg_bits=run.target_avg_bits)
    return PrecisionPolicy.uniform(name)


def _opt_config(run: RunConfig) -> OptConfig:
    return OptConfig(weight_decay=run.weight_decay,
                     moment_dtype=run.opt_state_dtype)


def init_state(cfg: ModelConfig, run: RunConfig,
               generator: Optional[torch.Generator] = None,
               device=None) -> TrainState:
    """Fresh state: parameters drawn from ``generator`` (its device
    decides), else from a generator seeded ``run.seed`` on ``device``
    (None: the card)."""
    if generator is None:
        generator = torch.Generator(resolve_device(device)).manual_seed(
            run.seed)
    params = zoo.init_model(cfg, generator)
    residuals = None
    if run.grad_compression == "posit8":
        residuals = tree_from_paths(params, {
            p: torch.zeros_like(t) for p, t in flatten_with_paths(params)})
    return TrainState(
        torch.zeros((), dtype=torch.int32, device=generator.device), params,
        adamw_init(params, _opt_config(run)), residuals)


def grads_of(params, batch, cfg: ModelConfig,
             policy: Optional[PrecisionPolicy] = None):
    """(grads tree, loss, ce, aux) of ``zoo.loss_fn`` at ``params``; the
    grads have the structure of ``params``, zeros where a leaf does not
    reach the loss (as JAX gives them).  Inside a mesh every rank's loss
    is the whole batch's, so the backward starts from
    ``1 / batch_ranks()``: the data ranks' gradients then sum to it."""
    flat = flatten_with_paths(params)
    live = {p: t.detach().requires_grad_(True) for p, t in flat}
    loss, (ce, aux) = zoo.loss_fn(tree_from_paths(params, live), batch, cfg,
                                  policy=policy)
    gs = torch.autograd.grad(loss, [live[p] for p, _ in flat],
                             torch.full_like(loss, 1.0 / batch_ranks()),
                             allow_unused=True)
    grads = {p: torch.zeros_like(t) if g is None else g
             for (p, t), g in zip(flat, gs)}
    return (tree_from_paths(params, grads), loss.detach(), ce.detach(),
            aux.detach())


def _apply_grads(state: TrainState, grads: Dict[str, Any], run: RunConfig,
                 opt_cfg: OptConfig):
    """posit8 compression with error feedback -> global-norm clip ->
    warmup-cosine LR -> AdamW, one whole leaf at a time (``whole`` /
    ``part`` gather a sharded leaf and keep this rank's part; a plain
    tensor passes through).  ``grads`` (path -> leaf, in
    ``flatten_with_paths`` order) is consumed: each leaf is dropped once
    it is used.  Returns (new state, grad norm, lr)."""
    res = state.residuals
    res_of = dict(flatten_with_paths(res)) if res is not None else None
    r_out, total = {}, 0
    with torch.no_grad():
        for path in list(grads):
            g = grads.pop(path)
            gw = whole(g)
            if res_of is not None:
                gw, rw = collectives.error_feedback_leaf(gw,
                                                         whole(res_of[path]))
                r_out[path] = part(rw, res_of[path])
            total = total + torch.sum(torch.square(gw.float()))
            grads[path] = part(gw, g)
            del g, gw
        gnorm = torch.sqrt(total)
        scale = torch.clamp(run.grad_clip / (gnorm + 1e-9), max=1.0) \
            if run.grad_clip > 0 else None
        lr = warmup_cosine(state.step, run.lr, run.warmup_steps, run.steps)
        count = whole(state.opt_state["count"]) + 1
        bc = bias_correction(count, opt_cfg)

    def update(p, path, m, v):
        g = whole(grads.pop(path))
        if scale is not None:
            g = g * scale
        new = adamw_leaf(whole(p), g, whole(m), whole(v), lr, bc, opt_cfg)
        return tuple(part(n, old) for n, old in zip(new, (p, m, v)))

    paths = tree_from_paths(state.params, {p: p for p in grads})
    with torch.no_grad():
        new_p, m, v = unzip3(map_leaves(update, state.params, paths,
                                        state.opt_state["m"],
                                        state.opt_state["v"]))
        new_opt = {"m": m, "v": v,
                   "count": part(count, state.opt_state["count"])}
    residuals = tree_from_paths(res, r_out) if res is not None else None
    return TrainState(state.step + 1, new_p, new_opt, residuals), gnorm, lr


def build_train_step(cfg: ModelConfig, run: RunConfig,
                     policy: Optional[PrecisionPolicy] = None, mesh=None):
    """Returns ``(state, batch) -> (state, metrics)``; the input state is
    left as it was (AdamW returns new trees).  With a ``mesh`` returns
    ``(step_fn, shard_state)``: ``shard_state(state)`` lays a whole
    state out on the mesh as DTensors, and ``step_fn`` takes such a
    state and the global batch (every rank passes the same)."""
    opt_cfg = _opt_config(run)
    policy = policy or make_policy(run)
    qat_policy = policy if run.qat and policy.default != "fp32" else None

    def rows(b):
        if mesh is None:
            return b
        r = batch_rows(mesh, next(iter(b.values())).shape[0])
        return {k: v[r] for k, v in b.items()}

    def accumulate(params, batch):
        """(grads as path -> leaf, loss, ce, aux).  Microbatches unrolled:
        microbatch i's grads added in order, then divided once, as the
        reference's unrolled loop does; on a mesh each rank takes its
        rows of each microbatch."""
        mb = run.microbatch
        if mb <= 1:
            g, loss, ce, aux = grads_of(params, rows(batch), cfg, qat_policy)
            return dict(flatten_with_paths(g)), loss, ce, aux
        grads = None
        for i in range(mb):
            mb_batch = rows({k: v[i * (v.shape[0] // mb):
                                  (i + 1) * (v.shape[0] // mb)]
                             for k, v in batch.items()})
            g, lo, c, a = grads_of(params, mb_batch, cfg, qat_policy)
            g = dict(flatten_with_paths(g))
            if grads is None:
                grads, loss, ce, aux = g, lo, c, a
            else:
                for p in grads:
                    grads[p] = grads[p] + g[p]
                loss, ce, aux = loss + lo, ce + c, aux + a
            del g
        for p in grads:
            grads[p] = grads[p] / mb
        return grads, loss / mb, ce / mb, aux / mb

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        with use_mesh(mesh):
            grads, loss, ce, aux = accumulate(state.params, batch)
        new_state, gnorm, lr = _apply_grads(state, grads, run, opt_cfg)
        metrics = {"loss": loss, "ce": ce, "aux": aux, "grad_norm": gnorm,
                   "lr": lr}
        return new_state, metrics

    if mesh is None:
        return step_fn

    def shard_state(state: TrainState) -> TrainState:
        def placed(tree):
            if tree is None:
                return None
            sh = dict(flatten_with_paths(param_sharding_tree(mesh, tree)))
            return tree_from_paths(tree, {p: place(t, sh[p]) for p, t
                                          in flatten_with_paths(tree)})
        return TrainState(state.step, placed(state.params),
                          placed(state.opt_state), placed(state.residuals))

    return step_fn, shard_state


def train_loop(cfg: ModelConfig, run: RunConfig, data,
               state: Optional[TrainState] = None,
               policy: Optional[PrecisionPolicy] = None,
               log_every: int = 10,
               hooks: Optional[Dict[str, Callable]] = None,
               device=None) -> Tuple[TrainState, Dict[str, list]]:
    """Single-process training loop with checkpoint/restart.  A fresh
    state is drawn on ``device`` (None: the card); ``data`` yields its
    batches on the same device."""
    hooks = hooks or {}
    mgr = CheckpointManager(run.checkpoint_dir, keep=run.keep_checkpoints,
                            async_save=True)
    if state is None:
        state = init_state(cfg, run, device=device)
    if mgr.latest_step() is not None:          # resume
        state, extra, at = mgr.restore(state)
        if "data" in extra:
            data.load_state_dict(extra["data"])
        print(f"[train] resumed from step {at}")

    step_fn = build_train_step(cfg, run, policy)
    history: Dict[str, list] = {"loss": [], "ce": [], "step": []}
    t0 = time.perf_counter()
    while int(state.step) < run.steps:
        batch = data.next_batch()
        try:
            state, metrics = step_fn(state, batch)
        except Exception:
            # preemption / transient failure: restore and retry (after the
            # save in flight, if any, has landed)
            mgr.wait()
            if mgr.latest_step() is None:
                raise
            state, extra, at = mgr.restore(state)
            if "data" in extra:
                data.load_state_dict(extra["data"])
            print(f"[train] step failed; restored from {at}")
            continue
        s = int(state.step)
        if "on_step" in hooks:
            hooks["on_step"](s, state, metrics)
        if s % log_every == 0 or s == run.steps:
            history["loss"].append(float(metrics["loss"]))
            history["ce"].append(float(metrics["ce"]))
            history["step"].append(s)
            dt = (time.perf_counter() - t0) / max(s, 1)
            print(f"[train] step {s:5d} loss {float(metrics['loss']):.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt * 1e3:.0f} ms/step")
        if run.checkpoint_every and s % run.checkpoint_every == 0:
            mgr.save(s, state, {"data": data.state_dict()})
    mgr.wait()
    return state, history
