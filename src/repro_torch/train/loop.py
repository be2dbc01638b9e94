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
the reference's jit and donation have no counterpart, and its mesh path
(explicit shardings) waits for the port's ``parallel/sharding.py``.
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
from ..optim import OptConfig, adamw_init, adamw_update, warmup_cosine
from ..parallel import collectives

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
    reach the loss (as JAX gives them)."""
    flat = flatten_with_paths(params)
    live = {p: t.detach().requires_grad_(True) for p, t in flat}
    loss, (ce, aux) = zoo.loss_fn(tree_from_paths(params, live), batch, cfg,
                                  policy=policy)
    gs = torch.autograd.grad(loss, [live[p] for p, _ in flat],
                             allow_unused=True)
    grads = {p: torch.zeros_like(t) if g is None else g
             for (p, t), g in zip(flat, gs)}
    return (tree_from_paths(params, grads), loss.detach(), ce.detach(),
            aux.detach())


def build_train_step(cfg: ModelConfig, run: RunConfig,
                     policy: Optional[PrecisionPolicy] = None, mesh=None):
    """Returns ``(state, batch) -> (state, metrics)``; the input state is
    left as it was (AdamW returns new trees)."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded train step waits for the port's parallel/"
            "sharding.py (ROADMAP Queue 1 item 8)")
    opt_cfg = _opt_config(run)
    policy = policy or make_policy(run)
    qat_policy = policy if run.qat and policy.default != "fp32" else None

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state.params
        mb = run.microbatch
        if mb > 1:
            # unrolled accumulation: microbatch i's grads added in order,
            # then divided once, as the reference's unrolled loop does
            grads = loss = ce = aux = None
            for i in range(mb):
                mb_batch = {k: v[i * (v.shape[0] // mb):
                                 (i + 1) * (v.shape[0] // mb)]
                            for k, v in batch.items()}
                g, lo, c, a = grads_of(params, mb_batch, cfg, qat_policy)
                if grads is None:
                    grads, loss, ce, aux = g, lo, c, a
                else:
                    gl = dict(flatten_with_paths(g))
                    grads = tree_from_paths(grads, {
                        p: t + gl[p] for p, t in flatten_with_paths(grads)})
                    loss, ce, aux = loss + lo, ce + c, aux + a
            grads = tree_from_paths(grads, {
                p: t / mb for p, t in flatten_with_paths(grads)})
            loss, ce, aux = loss / mb, ce / mb, aux / mb
        else:
            grads, loss, ce, aux = grads_of(params, batch, cfg, qat_policy)

        residuals = state.residuals
        if run.grad_compression == "posit8":
            grads, residuals = collectives.error_feedback_update(
                grads, residuals)

        with torch.no_grad():
            leaves = flatten_with_paths(grads)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for _, g in leaves))
            if run.grad_clip > 0:
                scale = torch.clamp(run.grad_clip / (gnorm + 1e-9), max=1.0)
                grads = tree_from_paths(grads,
                                        {p: g * scale for p, g in leaves})
            lr = warmup_cosine(state.step, run.lr, run.warmup_steps,
                               run.steps)
        new_params, new_opt = adamw_update(params, grads, state.opt_state,
                                           lr, opt_cfg)
        new_state = TrainState(state.step + 1, new_params, new_opt,
                               residuals)
        metrics = {"loss": loss, "ce": ce, "aux": aux, "grad_norm": gnorm,
                   "lr": lr}
        return new_state, metrics

    return step_fn


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
