"""AdamW with low-precision moment storage (the counterpart of
``repro.optim.adamw``; plain tensor code, no ``torch.optim``).

``moment_dtype``:
  float32  -- exact baseline
  bfloat16 -- 2x moment memory saving
  posit8   -- 4x: moments live as Posit(8,0) codes with blockwise
              power-of-two scales ("8-bit Adam"); decode -> update ->
              re-encode each step.

Parameters, gradients and moments are nested dicts of tensors with the
same structure; a posit8 moment leaf is ``{"codes", "blk_scale"}``.
``adamw_update`` returns new trees and leaves its inputs unchanged, as
the reference's does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import codec as codec_mod
from ..core import formats as fmt
from ..core.policy import flatten_with_paths

__all__ = ["OptConfig", "adamw_init", "adamw_update", "adamw_leaf",
           "bias_correction", "map_leaves", "unzip3"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"   # float32 | bfloat16 | posit8


_BLOCK = 256  # blockwise quantization granularity (bitsandbytes-style)


def _po2_scale(absmax: torch.Tensor) -> torch.Tensor:
    s = absmax / 64.0 + 1e-30
    return torch.exp2(torch.ceil(torch.log2(s)))


def _q_state(x: torch.Tensor, moment_dtype: str, sqrt_domain: bool = False):
    """Quantize a moment tensor.  posit8 takes a po2 scale per block of
    256 elements along the last axis (per tensor when the last axis is
    not a multiple of 256) and keeps the parameter's shape;
    ``sqrt_domain`` stores sqrt(v), halving the dynamic range needed."""
    if moment_dtype == "float32":
        return x
    if moment_dtype == "bfloat16":
        return x.to(torch.bfloat16)
    if sqrt_domain:
        x = torch.sqrt(x)
    last = x.shape[-1] if x.dim() else 1
    if x.dim() and last % _BLOCK == 0:
        blocks = x.reshape(x.shape[:-1] + (last // _BLOCK, _BLOCK))
        s = _po2_scale(torch.amax(torch.abs(blocks), dim=-1))
        codes = codec_mod.encode(fmt.POSIT8, (blocks / s[..., None]).float())
        return {"codes": codes.reshape(x.shape).to(torch.int8),
                "blk_scale": s.float()}
    s = _po2_scale(torch.amax(torch.abs(x)))
    codes = codec_mod.encode(fmt.POSIT8, (x / s).float())
    return {"codes": codes.to(torch.int8), "blk_scale": s.float()}


def _dq_state(x, moment_dtype: str, sqrt_domain: bool = False):
    if moment_dtype == "float32":
        return x
    if moment_dtype == "bfloat16":
        return x.float()
    codes = x["codes"].to(torch.int32)
    s = x["blk_scale"]
    vals = codec_mod.decode(fmt.POSIT8, codes)
    if s.dim():
        blocks = vals.reshape(vals.shape[:-1] + (s.shape[-1], _BLOCK))
        out = (blocks * s[..., None]).reshape(vals.shape)
    else:
        out = vals * s
    if sqrt_domain:
        out = torch.square(out)
    return out


def map_leaves(fn, params, *trees):
    """``fn`` over the parameter leaves, the other trees walked along the
    parameters' structure (a posit8 moment dict is one leaf)."""
    if isinstance(params, dict):
        return {k: map_leaves(fn, params[k], *(t[k] for t in trees))
                for k in params}
    return fn(params, *trees)


def adamw_init(params, cfg: OptConfig):
    def zeros(sqrt_domain):
        return lambda p: _q_state(torch.zeros_like(p, dtype=torch.float32),
                                  cfg.moment_dtype, sqrt_domain)
    device = flatten_with_paths(params)[0][1].device
    return {"m": map_leaves(zeros(False), params),
            "v": map_leaves(zeros(True), params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def bias_correction(count: torch.Tensor, cfg: OptConfig):
    """(1 - b1^t, 1 - b2^t) at step ``count``."""
    c = count.float()
    return 1.0 - cfg.b1 ** c, 1.0 - cfg.b2 ** c


@torch.no_grad()
def adamw_leaf(p, g, m, v, lr, bc, cfg: OptConfig):
    """One parameter leaf's step -> (new param, new m, new v); ``bc``
    from :func:`bias_correction`.  posit8 moment block scales come from
    the whole leaf, so a sharded step passes whole leaves."""
    bc1, bc2 = bc
    g = g.float()
    m_f = _dq_state(m, cfg.moment_dtype)
    v_f = _dq_state(v, cfg.moment_dtype, sqrt_domain=True)
    m_new = cfg.b1 * m_f + (1 - cfg.b1) * g
    v_new = cfg.b2 * v_f + (1 - cfg.b2) * torch.square(g)
    step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
    if p.dim() >= 2:
        step = step + cfg.weight_decay * p.float()
    p_new = (p.float() - lr * step).to(p.dtype)
    return (p_new, _q_state(m_new, cfg.moment_dtype),
            _q_state(v_new, cfg.moment_dtype, sqrt_domain=True))


def unzip3(tree):
    """A tree of (param, m, v) triples at the parameter leaves -> the
    three trees."""

    def part(tree, i):
        if isinstance(tree, dict):
            return {k: part(v, i) for k, v in tree.items()}
        return tree[i]

    return part(tree, 0), part(tree, 1), part(tree, 2)


@torch.no_grad()
def adamw_update(params, grads, state, lr, cfg: OptConfig):
    """One AdamW step -> (new params, new state).  Weight decay is
    decoupled and applies to matrices only."""
    count = state["count"] + 1
    bc = bias_correction(count, cfg)
    new_p, m, v = unzip3(map_leaves(
        lambda p, g, m, v: adamw_leaf(p, g, m, v, lr, bc, cfg),
        params, grads, state["m"], state["v"]))
    return new_p, {"m": m, "v": v, "count": count}
