"""Top-k MoE with sort-based dispatch (the counterpart of
``repro.models.moe``).

  route -> top-k -> flatten (token, expert) pairs -> stable sort by
  expert -> position within expert -> scatter into the (E, C, D) expert
  buffer (pairs past capacity C go to a drop slot) -> expert FFN ->
  weighted combine.

Ties go where the reference sends them: ``lax.top_k`` keeps the lower
index first and ``jnp.argsort`` is stable, so both are a stable
``torch.sort``.  The combine sums each token's k contributions in one
fixed order (expert ascending, the order of the sorted pairs the
reference scatter-adds), never through an atomic add.

Expert weights are ``(E, K, N)`` stacks, plain or packed.  A packed stack
is decoded at use, as in the reference: on the CPU the whole stack
through ``to_dense``; on the card one expert slice at a time through the
``dequant`` kernel, which writes the compute dtype (f32 or bf16) itself,
then that expert's products
(``layers.rowstable_matmul``), so at most one decoded slice of a leaf is
live.  Every expert runs, empty or not (skipping one would need the
host to read the counts).

In the sharded train step each rank routes its own rows of the batch:
dispatch groups and capacity count that rank's tokens (so the step
equals the unsharded one where no pair is dropped), while the
load-balance loss is the whole batch's (``sharding.batch_sum``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.fake import is_fake
from ..kernels.ops import PackedTensor, dequant, to_dense
from ..parallel.sharding import batch_ranks, batch_sum
from . import layers as L

__all__ = ["moe_init", "moe_apply"]


def _expert_ffn_init(gen: torch.Generator, d: int, d_ff: int, n: int,
                     kind: str, lead=()):
    """Stacked expert weights: leading dims ``lead`` then experts."""
    scale1, scale2 = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    p = {"gate": L._uniform(gen, (*lead, n, d, d_ff), scale1),
         "up": L._uniform(gen, (*lead, n, d, d_ff), scale1),
         "down": L._uniform(gen, (*lead, n, d_ff, d), scale2)}
    if kind == "gelu":
        del p["gate"]
    return p


def moe_init(gen: torch.Generator, cfg, lead=()):
    d_ff = cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": {"w": L.normal(gen, (*lead, cfg.d_model, cfg.n_experts),
                                 0.02)},
        "experts": _expert_ffn_init(gen, cfg.d_model, d_ff, cfg.n_experts,
                                    cfg.ffn_kind, lead),
    }
    if cfg.shared_experts:
        p["shared"] = L.ffn_init(gen, cfg.d_model, d_ff * cfg.shared_experts,
                                 cfg.ffn_kind, lead=lead)
    if cfg.dense_residual:
        p["residual"] = L.ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind,
                                   lead=lead)
    return p


def _n_groups(n: int, target: int = 4096, cap: int = 512) -> int:
    """Largest power-of-2 group count with >= ``target`` tokens/group."""
    g = 1
    while g * 2 <= cap and n % (g * 2) == 0 and n // (g * 2) >= target:
        g *= 2
    return g


def _expert_product(x: torch.Tensor, w, dtype) -> torch.Tensor:
    """x (G, E, C, K) @ expert stack (E, K, N) -> (G, E, C, N).  The
    card's route (one expert at a time) also runs on fake tensors, so a
    dry run counts what the card does."""
    if x.is_cuda or is_fake(x):
        outs = []
        for e in range(x.shape[1]):
            we = w[e]
            we = dequant(we, dtype) if isinstance(we, PackedTensor) \
                else we.to(dtype)
            outs.append(L.rowstable_matmul(x[:, e], we))
        return torch.stack(outs, 1)
    w = to_dense(w, dtype) if isinstance(w, PackedTensor) else w.to(dtype)
    return torch.einsum("gecd,edf->gecf", x, w)


def _expert_ffn_grouped(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x (G, E, C, D) -> same."""
    up = _expert_product(x, p["up"], x.dtype)
    if kind in ("swiglu", "geglu"):
        g = _expert_product(x, p["gate"], x.dtype)
        act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(up, approximate="tanh")
    return _expert_product(h, p["down"], x.dtype)


def _route(p, xt: torch.Tensor, k: int):
    """Router over (G, Ng, D) tokens -> (probs, top_p, top_i): f32
    softmax probabilities and the k largest, ties to the lower expert."""
    logits = L.rowstable_matmul(xt.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = srt.values[..., :k], srt.indices[..., :k]
    return probs, top_p / top_p.sum(-1, keepdim=True), top_i


def _capacity(nk: int, e: int, capacity_factor: float) -> int:
    return max(int(math.ceil(nk / e * capacity_factor)), 4)


def _dispatch(eg: torch.Tensor, e: int, cap: int):
    """One group's (Ng, K) expert ids -> (dst, order): ``order`` sorts the
    token-major (token, slot) pairs stably by expert, and ``dst`` is each
    sorted pair's buffer row ``expert * cap + position`` or the drop row
    ``e * cap`` past capacity."""
    flat_e = eg.reshape(-1)
    nk = flat_e.shape[0]
    srt = torch.sort(flat_e, stable=True)
    es, order = srt.values, srt.indices
    counts = torch.zeros(e, dtype=torch.long, device=eg.device)
    counts.scatter_add_(0, es, torch.ones_like(es))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(nk, device=eg.device) - starts[es]
    dst = torch.where(pos < cap, es * cap + pos, e * cap)
    return dst, order


def moe_apply(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out, aux_loss)."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.experts_per_tok
    g = _n_groups(n)
    ng = n // g
    xt = x.reshape(g, ng, d)
    probs, top_p, top_i = _route(p, xt, k)

    # load-balance aux (switch-style): E * sum_e f_e * P_e, f_e the mean
    # count of picks per token (a scatter: one_hot would read the ids back)
    # (inside a mesh both means run over the whole batch's tokens)
    picks = torch.zeros(e, device=x.device).scatter_add_(
        0, top_i.reshape(-1), torch.ones(top_i.numel(), device=x.device))
    n_all = g * ng * batch_ranks()
    f_e = batch_sum(picks) / n_all
    p_e = probs.mean((0, 1)) if n_all == g * ng else \
        batch_sum(probs.sum((0, 1))) / n_all
    aux = e * torch.sum(f_e * p_e)

    nk = ng * k
    cap = _capacity(nk, e, cfg.capacity_factor)
    ws_all = top_p.to(x.dtype)
    bufs, plans = [], []
    for gi in range(g):
        dst, order = _dispatch(top_i[gi], e, cap)
        toks = order // k
        buf = x.new_zeros((e * cap + 1, d))
        buf[dst] = xt[gi][toks]
        bufs.append(buf[: e * cap].reshape(e, cap, d))
        plans.append((dst, order))
    eout = _expert_ffn_grouped(p["experts"], torch.stack(bufs), cfg.ffn_kind)

    outs = []
    for gi, (dst, order) in enumerate(plans):
        yflat = torch.cat([eout[gi].reshape(e * cap, d),
                           eout.new_zeros((1, d))])
        contrib = yflat[dst] * ws_all[gi].reshape(nk)[order][:, None]
        # each token's pairs in sorted (expert ascending) order, summed
        # one after the other onto zero
        rank = torch.empty_like(order)
        rank[order] = torch.arange(nk, device=x.device)
        by_tok = contrib[rank.reshape(ng, k).sort(-1).values]   # (Ng, K, D)
        acc = x.new_zeros((ng, d))
        for j in range(k):
            acc = acc + by_tok[:, j]
        outs.append(acc)
    out = torch.stack(outs).reshape(b, s, d)

    if cfg.shared_experts:
        out = out + L.ffn(p["shared"], x, cfg.ffn_kind)
    if cfg.dense_residual:
        out = out + L.ffn(p["residual"], x, cfg.ffn_kind)
    return out, aux.float()
