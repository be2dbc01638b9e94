"""Attention-free sequence mixers: Mamba (for Jamba) and RWKV-6 "Finch"
(the counterpart of ``repro.models.ssm``).

Both scans run token by token from the host.  In training (grad
enabled, ``cfg.remat != "none"``) they split the tokens as the reference
does, into ``max(S // cfg.ssm_chunk, 1)`` chunks, and run each chunk
under a checkpoint whose boundary is the recurrent state, so the
backward keeps one chunk's steps at a time (the reference's
``jax.checkpoint`` of each chunk).  The steps and their order are the
same either way, so the forward is bitwise the flat loop's.  Decode is
the same step on one token.

Every product inside a step is written as a broadcast multiply and a sum
over one axis (no batched matmul): the sum's order then depends on the
axis length alone, not on the batch, so a request's state takes the same
bits alone and in a batch.  The projections the serving policy leaves
unpacked (``dt_proj``, the decay LoRA) go through
``layers.rowstable_matmul`` for the same reason.

Serving keeps recurrent state as posit8 codes plus bf16 group scales per
leaf (``quantize_state``), quantized along each leaf's LAST dim; a group
that does not divide a leaf's last dim degrades to one scale per row.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ref import quantize_kv_many
from . import attention as A
from . import layers as L

__all__ = [
    "mamba_init", "mamba_apply", "mamba_decode", "mamba_state_init",
    "rwkv_init", "rwkv_time_mix", "rwkv_channel_mix", "rwkv_state_init",
    "rwkv_decode",
    "quantize_state", "dequantize_state", "requantize_state",
]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) in every range (``F.softplus``
    switches to ``x`` above 20), computed in f32 and rounded once."""
    xf = x.float()
    return torch.logaddexp(xf, torch.zeros_like(xf)).to(x.dtype)


def _scan(step, state, seqs, consts, cfg):
    """``step(state, *token_slices, *consts) -> (state, y)`` over the S
    tokens of ``seqs`` (each (B, S, ...)) from ``state``; returns (final
    state, ys (B, S, ...)).  When the scan is differentiated under
    ``cfg.remat != "none"``, each of the reference's chunks runs under a
    checkpoint (the last chunk takes any tokens the split leaves)."""

    def run(state, *xs):
        # tokens as views cut once (``unbind``): the backward stacks each
        # input's token grads in one copy
        ys = []
        for token in zip(*(x.unbind(1) for x in xs)):
            state, y = step(state, *token, *consts)
            ys.append(y)
        return state, torch.stack(ys, 1)

    tensors = (state, *seqs, *consts)
    if cfg.remat == "none" or not torch.is_grad_enabled() or \
            not any(t.requires_grad for t in tensors):
        return run(state, *seqs)
    from torch.utils.checkpoint import checkpoint
    s = seqs[0].shape[1]
    n = max(s // cfg.ssm_chunk, 1)
    c = s // n
    ys = []
    for i in range(n):
        hi = s if i == n - 1 else (i + 1) * c
        state, y = checkpoint(run, state, *(x[:, i * c:hi] for x in seqs),
                              use_reentrant=False)
        ys.append(y)
    return state, torch.cat(ys, 1)


# ---------------------------------------------------------------------------
# Mamba (S6 selective SSM)
# ---------------------------------------------------------------------------

def _dt_rank(d_model: int) -> int:
    return max(1, math.ceil(d_model / 16))


def mamba_init(gen: torch.Generator, cfg, lead=()):
    """``lead`` stacks every leaf, e.g. ``(n_groups,)``."""
    d, ds = cfg.d_model, cfg.mamba_d_state
    din = cfg.mamba_expand * d
    rank = _dt_rank(d)
    dev = gen.device
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "in_proj": L.dense_init(gen, d, 2 * din, lead=lead),
        "conv_w": L.normal(gen, (*lead, cfg.mamba_d_conv, din), 0.1),
        "conv_bias": torch.zeros((*lead, din), device=dev),
        "x_proj": L.dense_init(gen, din, rank + 2 * ds, lead=lead),
        "dt_proj": L.dense_init(gen, rank, din, bias=True, lead=lead),
        "a_log": a_log.expand(*lead, din, ds).contiguous(),
        "d_skip": torch.ones((*lead, din), device=dev),
        "out_proj": L.dense_init(gen, din, d, lead=lead),
    }


def _causal_conv(x, w, b, init_state):
    """Depthwise causal conv along seq; x (B, S, din), w (K, din).
    Returns (out, the last K-1 inputs: the next call's state)."""
    k = w.shape[0]
    xp = torch.cat([init_state.to(x.dtype), x], dim=1)
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    return out + b.to(x.dtype), xp[:, -(k - 1):]


def _mamba_step(h, dt_t, b_t, c_t, x_t, a):
    """One token: dt_t/x_t (B, din), b_t/c_t (B, ds), a (din, ds)."""
    hbar = torch.exp(dt_t[..., None] * a)
    h = hbar * h + (dt_t * x_t)[..., None] * b_t[:, None, :]
    return h, (h * c_t[:, None, :]).sum(-1)


def mamba_state_init(cfg, batch: int, device=None):
    din = cfg.mamba_expand * cfg.d_model
    return {
        "h": torch.zeros((batch, din, cfg.mamba_d_state), device=device),
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, din),
                            device=device),
    }


def _mamba_core(p, x, cfg, conv_state):
    rank = _dt_rank(cfg.d_model)
    xz = L.dense(p["in_proj"], x)
    xin, z = torch.chunk(xz, 2, dim=-1)
    xin, new_conv = _causal_conv(xin, p["conv_w"], p["conv_bias"],
                                 conv_state)
    xin = F.silu(xin)
    dbl = L.dense(p["x_proj"], xin)
    dt, bmat, cmat = torch.split(
        dbl, [rank, cfg.mamba_d_state, cfg.mamba_d_state], dim=-1)
    dt = softplus(L.dense(p["dt_proj"], dt, rowstable=True)).float()
    a = -torch.exp(p["a_log"])
    return xin, z, dt, bmat.float(), cmat.float(), a, new_conv


def _mamba_out(p, x, y, xin, z):
    y = y.to(x.dtype) + p["d_skip"].to(x.dtype) * xin
    return L.dense(p["out_proj"], y * F.silu(z))


def mamba_apply(p, x, cfg, state=None):
    """x (B, S, D) -> (out, new_state): the prefill path, a scan over the
    S tokens from ``state`` (zeros when None)."""
    if state is None:
        state = mamba_state_init(cfg, x.shape[0], x.device)
    xin, z, dt, bmat, cmat, a, new_conv = _mamba_core(p, x, cfg,
                                                      state["conv"])
    h, y = _scan(_mamba_step, state["h"], (dt, bmat, cmat, xin.float()),
                 (a,), cfg)
    return _mamba_out(p, x, y, xin, z), {"h": h, "conv": new_conv}


def mamba_decode(p, x, cfg, state):
    """Single-token step: x (B, 1, D)."""
    xin, z, dt, bmat, cmat, a, new_conv = _mamba_core(p, x, cfg,
                                                      state["conv"])
    h, y = _mamba_step(state["h"], dt[:, 0], bmat[:, 0], cmat[:, 0],
                       xin[:, 0].float(), a)
    return _mamba_out(p, x, y[:, None], xin, z), {"h": h, "conv": new_conv}


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent decay linear attention
# ---------------------------------------------------------------------------

def rwkv_init(gen: torch.Generator, cfg, lead=()):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    nh = d // hd
    lora = 64
    dev = gen.device

    def full(v):
        return torch.full((*lead, d), v, device=dev)

    u = L.normal(gen, (*lead, nh, hd), 0.1)
    return {
        # token-shift lerp coefficients
        "mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
        "mix_g": full(0.5), "mix_w": full(0.5),
        "wr": L.dense_init(gen, d, d, lead=lead),
        "wk": L.dense_init(gen, d, d, lead=lead),
        "wv": L.dense_init(gen, d, d, lead=lead),
        "wg": L.dense_init(gen, d, d, lead=lead),
        "wo": L.dense_init(gen, d, d, lead=lead),
        # data-dependent decay (the Finch contribution): w = exp(-exp(..))
        "decay_base": full(-5.0),
        "decay_lora_a": {"w": L.normal(gen, (*lead, d, lora), 0.01)},
        "decay_lora_b": {"w": L.normal(gen, (*lead, lora, d), 0.01)},
        "bonus_u": u,
        "ln_x": {"norm_scale": full(1.0)},
        # channel mix
        "cm_mix_k": full(0.5), "cm_mix_r": full(0.5),
        "cm_key": L.dense_init(gen, d, cfg.d_ff, lead=lead),
        "cm_value": L.dense_init(gen, cfg.d_ff, d, lead=lead),
        "cm_receptance": L.dense_init(gen, d, d, lead=lead),
    }


def rwkv_state_init(cfg, batch: int, device=None):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    nh = d // hd
    return {
        "tm_state": torch.zeros((batch, nh, hd, hd), device=device),
        "tm_xprev": torch.zeros((batch, d), device=device),
        "cm_xprev": torch.zeros((batch, d), device=device),
    }


def _shift(x, xprev):
    """x (B, S, D); xprev (B, D) boundary token -> the x_{t-1} stream."""
    if x.shape[1] == 1:
        return xprev[:, None].to(x.dtype)
    return torch.cat([xprev[:, None].to(x.dtype), x[:, :-1]], 1)


def _wkv_step(state, r_t, k_t, v_t, w_t, u):
    """y_t = r_t . (S + diag(u) k_t v_t^T);  S' = diag(w_t) S + k_t v_t^T
    per head; r/k/v/w (B, H, hd), state (B, H, hd_k, hd_v)."""
    kv = k_t[..., :, None] * v_t[..., None, :]
    y = (r_t[..., :, None] * (state + u[..., None] * kv)).sum(-2)
    return w_t[..., :, None] * state + kv, y


def _tm_project(p, x, xprev, cfg):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    nh = d // hd
    xp = _shift(x, xprev)

    def lerp(mix):
        return x + (xp - x) * mix.to(x.dtype)

    b, s, _ = x.shape
    r = L.dense(p["wr"], lerp(p["mix_r"])).reshape(b, s, nh, hd)
    k = L.dense(p["wk"], lerp(p["mix_k"])).reshape(b, s, nh, hd)
    v = L.dense(p["wv"], lerp(p["mix_v"])).reshape(b, s, nh, hd)
    g = F.silu(L.dense(p["wg"], lerp(p["mix_g"])))
    # data-dependent decay (Finch): w_t = exp(-exp(base + lora(x_w)))
    dd = L.dense(p["decay_lora_b"],
                 torch.tanh(L.dense(p["decay_lora_a"], lerp(p["mix_w"]),
                                    rowstable=True)), rowstable=True)
    logw = p["decay_base"].float() + dd.float()
    w = torch.exp(-torch.exp(logw)).reshape(b, s, nh, hd)
    return r.float(), k.float(), v.float(), w, g


def rwkv_time_mix(p, x, cfg, state):
    """x (B, S, D) -> (out, new_state)."""
    b, s, d = x.shape
    r, k, v, w, g = _tm_project(p, x, state["tm_xprev"], cfg)
    st, y = _scan(_wkv_step, state["tm_state"], (r, k, v, w),
                  (p["bonus_u"],), cfg)
    y = y.reshape(b, s, d).to(x.dtype)
    y = L.rmsnorm(p["ln_x"], y)  # per-channel group norm stand-in
    out = L.dense(p["wo"], y * g)
    new_state = dict(state)
    new_state["tm_state"] = st
    new_state["tm_xprev"] = x[:, -1].float()
    return out, new_state


def rwkv_channel_mix(p, x, cfg, state):
    xp = _shift(x, state["cm_xprev"])
    xk = x + (xp - x) * p["cm_mix_k"].to(x.dtype)
    xr = x + (xp - x) * p["cm_mix_r"].to(x.dtype)
    kk = torch.square(F.relu(L.dense(p["cm_key"], xk)))
    out = torch.sigmoid(L.dense(p["cm_receptance"], xr)) * \
        L.dense(p["cm_value"], kk)
    new_state = dict(state)
    new_state["cm_xprev"] = x[:, -1].float()
    return out, new_state


def rwkv_decode(p, x, cfg, state):
    """Single-token step of the time mix (the block chains the channel
    mix after it)."""
    return rwkv_time_mix(p, x, cfg, state)


# ---------------------------------------------------------------------------
# Quantized state (paged serving): posit8 codes + group scales per leaf
# ---------------------------------------------------------------------------
# Each f32 leaf ``x`` becomes ``x_codes`` / ``x_scale`` at the same dict
# level, quantized along its LAST dim like the KV cache.

def _state_items(node):
    """Leaves in sorted key order: the slab layout, the export payload and
    the import all rely on one order."""
    return sorted(node.items())


def _quantize_leaves(state, group_of):
    """Every leaf of ``state`` quantized (``kernels.ref.quantize_kv``, the
    group ``group_of(path)`` each) with one encode over all the leaves;
    returns the codes/scales tree in sorted key order."""
    paths, leaves = [], []

    def walk(node, path):
        for key, val in _state_items(node):
            if isinstance(val, dict):
                walk(val, path + (key,))
            else:
                paths.append(path + (key,))
                leaves.append(val)

    walk(state, ())
    quantized = quantize_kv_many(leaves, [group_of(p) for p in paths])
    out: dict = {}
    for path, (codes, scale) in zip(paths, quantized):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1] + "_codes"] = codes
        node[path[-1] + "_scale"] = scale
    return out


def quantize_state(state, group=None):
    """Posit8-quantize every leaf of a recurrent-state tree (the KV
    cache's ``quantize_kv`` per leaf: a leaf whose last dim ``group``
    does not divide gets one scale per row)."""
    return _quantize_leaves(state, lambda path: group)


def dequantize_state(state_q, dtype=torch.float32):
    """Inverse of :func:`quantize_state` (to f32 by default: the
    recurrences accumulate in f32)."""
    out = {}
    for key, val in _state_items(state_q):
        if isinstance(val, dict):
            out[key] = dequantize_state(val, dtype)
        elif key.endswith("_codes"):
            name = key[:-len("_codes")]
            out[name] = A.dequantize_kv(val, state_q[name + "_scale"], dtype)
    return out


def _leaf_group(codes, scale):
    """The quantization group one leaf was packed with."""
    gs = int(scale.shape[-1])
    return None if gs == 1 else int(codes.shape[-1]) // gs


def requantize_state(state, state_q):
    """Quantize ``state`` into the exact layout of ``state_q``, each
    leaf with the group its old scales were made with, so a leaf that
    degraded to one scale per row stays that way."""

    def group_of(path):
        node = state_q
        for key in path[:-1]:
            node = node[key]
        return _leaf_group(node[path[-1] + "_codes"],
                           node[path[-1] + "_scale"])

    return _quantize_leaves(state, group_of)
