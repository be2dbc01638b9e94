"""Plain reference of a Jamba-style hybrid decoder (jamba-v0.1) as its
configuration serves it.

The layers come in groups of ``attn_every``: attention (RoPE, grouped
queries) at index ``attn_every // 2``, a Mamba (S6) mixer elsewhere; a
mixture of experts (softmax router, top-k, weights renormalised over
the k) where ``index % moe_every == 1``, a SwiGLU feed-forward
elsewhere.  Pre-norm with RMSNorm throughout, a final RMSNorm and an
untied read-out.

What the serving configuration fixes, and the reference follows:

  * prompts prefill on the carry context: a prompt position attends to
    the prompt's keys and values as computed; a decoded position
    attends to every earlier key and value through the posit8 cache;
  * the Mamba state (``h`` and the convolution's last inputs) runs in
    float32 through the prompt, is put on the posit8 state grid when
    the prompt completes, and after every decoded token;
  * no expert drops a token (the configuration's capacity holds every
    pair).

Departures of the served model from the published Jamba, which the
reference shares because they are the configuration's: RoPE in the
attention layer (Jamba uses none), and no RMSNorm on the Mamba mixer's
dt, B and C.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import codecs, common
from .weights import normal, uniform

__all__ = ["stacks", "top", "logits", "layout"]


def layout(m):
    """(mixer, uses experts) of each index of a group."""
    k = m["attn_every"]
    return [("attn" if i == k // 2 else "mamba",
             m["n_experts"] > 0 and i % m["moe_every"] == 1)
            for i in range(k)]


def _dt_rank(d: int) -> int:
    return max(1, math.ceil(d / 16))


def _leaves(m, mixer: str, moe: bool):
    d, f = m["d_model"], m["d_ff"]
    one = ("ones",)
    out = [("ln1/norm_scale", (d,), one)]
    if mixer == "attn":
        h, kh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        out += [("attn/wq/w", (d, h * hd), uniform(d)),
                ("attn/wk/w", (d, kh * hd), uniform(d)),
                ("attn/wv/w", (d, kh * hd), uniform(d)),
                ("attn/wo/w", (h * hd, d), uniform(h * hd))]
    else:
        ds, din = m["mamba_d_state"], m["mamba_expand"] * d
        r = _dt_rank(d)
        out += [("mamba/in_proj/w", (d, 2 * din), uniform(d)),
                ("mamba/conv_w", (m["mamba_d_conv"], din), normal(0.1)),
                ("mamba/conv_bias", (din,), ("zeros",)),
                ("mamba/x_proj/w", (din, r + 2 * ds), uniform(din)),
                ("mamba/dt_proj/w", (r, din), uniform(r)),
                ("mamba/dt_proj/bias", (din,), ("zeros",)),
                ("mamba/a_log", (din, ds), ("log_arange",)),
                ("mamba/d_skip", (din,), one),
                ("mamba/out_proj/w", (din, d), uniform(din))]
    out.append(("ln2/norm_scale", (d,), one))
    if moe:
        e, fe = m["n_experts"], m["moe_d_ff"] or f
        out += [("moe/router/w", (d, e), normal(0.02)),
                ("moe/experts/gate", (e, d, fe), uniform(d)),
                ("moe/experts/up", (e, d, fe), uniform(d)),
                ("moe/experts/down", (e, fe, d), uniform(fe))]
    else:
        out += [("ffn/gate/w", (d, f), uniform(d)),
                ("ffn/up/w", (d, f), uniform(d)),
                ("ffn/down/w", (f, d), uniform(f))]
    return out


def stacks(m):
    """[(tree path, depth, leaves of one slice)]: one stack per index of
    a group, as deep as there are groups."""
    n = m["n_layers"] // m["attn_every"]
    return [(f"groups/b{i}", n, _leaves(m, mixer, moe))
            for i, (mixer, moe) in enumerate(layout(m))]


def top(m):
    d, v = m["d_model"], m["vocab"]
    return [("embed/table", (v, d), normal(1.0)),
            ("final_norm/norm_scale", (d,), ("ones",)),
            ("lm_head/w", (d, v), uniform(d))]


def _attention(w, a, m, act, decoded):
    b, t, _ = a.shape
    h, kh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    pos = torch.arange(t, device=a.device)
    q = common.linear(a, w["attn/wq/w"], act).view(b, t, h, hd)
    k = common.linear(a, w["attn/wk/w"], act).view(b, t, kh, hd)
    v = common.linear(a, w["attn/wv/w"], act).view(b, t, kh, hd)
    q = common.rope(q, pos, m["rope_theta"])
    k = common.rope(k, pos, m["rope_theta"])
    o = common.attend(q, k, v, 0, pick=decoded, k2=codecs.quantize_rows(k),
                      v2=codecs.quantize_rows(v))
    return common.linear(o.reshape(b, t, h * hd), w["attn/wo/w"], act)


def _mamba(w, a, m, act, stored):
    """``stored`` (B, T) bool: after token t the row's state is put on
    the posit8 grid (the prompt's last token and every decoded one)."""
    b, t, _ = a.shape
    ds = m["mamba_d_state"]
    r = _dt_rank(m["d_model"])
    xz = common.linear(a, w["mamba/in_proj/w"], act)
    xin_raw, z = torch.chunk(xz, 2, dim=-1)
    cw, cb = w["mamba/conv_w"], w["mamba/conv_bias"]
    kc = cw.shape[0]
    window = xin_raw.new_zeros((b, kc - 1, xin_raw.shape[-1]))
    conv = torch.empty_like(xin_raw)
    for i in range(t):
        full = torch.cat([window, xin_raw[:, i:i + 1]], 1)
        conv[:, i] = (full * cw[None]).sum(1) + cb
        window = full[:, 1:]
        window = torch.where(stored[:, i, None, None],
                             codecs.quantize_rows(window), window)
    xin = F.silu(conv)
    dbl = common.linear(xin, w["mamba/x_proj/w"], act)
    dt, bm, cm = torch.split(dbl, [r, ds, ds], dim=-1)
    dt = common.linear(dt, w["mamba/dt_proj/w"], act, w["mamba/dt_proj/bias"])
    dt = torch.logaddexp(dt, torch.zeros_like(dt))          # softplus
    a_mat = -torch.exp(w["mamba/a_log"])
    h = xin.new_zeros((b, xin.shape[-1], ds))
    y = torch.empty_like(xin)
    for i in range(t):
        h = torch.exp(dt[:, i, :, None] * a_mat) * h \
            + (dt[:, i] * xin[:, i])[..., None] * bm[:, i, None, :]
        y[:, i] = (h * cm[:, i, None, :]).sum(-1)
        h = torch.where(stored[:, i, None, None], codecs.quantize_rows(h), h)
    y = y + w["mamba/d_skip"] * xin
    return common.linear(y * F.silu(z), w["mamba/out_proj/w"], act)


def _ffn(w, a, act, pre="ffn/"):
    g = common.linear(a, w[f"{pre}gate/w"], act)
    u = common.linear(a, w[f"{pre}up/w"], act)
    return common.linear(F.silu(g) * u, w[f"{pre}down/w"], act)


def _moe(w, a, m, act):
    b, t, d = a.shape
    x = a.reshape(-1, d)
    probs = torch.softmax(common.linear(x, w["moe/router/w"], act), -1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = m["experts_per_tok"]
    top_p, top_i = srt.values[:, :k], srt.indices[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(m["n_experts"]):
        hit = (top_i == e)
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        xe = x[rows]
        if act is not None:
            xe = act(xe)
        g = xe @ w["moe/experts/gate"][e]
        u = xe @ w["moe/experts/up"][e]
        he = F.silu(g) * u
        if act is not None:
            he = act(he)
        ye = he @ w["moe/experts/down"][e]
        wt = (top_p[rows] * hit[rows]).sum(-1, keepdim=True)
        out[rows] += wt * ye
    return out.reshape(b, t, d)


@torch.no_grad()
def logits(m, seed: int, reqs: Sequence[Tuple[np.ndarray, np.ndarray]],
           device, policy: str = "paper_mixed",
           act: common.Act = None) -> List[torch.Tensor]:
    """Logits (n_i, V) that predict each request's served tokens (see
    ``llama.logits``)."""
    with common.no_tf32():
        seqs = [np.concatenate([p, s]).astype(np.int64) for p, s in reqs]
        plens = torch.as_tensor([len(p) for p, _ in reqs], device=device)
        toks = common.pad_batch(seqs, device)
        pos = torch.arange(toks.shape[1], device=device)
        decoded = pos[None, :] >= plens[:, None]
        stored = pos[None, :] >= plens[:, None] - 1
        t = common.top(seed, top(m), policy, device)
        x = t["embed/table"][toks]
        for g in range(m["n_layers"] // m["attn_every"]):
            for i, (mixer, moe) in enumerate(layout(m)):
                w = common.layer(seed, f"groups/b{i}", g,
                                 _leaves(m, mixer, moe), policy, device)
                a = common.rmsnorm(x, w["ln1/norm_scale"])
                x = x + (_attention(w, a, m, act, decoded) if mixer == "attn"
                         else _mamba(w, a, m, act, stored))
                a = common.rmsnorm(x, w["ln2/norm_scale"])
                x = x + (_moe(w, a, m, act) if moe else _ffn(w, a, act))
                del w
        rows = [torch.arange(int(pl) - 1, len(s) - 1, device=device)
                for pl, s in zip(plens.tolist(), seqs)]
        return common.readout(x, rows, t["final_norm/norm_scale"],
                              t["lm_head/w"], act)
