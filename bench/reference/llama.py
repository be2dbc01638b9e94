"""Plain reference of a dense llama-architecture decoder (deepseek-67b)
as its configuration serves it.

Pre-norm blocks: RMSNorm, grouped-query attention with RoPE over a
posit8 KV cache, RMSNorm, a SwiGLU feed-forward; a final RMSNorm and an
untied read-out.  Weights are the seeded draw on the paper's mixed
formats (``codecs``), the embedding in bfloat16.  Every key and value
is read back through the posit8 cache format, prompt and decoded
positions alike: with the prefix cache on, a served prompt's chunks
attend to their own and the shared prefix's pages.  Activations are in
bfloat16, as the configuration states: the residual stream, each norm's
and projection's output, RoPE's arithmetic, the attention output and
the SwiGLU product are rounded to it where the served model holds them;
every product and sum inside a matrix product, the attention and a norm
runs in float32.

A leading run of tokens common to every sequence (the shared system
preamble) is computed once and its keys and values shared.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import codecs, common
from .weights import normal, uniform

__all__ = ["stacks", "top", "logits"]


def _leaves(m):
    d, h, kh = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd, f = m["head_dim"], m["d_ff"]
    one = ("ones",)
    return [("ln1/norm_scale", (d,), one),
            ("attn/wq/w", (d, h * hd), uniform(d)),
            ("attn/wk/w", (d, kh * hd), uniform(d)),
            ("attn/wv/w", (d, kh * hd), uniform(d)),
            ("attn/wo/w", (h * hd, d), uniform(h * hd)),
            ("ln2/norm_scale", (d,), one),
            ("ffn/gate/w", (d, f), uniform(d)),
            ("ffn/up/w", (d, f), uniform(d)),
            ("ffn/down/w", (f, d), uniform(f))]


def stacks(m):
    """[(tree path, depth, leaves of one slice)]."""
    return [("layers", m["n_layers"], _leaves(m))]


def top(m):
    d, v = m["d_model"], m["vocab"]
    return [("embed/table", (v, d), normal(1.0)),
            ("final_norm/norm_scale", (d,), ("ones",)),
            ("lm_head/w", (d, v), uniform(d))]


def _common_prefix(seqs: Sequence[np.ndarray], limit: int) -> int:
    n = min(min(len(s) for s in seqs), limit)
    first = seqs[0][:n]
    for s in seqs[1:]:
        diff = np.nonzero(s[:n] != first)[0]
        n = int(diff[0]) if diff.size else n
        first = first[:n]
    return n


def _block(w, x, pos, m, act, kv_prefix=None):
    """One block over x (B, T, D) at positions ``pos``; ``kv_prefix``:
    the shared prefix's cached (k, v) the rows also attend to.  Returns
    (x, (k, v)) with k, v on the cache's grid."""
    b, t, _ = x.shape
    h, kh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    r = common.bf16

    def proj(a, name):
        return r(common.linear(a, w[name], act))

    a = r(common.rmsnorm(x, w["ln1/norm_scale"]))
    q = proj(a, "attn/wq/w").view(b, t, h, hd)
    k = proj(a, "attn/wk/w").view(b, t, kh, hd)
    v = proj(a, "attn/wv/w").view(b, t, kh, hd)
    q = common.rope(q, pos, m["rope_theta"], r)
    k = codecs.quantize_rows(common.rope(k, pos, m["rope_theta"], r))
    v = codecs.quantize_rows(v)
    kk, vv = k, v
    if kv_prefix is not None:
        pk, pv = kv_prefix
        kk = torch.cat([pk.expand(b, -1, -1, -1), k], 1)
        vv = torch.cat([pv.expand(b, -1, -1, -1), v], 1)
    o = r(common.attend(q, kk, vv, int(pos[0]))).reshape(b, t, h * hd)
    x = r(x + proj(o, "attn/wo/w"))
    a = r(common.rmsnorm(x, w["ln2/norm_scale"]))
    g = r(torch.nn.functional.silu(proj(a, "ffn/gate/w")))
    x = r(x + proj(r(g * proj(a, "ffn/up/w")), "ffn/down/w"))
    return x, (k, v)


@torch.no_grad()
def logits(m, seed: int, reqs: Sequence[Tuple[np.ndarray, np.ndarray]],
           device, policy: str = "paper_mixed",
           act: common.Act = None) -> List[torch.Tensor]:
    """Logits (n_i, V) that predict each request's served tokens: one
    row per served token, from the positions prompt_len - 1 ..
    prompt_len + n_i - 2 of prompt + served."""
    with common.no_tf32():
        seqs = [np.concatenate([p, s]).astype(np.int64) for p, s in reqs]
        plens = [len(p) for p, _ in reqs]
        shared = _common_prefix(seqs, min(plens) - 1)
        t = common.top(seed, top(m), policy, device)
        emb = t["embed/table"]
        rest = common.pad_batch([s[shared:] for s in seqs], device)
        xr = emb[rest]
        pos_r = shared + torch.arange(rest.shape[1], device=device)
        xp = None
        if shared:
            pre = torch.as_tensor(seqs[0][:shared], device=device)
            xp = emb[pre][None]
            pos_p = torch.arange(shared, device=device)
        leaves = _leaves(m)
        for i in range(m["n_layers"]):
            w = common.layer(seed, "layers", i, leaves, policy, device)
            kv = None
            if xp is not None:
                xp, kv = _block(w, xp, pos_p, m, act)
            xr, _ = _block(w, xr, pos_r, m, act, kv)
            del w
        rows = [torch.arange(pl - 1 - shared, len(s) - 1 - shared,
                             device=device) for pl, s in zip(plens, seqs)]
        return common.readout(xr, rows, t["final_norm/norm_scale"],
                              t["lm_head/w"], act, common.bf16)
