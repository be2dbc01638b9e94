"""Pieces the plain references share: weights fetched layer by layer,
RMSNorm, RoPE, causal attention in query blocks, the read-out, and the
lower-precision control's rounding of the products' inputs.

Everything computes in float32 with TF32 off; weights are the seeded
float32 draw put on their served format's grid (``codecs``)."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import codecs, weights

__all__ = ["no_tf32", "layer", "top", "bf16", "rmsnorm", "rope", "attend",
           "linear", "fp8_rows", "readout", "pad_batch"]

Act = Optional[Callable[[torch.Tensor], torch.Tensor]]

_NEG = -1e30
Q_BLOCK = 256


class no_tf32:
    """Full float32 products inside the block."""

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.prev
        return False


def _served(prefix: str, raw: Dict[str, torch.Tensor],
            policy: str) -> Dict[str, torch.Tensor]:
    for path in list(raw):
        fmt = codecs.weight_format(f"{prefix}{path}", policy)
        if fmt is not None:
            raw[path] = codecs.quantize_weight(fmt, raw[path])
    return raw


def layer(seed: int, stack: str, index: int, leaves, policy: str,
          device) -> Dict[str, torch.Tensor]:
    """Slice ``index`` of stack ``stack`` as served: drawn again from the
    seed, each matrix put on its format's grid."""
    raw = weights.draw(seed, f"{stack}/{index}", leaves, device)
    return _served(f"{stack}/", raw, policy)


def top(seed: int, leaves, policy: str, device) -> Dict[str, torch.Tensor]:
    """The top-level leaves as served: the embedding in bfloat16, the
    read-out head on its format's grid."""
    raw = weights.draw(seed, "top", leaves, device)
    if "embed/table" in raw:
        raw["embed/table"] = raw["embed/table"].to(torch.bfloat16).float()
    return _served("", raw, policy)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and held in float32: an activation in
    the precision a configuration states for it."""
    return x.to(torch.bfloat16).float()


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 under one power-of-two scale per row
    (the row's largest magnitude mapped under 448): the control's
    inputs to every product."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    s = torch.exp2(torch.ceil(torch.log2(amax / 448.0)))
    return (x / s).to(torch.float8_e4m3fn).float() * s


def linear(x: torch.Tensor, w: torch.Tensor, act: Act = None,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    if act is not None:
        x = act(x)
    y = x @ w
    return y if bias is None else y + bias


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
         rnd: Act = None) -> torch.Tensor:
    """x (B, T, H, Dh) rotated by positions ``pos`` (T,): halves
    rotated as pairs (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin).
    With ``rnd`` (an activation precision) the cosines, the sines and
    each product and sum are rounded by it, as arithmetic in that
    precision rounds them."""
    r = rnd if rnd is not None else (lambda t: t)
    dh = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                          device=x.device) / dh))
    ang = pos.float()[:, None] * freqs
    cos = r(torch.cos(ang)[None, :, None])
    sin = r(torch.sin(ang)[None, :, None])
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([r(r(x1 * cos) - r(x2 * sin)),
                      r(r(x2 * cos) + r(x1 * sin))], -1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_start: int, pick: Optional[torch.Tensor] = None,
           k2: Optional[torch.Tensor] = None,
           v2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal GQA attention.  q (B, Tq, H, Dh) at positions q_start.. ;
    k, v (B, Tk, Kh, Dh) at positions 0..Tk-1.  With ``pick`` (B, Tq)
    bool, the queries where it is True attend to ``k2``/``v2`` in place
    of ``k``/``v``.  Returns (B, Tq, H, Dh); queries run in blocks."""
    b, tq, h, dh = q.shape
    kh = k.shape[2]
    q5 = q.reshape(b, tq, kh, h // kh, dh)
    kpos = torch.arange(k.shape[1], device=q.device)
    out = torch.empty_like(q5)
    scale = 1.0 / math.sqrt(dh)

    def block(qb, kk, vv, qpos):
        s = torch.einsum("bqkgd,btkd->bkgqt", qb, kk) * scale
        s = torch.where(kpos[None, :] <= qpos[:, None], s, _NEG)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bkgqt,btkd->bqkgd", p, vv)

    for i in range(0, tq, Q_BLOCK):
        qb = q5[:, i:i + Q_BLOCK]
        qpos = q_start + i + torch.arange(qb.shape[1], device=q.device)
        o = block(qb, k, v, qpos)
        if pick is not None:
            o2 = block(qb, k2, v2, qpos)
            o = torch.where(pick[:, i:i + Q_BLOCK, None, None, None], o2, o)
        out[:, i:i + Q_BLOCK] = o
    return out.reshape(b, tq, h, dh)


def readout(x: torch.Tensor, rows: List[torch.Tensor], norm: torch.Tensor,
            head: torch.Tensor, act: Act = None,
            rnd: Act = None) -> List[torch.Tensor]:
    """Logits (n_i, V) at each request's rows of ``x`` (B, T, D); with
    ``rnd`` the final norm's output rounded by it.  Under a lower
    precision's ``act`` (the control) the read-out's input goes through
    it, and its logits come out in bfloat16, as the program's read-out
    writes them."""
    r = rnd if rnd is not None else (lambda t: t)
    out = [linear(r(rmsnorm(x[b, i], norm)), head, act)
           for b, i in enumerate(rows)]
    return out if act is None else [lg.to(torch.bfloat16).float()
                                    for lg in out]


def pad_batch(seqs: Sequence[np.ndarray], device) -> torch.Tensor:
    """(B, T) int64 of the sequences, padded at the end with token 0
    (causal attention never lets a real position see a pad)."""
    t = max(len(s) for s in seqs)
    out = np.zeros((len(seqs), t), np.int64)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return torch.as_tensor(out, device=device)
