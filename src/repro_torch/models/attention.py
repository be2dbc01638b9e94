"""GQA attention: prefill over a full sequence, chunk prefill, and
one-token decode over a contiguous or paged KV cache (the counterpart of
``repro.models.attention``, dense serving path).

Prefill is plain torch: one causal softmax block when the sequence fits
``cfg.seq_chunk`` (or does not divide into chunks), else an online
softmax over KV chunks -- the reference's two paths with its dtypes.
The KV cache is bf16 or posit8 codes with bf16 po2 scales grouped along
Dh.  Quantized attention goes through ``kernels.flash_decode``, whose
wrappers launch the CUDA kernels on a CUDA cache and run their plain
blocked loops on a CPU cache: ``flash_decode`` for a contiguous cache,
``paged_flash_decode`` / ``paged_flash_prefill`` for the paged pool of
continuous serving.  Decode and paged chunk prefill write the new
tokens' codes into the cache or pool in place (the reference returns an
updated copy); the caller owns the cache.  The paged pool's write is
``kernels.kv_write.paged_kv_write``: one CUDA launch for K and V on the
card, ``quantize_kv`` and index writes on the CPU.

The serving sub-blocks (``attn_decode``, ``attn_prefill_chunk``) take
the residual stream with the block's pre-norm and return the stream
with their output added, so that each stage is one ``obs.host_span``:
``fwd.attn_in`` (pre-norm, q/k/v, RoPE), ``fwd.kv_write``, ``fwd.attn``
and ``fwd.attn_out`` (output projection and residual add).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_decode import (flash_decode, flash_decode_plain,
                                    paged_flash_decode,
                                    paged_flash_prefill)
from ..kernels.kv_write import paged_kv_write
from ..kernels.ref import dequant_kv_ref, quantize_kv
from ..obs import host_span
from . import layers as L

__all__ = ["attn_init", "attn_apply", "attn_decode", "attn_prefill_chunk",
           "dequantize_kv", "decode_quantized_blocks"]

_NEG = -1e30


def attn_init(gen: torch.Generator, cfg, lead=()):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": L.dense_init(gen, d, cfg.n_heads * hd, bias=cfg.qkv_bias,
                           lead=lead),
        "wk": L.dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                           lead=lead),
        "wv": L.dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                           lead=lead),
        "wo": L.dense_init(gen, cfg.n_heads * hd, d, lead=lead),
    }


def _qkv(p, x, cfg, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = L.dense(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = L.dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = L.dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
    rotate = L.mrope if cfg.rope_kind == "mrope" else L.rope
    return (rotate(q, positions, cfg.rope_theta),
            rotate(k, positions, cfg.rope_theta), v)


def _attend_block(q5, k, v, bias):
    """Full softmax attention on one block; q5 (B, Sq, Kh, G, Dh).  Scores
    and softmax in f32, probabilities back in the activation dtype."""
    s = torch.einsum("bqkgd,btkd->bkgqt", q5.float(), k.float())
    s = s * (1.0 / math.sqrt(q5.shape[-1])) + bias
    p = torch.softmax(s, dim=-1).to(q5.dtype)
    return torch.einsum("bkgqt,btkd->bqkgd", p.float(),
                        v.float()).to(q5.dtype)


def _causal_bias(sq: int, skv: int, q_offset: int, device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    return torch.where(kpos <= qpos, 0.0, _NEG)[None, None, None]


def _flash_scan(q5, k, v, c: int, kv_mask=None):
    """Online softmax over KV chunks of ``c`` slots; the accumulator stays
    in the activation dtype, as in the reference's scan."""
    b, s, kh, g, hd = q5.shape
    n = s // c
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(s, device=q5.device)
    acc = torch.zeros((b, kh, g, s, hd), dtype=q5.dtype, device=q5.device)
    m = torch.full((b, kh, g, s), -math.inf, device=q5.device)
    l = torch.zeros((b, kh, g, s), device=q5.device)
    for idx in range(n):
        kc, vc = k[:, idx * c:(idx + 1) * c], v[:, idx * c:(idx + 1) * c]
        sc = torch.einsum("bqkgd,btkd->bkgqt", q5.float(), kc.float()) * scale
        kpos = idx * c + torch.arange(c, device=q5.device)
        mask = (kpos[None, :] <= qpos[:, None])[None, None, None]
        if kv_mask is not None:
            mask = mask & kv_mask[:, idx * c:(idx + 1) * c][:, None, None,
                                                             None, :]
        sc = torch.where(mask, sc, _NEG)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(q5.dtype).float(),
                          vc.float()).to(q5.dtype)
        acc = acc * alpha[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / l[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4)                  # (B, S, Kh, G, Dh)


def attn_apply(p, x, cfg, positions=None, kv_mask=None):
    """Causal self-attention over a full sequence (prefill).  Returns
    (out, (k, v)).  ``kv_mask`` (B, S) bool marks real tokens of a
    left-padded batch; keys at False slots are masked out."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
        if cfg.rope_kind == "mrope":
            positions = positions.expand(3, b, s)
    q, k, v = _qkv(p, x, cfg, positions)
    g = cfg.n_heads // cfg.n_kv_heads
    q5 = q.reshape(b, s, cfg.n_kv_heads, g, q.shape[-1])
    c = min(cfg.seq_chunk, s)
    n_chunks = s // c if s % c == 0 else 1
    if n_chunks <= 1:
        bias = _causal_bias(s, s, 0, x.device)
        if kv_mask is not None:
            bias = bias + torch.where(kv_mask, 0.0,
                                      _NEG)[:, None, None, None, :]
        out = _attend_block(q5, k, v, bias)
    else:
        out = _flash_scan(q5, k, v, c, kv_mask)
    out = out.reshape(b, s, cfg.n_heads * q.shape[-1])
    return L.dense(p["wo"], out), (k, v)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """codes (..., Dh) + scales (..., Gs) -> (..., Dh) in ``dtype``."""
    return dequant_kv_ref(codes, scale).to(dtype)


def _cache_group(layer_cache) -> Optional[int]:
    gs = layer_cache["k_scale"].shape[-1]
    return None if gs == 1 else layer_cache["k_codes"].shape[-1] // gs


def _cache_write(layer_cache, k_new, v_new, pos: int) -> None:
    """Write one token's k/v (B, 1, Kh, Dh) at slot ``pos``, in place."""
    if "k" in layer_cache:
        layer_cache["k"][:, pos] = k_new[:, 0].to(layer_cache["k"].dtype)
        layer_cache["v"][:, pos] = v_new[:, 0].to(layer_cache["v"].dtype)
        return
    group = _cache_group(layer_cache)
    for name, new in (("k", k_new), ("v", v_new)):
        codes, scale = quantize_kv(new, group)
        layer_cache[f"{name}_codes"][:, pos] = codes[:, 0]
        layer_cache[f"{name}_scale"][:, pos] = scale[:, 0]


def decode_quantized_blocks(q4, layer_cache, pos: int, softcap: float = 0.0,
                            blk: Optional[int] = None, pad=None):
    """Length-aware decode over a posit8 cache in plain torch: the online
    softmax over ceil((pos+1)/blk) KV blocks that the flash-decode
    kernel's CPU path runs (``kernels.flash_decode.flash_decode_plain``).
    q4 (B, Kh, G, Dh) -> (B, Kh, G, Dh) f32."""
    return flash_decode_plain(q4, layer_cache["k_codes"],
                              layer_cache["k_scale"], layer_cache["v_codes"],
                              layer_cache["v_scale"], pos, pad, softcap, blk)


def _pool_write(pool, k, v, page_table, positions=None, start=None) -> None:
    """Quantize k/v and write their codes and scales into the pool leaves
    through ``page_table``, in place: a decode step's (B, Kh, Dh) rows at
    ``positions`` or a chunk's (B, C, Kh, Dh) rows from ``start``
    (``kernels.kv_write.paged_kv_write``).  The one name both paged
    paths write through: ``bench/tests`` patch it to plant a lost write."""
    paged_kv_write(pool, k, v, page_table, positions=positions, start=start)


def attn_prefill_chunk(p, ln1, x, cfg, positions, ctx):
    """Causal self-attention sub-block of ONE prefill chunk; x (B, C, D)
    the residual stream at absolute ``positions`` (B, C), normed by
    ``ln1`` first.  ``ctx`` is what the chunk attends to besides itself:

      * CARRY ``{"k", "v"}`` (B, T, Kh, Dh) bf16: the already-prefilled
        prefix, possibly preallocated past ``start`` (dead slots are
        masked).  Returns (x + out, {"k", "v"}) with the chunk's own
        bf16 kv.
      * PAGED (the dict carries ``page_table``): the pool leaves and
        (B, NP) page table.  The chunk's kv is quantized and written into
        its pages first, in place, then attention reads prefix + chunk
        back through the page table.  Returns (x + out, None).
    """
    if "page_table" in ctx:
        return _attn_prefill_paged(p, ln1, x, cfg, positions, ctx), None
    b, c, _ = x.shape
    with host_span("fwd.attn_in"):
        h = L.rmsnorm(ln1, x)
        q, k, v = _qkv(p, h, cfg, positions)
    with host_span("fwd.attn"):
        g = cfg.n_heads // cfg.n_kv_heads
        hd = q.shape[-1]
        q5 = q.reshape(b, c, cfg.n_kv_heads, g, hd)
        t = ctx["k"].shape[1]
        kk = torch.cat([ctx["k"].to(k.dtype), k], dim=1) if t else k
        vv = torch.cat([ctx["v"].to(v.dtype), v], dim=1) if t else v
        bias = _causal_bias(c, t + c, t, x.device)
        if t:
            # slots of a preallocated carry at or past the chunk's start
            # hold no context yet; live slots add exactly 0.0
            kidx = torch.arange(t + c, device=x.device)
            ctx_live = (kidx[None] < positions[:, :1]) | (kidx[None] >= t)
            bias = bias + torch.where(ctx_live, 0.0,
                                      _NEG)[:, None, None, None, :]
        out = _attend_block(q5, kk, vv, bias).reshape(b, c, cfg.n_heads * hd)
    with host_span("fwd.attn_out"):
        x = x + L.dense(p["wo"], out)
    return x, {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}


def _attn_prefill_paged(p, ln1, x, cfg, positions, ctx):
    """Paged chunk prefill: write the chunk's kv into its pages
    (page-aligned chunk slots), then attend to prefix + chunk through
    the page table; returns x + the attention output."""
    b, c, _ = x.shape
    with host_span("fwd.attn_in"):
        h = L.rmsnorm(ln1, x)
        q, k, v = _qkv(p, h, cfg, positions)
    with host_span("fwd.kv_write"):
        page_table = ctx["page_table"]
        start = positions[:, 0].to(torch.int32).contiguous()
        _pool_write(ctx, k, v, page_table, start=start)
    with host_span("fwd.attn"):
        kh, hd = cfg.n_kv_heads, q.shape[-1]
        q5 = q.reshape(b, c, kh, cfg.n_heads // kh, hd)
        out5 = paged_flash_prefill(q5, ctx["k_codes"], ctx["k_scale"],
                                   ctx["v_codes"], ctx["v_scale"],
                                   page_table, start,
                                   softcap=cfg.attn_logit_softcap)
    with host_span("fwd.attn_out"):
        return x + L.dense(p["wo"], out5.to(h.dtype).reshape(
            b, c, cfg.n_heads * hd))


def _attn_decode_paged(p, ln1, x, cfg, layer_cache):
    """Paged one-token decode: each request writes and reads posit8 pages
    through its page-table row at its OWN position (``page_table``
    (B, NP) and ``positions`` (B,) ride in the layer cache).  The new
    token's codes land at pool slot ``(page_table[b, pos_b // page],
    pos_b % page)``, in place; attention runs over the live pages.
    Returns x + the attention output."""
    b = x.shape[0]
    page_table = layer_cache["page_table"]
    positions = layer_cache["positions"]
    with host_span("fwd.attn_in"):
        h = L.rmsnorm(ln1, x)
        pos2 = positions[:, None]
        if cfg.rope_kind == "mrope":
            # text continuation: the t/h/w streams all advance with the
            # 1-D position, as on the contiguous decode path
            pos2 = pos2.expand(3, b, 1)
        q, k_new, v_new = _qkv(p, h, cfg, pos2)
    with host_span("fwd.kv_write"):
        _pool_write(layer_cache, k_new[:, 0], v_new[:, 0], page_table,
                    positions=positions)
    with host_span("fwd.attn"):
        g = cfg.n_heads // cfg.n_kv_heads
        hd = q.shape[-1]
        out4 = paged_flash_decode(q.reshape(b, cfg.n_kv_heads, g, hd),
                                  layer_cache["k_codes"],
                                  layer_cache["k_scale"],
                                  layer_cache["v_codes"],
                                  layer_cache["v_scale"], page_table,
                                  positions, softcap=cfg.attn_logit_softcap)
    with host_span("fwd.attn_out"):
        return x + L.dense(p["wo"], out4.to(h.dtype).reshape(
            b, 1, cfg.n_heads * hd))


def attn_decode(p, ln1, x, cfg, layer_cache, pos: int, pad=None):
    """One-token decode sub-block; x (B, 1, D) the residual stream,
    normed by ``ln1`` first, ``pos`` the slot being written.  Updates
    ``layer_cache`` in place and returns x + the attention output.
    ``pad`` (B,) int32: left-pad widths of a ragged batch -- RoPE
    positions shift to ``pos - pad[b]`` and slots below ``pad[b]`` are
    masked.  A PAGED layer cache (it carries ``page_table`` and
    ``positions``) decodes every request at its own position and
    ignores ``pos``."""
    if "page_table" in layer_cache:
        return _attn_decode_paged(p, ln1, x, cfg, layer_cache)
    b = x.shape[0]
    with host_span("fwd.attn_in"):
        h = L.rmsnorm(ln1, x)
        if pad is None:
            positions = torch.full((b, 1), pos, dtype=torch.int32,
                                   device=x.device)
        else:
            positions = (pos - pad).to(torch.int32)[:, None]
        if cfg.rope_kind == "mrope":
            positions = positions.expand(3, b, 1)
        q, k_new, v_new = _qkv(p, h, cfg, positions)
    with host_span("fwd.kv_write"):
        _cache_write(layer_cache, k_new, v_new, pos)
    g = cfg.n_heads // cfg.n_kv_heads
    hd = q.shape[-1]
    with host_span("fwd.attn"):
        if "k" not in layer_cache:
            q4 = q.reshape(b, cfg.n_kv_heads, g, hd)
            out = flash_decode(q4, layer_cache["k_codes"],
                               layer_cache["k_scale"],
                               layer_cache["v_codes"],
                               layer_cache["v_scale"], pos, pad=pad,
                               softcap=cfg.attn_logit_softcap).to(h.dtype)
        else:
            k, v = layer_cache["k"], layer_cache["v"]
            q5 = q.reshape(b, 1, cfg.n_kv_heads, g, hd)
            s = torch.einsum("bqkgd,btkd->bkgqt", q5.float(), k.float())
            s = s * (1.0 / math.sqrt(hd))
            if cfg.attn_logit_softcap > 0.0:
                s = torch.tanh(s / cfg.attn_logit_softcap) \
                    * cfg.attn_logit_softcap
            tpos = torch.arange(k.shape[1], device=x.device)
            live = tpos[None, None, None, None, :] <= pos
            if pad is not None:
                live = live & (tpos[None, None, None, None, :] >=
                               pad[:, None, None, None, None])
            s = torch.where(live, s, _NEG)
            pw = torch.softmax(s, dim=-1).to(h.dtype)
            out = torch.einsum("bkgqt,btkd->bqkgd", pw.float(),
                               v.float()).to(h.dtype)
    with host_span("fwd.attn_out"):
        return x + L.dense(p["wo"], out.reshape(b, 1, cfg.n_heads * hd))
