"""Dense decoder LM (the counterpart of ``repro.models.transformer``, dense
family).

Layer parameters are stacked ``(L, ...)`` leaves under ``params["layers"]``
like the reference's scan layout, so ``PrecisionPolicy`` globs and the
packed plane see the same tree; the forward walks the layers with a
Python loop over slices in place of ``lax.scan``, and a paged cache's
page table and positions go to every layer as they are.  Other
families raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..core.formats import torch_dtype
from ..kernels.ops import PackedTensor
from . import attention as A
from . import layers as L

__all__ = ["lm_init", "lm_apply", "lm_decode", "init_cache"]


def _check_family(cfg) -> None:
    if cfg.family != "dense" or cfg.frontend != "none" \
            or cfg.rope_kind != "default":
        raise NotImplementedError(
            f"the port serves dense text decoders with default RoPE so far; "
            f"{cfg.name} is family={cfg.family!r}, frontend={cfg.frontend!r},"
            f" rope_kind={cfg.rope_kind!r}")


def lm_init(cfg, generator: Optional[torch.Generator] = None, device=None):
    """Random parameters; ``generator`` (seeded, on the target device)
    decides the device, else a generator seeded 0 on ``device``."""
    _check_family(cfg)
    if generator is None:
        generator = torch.Generator(resolve_device(device)).manual_seed(0)
    dev = generator.device
    d, n = cfg.d_model, cfg.n_layers
    p: Dict[str, Any] = {
        "embed": L.embed_init(generator, cfg.vocab, d),
        "layers": {
            "ln1": L.rmsnorm_init(d, (n,), dev),
            "attn": A.attn_init(generator, cfg, (n,)),
            "ln2": L.rmsnorm_init(d, (n,), dev),
            "ffn": L.ffn_init(generator, d, cfg.d_ff, cfg.ffn_kind,
                              cfg.out_bias, (n,)),
        },
        "final_norm": L.rmsnorm_init(d, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, d, cfg.vocab)
    return p


def _layer(tree, i: int):
    """Slice ``i`` of every stacked leaf (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _n_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0] if not isinstance(tree, PackedTensor) \
        else tree.words.shape[0]


def _readout(p, x):
    x = L.rmsnorm(p["final_norm"], x)
    if "lm_head" in p:
        return L.dense(p["lm_head"], x)
    return L.embed_logits(p["embed"], x)


def _pop_paged_meta(cache):
    """Split a paged cache into (pool leaves, meta).  The paged serving
    cache carries ONE ``page_table`` (B, NP) (and, for decode,
    ``positions`` (B,)) at the top level, beside the L-stacked pool
    leaves; it has no layer axis, so the layer loop hands the same
    tensors to every layer instead of slicing them."""
    if not (isinstance(cache, dict) and "page_table" in cache):
        return cache, None
    meta = {k: cache[k] for k in ("page_table", "positions") if k in cache}
    return {k: v for k, v in cache.items() if k not in meta}, meta


def _layer_cache(cache, i: int, meta):
    lc = _layer(cache, i)
    return lc if meta is None else dict(lc, **meta)


def lm_apply(p, batch, cfg, last_only: bool = False, mode: str = "prefill",
             cache=None):
    """Full-sequence forward.  Returns (logits, cache).

    ``mode="prefill"``: the cache is ``{"k", "v"}`` stacked
    (L, B, S, Kh, Dh) bf16.  ``mode="prefill_chunk"``: one chunk at
    ``batch["positions"]`` attends to ``cache`` -- a bf16 carry
    ``{"k", "v"}`` (L, B, T, Kh, Dh), returning the chunk's own stacked
    kv, or a paged pool with its ``page_table``, written in place and
    returned.  ``last_only`` reads out the final position only (the one
    generation needs).  ``batch``: ``tokens`` (B, S), optional
    ``positions`` (B, S) and ``kv_mask`` (B, S) bool for left-padded
    ragged batches."""
    _check_family(cfg)
    if mode not in ("prefill", "prefill_chunk"):
        raise ValueError(f"lm_apply mode {mode!r}: prefill or prefill_chunk")
    dtype = torch_dtype(cfg.dtype)
    tokens = batch["tokens"]
    x = L.embed(p["embed"], tokens, dtype)
    positions = batch.get("positions")
    kv_mask = batch.get("kv_mask")
    cache, meta = _pop_paged_meta(cache)
    ks, vs = [], []
    for i in range(_n_layers(p["layers"])):
        lp = _layer(p["layers"], i)
        h = L.rmsnorm(lp["ln1"], x)
        if mode == "prefill_chunk":
            h, kv = A.attn_prefill_chunk(lp["attn"], h, cfg, positions,
                                         _layer_cache(cache, i, meta))
        else:
            h, (k, v) = A.attn_apply(lp["attn"], h, cfg, positions, kv_mask)
            kv = {"k": k, "v": v}
        x = x + h
        x = x + L.ffn(lp["ffn"], L.rmsnorm(lp["ln2"], x), cfg.ffn_kind)
        if kv is not None:
            ks.append(kv["k"].to(torch.bfloat16))
            vs.append(kv["v"].to(torch.bfloat16))
    if last_only:
        x = x[:, -1:]
    if meta is not None:
        return _readout(p, x), dict(cache, **meta)
    return _readout(p, x), {"k": torch.stack(ks), "v": torch.stack(vs)}


def lm_decode(p, tokens, cfg, cache, pos: int, pad=None):
    """One decode step: tokens (B, 1) -> logits (B, 1, V).  ``cache`` is
    updated in place (slot ``pos`` of every layer) and returned.  A
    PAGED cache (pool leaves plus a top-level ``page_table`` and
    ``positions``) decodes each request at its own position; ``pos`` is
    then ignored."""
    _check_family(cfg)
    x = L.embed(p["embed"], tokens, torch_dtype(cfg.dtype))
    layers, meta = _pop_paged_meta(cache)
    for i in range(_n_layers(p["layers"])):
        lp = _layer(p["layers"], i)
        x = x + A.attn_decode(lp["attn"], L.rmsnorm(lp["ln1"], x), cfg,
                              _layer_cache(layers, i, meta), pos, pad)
        x = x + L.ffn(lp["ffn"], L.rmsnorm(lp["ln2"], x), cfg.ffn_kind)
    return _readout(p, x), cache


def _one_kv(cfg, batch: int, max_len: int, quantized: bool,
            kv_group: Optional[int], device):
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    if quantized:
        gs = A.kv_scale_cols(hd, kv_group)
        sshape = shape[:-1] + (gs,)
        return {"k_codes": torch.zeros(shape, dtype=torch.uint8, device=device),
                "v_codes": torch.zeros(shape, dtype=torch.uint8, device=device),
                "k_scale": torch.ones(sshape, dtype=torch.bfloat16,
                                      device=device),
                "v_scale": torch.ones(sshape, dtype=torch.bfloat16,
                                      device=device)}
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def init_cache(cfg, batch: int, max_len: int, quantized_kv: bool = False,
               kv_group: Optional[int] = None, device=None):
    """Empty stacked (L, B, T, Kh, ...) cache: bf16 k/v, or posit8 codes
    with bf16 scales initialised to 1.0."""
    _check_family(cfg)
    return _one_kv(cfg, batch, max_len, quantized_kv, kv_group,
                   resolve_device(device))
