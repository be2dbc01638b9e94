"""Stand-ins for every model input, with no data (the counterpart of
``repro.launch.specs``).

Each function returns tensors of the shapes and dtypes the step it feeds
takes, on ``device`` (default ``"meta"``: shapes only, nothing
allocated).  The dry run (``launch/dryrun.py``) calls them under
``FakeTensorMode`` with ``device="cpu"``, so the step runs on fake
tensors.  The leaves equal the reference's ``ShapeDtypeStruct``s in
shape and dtype.  Audio/vision frontends are stubs as in the reference:
the specs carry precomputed frame/patch embeddings.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import transformer as T

__all__ = ["batch_specs", "cache_specs", "paged_cache_specs",
           "chunk_prefill_specs", "handoff_specs", "input_specs"]


def _sds(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def batch_specs(cfg: ModelConfig, b: int, s: int, with_labels: bool = True,
                device="meta") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if cfg.frontend == "audio":
        out["frame_embeds"] = _sds((b, s, cfg.d_model), torch.bfloat16,
                                   device)
    else:
        out["tokens"] = _sds((b, s), torch.int32, device)
        if cfg.frontend == "vision":
            out["patch_embeds"] = _sds((b, cfg.n_patches, cfg.d_model),
                                       torch.bfloat16, device)
    if with_labels:
        out["labels"] = _sds((b, s), torch.int32, device)
    return out


def cache_specs(cfg: ModelConfig, b: int, max_len: int,
                quantized_kv: bool = False, kv_group=None, device="meta"):
    return T.init_cache(cfg, b, max_len, quantized_kv, kv_group,
                        device=device)


def paged_cache_specs(cfg: ModelConfig, b: int, max_len: int,
                      pool_frac: float = 0.25, kv_group=None,
                      page_size=None, device="meta") -> Dict[str, Any]:
    """The paged decode cache: pool leaves + routing tables.

    The page kinds come from the config's layer mix
    (``PagedKVPool.page_kinds``, which rejects an unknown family with the
    supported list).  Attention-bearing families get the KV pool pages
    plus ``page_table (B, NP)``; the pool holds ``pool_frac`` of the
    worst-case ``b * max_len`` token capacity while the page table spans
    the full ``max_len`` per request.  Recurrent families get the
    quantized state-slab plane (``b`` slabs) plus ``slab_table (B,)``;
    hybrids carry both.  The tables and ``positions (B,)`` sit at the
    top level, as ``ContinuousEngine``'s decode loop takes them."""
    from ..kernels.flash_decode import default_kv_block
    from ..serve.paged_kv import PagedKVPool
    kinds = PagedKVPool.page_kinds(cfg)
    psize = page_size or default_kv_block(max_len)
    if max_len % psize:
        raise ValueError(
            f"page_size {psize} must divide max_len {max_len}; the "
            f"page table would truncate the last {max_len % psize} "
            f"tokens")
    npp = max_len // psize
    n_pages = max(int(pool_frac * b * npp), npp)
    specs = PagedKVPool(cfg, n_pages, psize, kv_group,
                        n_slabs=b if "state" in kinds else 0,
                        device=device).device_state()
    if "kv" in kinds:
        specs["page_table"] = _sds((b, npp), torch.int32, device)
    if "state" in kinds:
        specs["slab_table"] = _sds((b,), torch.int32, device)
    specs["positions"] = _sds((b,), torch.int32, device)
    return specs


def chunk_prefill_specs(cfg: ModelConfig, chunk: int, ctx_len: int,
                        device="meta") -> Dict[str, Any]:
    """Inputs of ``serve.engine.build_prefill_chunk_step`` (carry form):
    ONE chunk of ``chunk`` tokens attending to a ``ctx_len``-token bf16
    KV carry of the already-prefilled prefix.  With ``ctx_len = S -
    chunk`` this is the LAST chunk of an S-token prompt, the largest step
    chunked prefill ever pays."""
    hd = cfg.resolved_head_dim
    kv = (cfg.n_layers, 1, ctx_len, cfg.n_kv_heads, hd)
    return {
        "tokens": _sds((1, chunk), torch.int32, device),
        "ctx": {"k": _sds(kv, torch.bfloat16, device),
                "v": _sds(kv, torch.bfloat16, device)},
        "start": _sds((1,), torch.int32, device),
    }


def handoff_specs(cfg: ModelConfig, n_pages: int, page_size: int,
                  kv_group=None, device="meta") -> Dict[str, Any]:
    """The page-handoff payload of disaggregated serving
    (``serve.disagg.PageHandoffChannel``): the ``n_pages`` exported pages
    of ONE completed prefill in pool wire format -- posit8 codes
    ``(La, n, page, Kh, Dh)`` uint8 + po2 group scales
    ``(La, n, page, Kh, Gs)`` bf16, ``La`` the attention layers only.
    Their summed bytes are exactly ``n_pages *
    paged_kv.page_handoff_bytes(cfg, page_size, kv_group)``."""
    from ..kernels.ref import kv_scale_cols
    from ..serve.paged_kv import PagedKVPool
    PagedKVPool.page_kinds(cfg)
    hd = cfg.resolved_head_dim
    gs = kv_scale_cols(hd, kv_group)
    code = (cfg.n_attn_layers, n_pages, page_size, cfg.n_kv_heads, hd)
    scale = code[:-1] + (gs,)
    return {"k_codes": _sds(code, torch.uint8, device),
            "v_codes": _sds(code, torch.uint8, device),
            "k_scale": _sds(scale, torch.bfloat16, device),
            "v_scale": _sds(scale, torch.bfloat16, device)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                quantized_kv: bool = False, device="meta") -> Dict[str, Any]:
    """Inputs of the step that ``shape.kind`` runs.  (Paged decode cells
    swap ``cache`` for :func:`paged_cache_specs`; the dry run composes
    that itself.)"""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, b, s, device=device)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, b, s, with_labels=False,
                                     device=device)}
    return {
        "tokens": _sds((b, 1), torch.int32, device),
        "cache": cache_specs(cfg, b, s, quantized_kv, device=device),
        "pos": _sds((), torch.int32, device),
    }
