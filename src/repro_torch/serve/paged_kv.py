"""Paged posit8 KV pool: the physical cache plane of continuous batching
(the counterpart of ``repro.serve.paged_kv``, KV page kind).

The pool holds one shared set of fixed-size PAGES per layer -- posit8
codes + po2 group scales, the layout of the contiguous quantized cache
-- and each request owns an ordered list of page ids (its page table).
A request's KV footprint is ceil(live_tokens / page) pages.

Layout (page size == the decode kernel's KV block, so paged and
contiguous decode share one block partition and agree bitwise):

  k_codes/v_codes : (L, P+1, page, Kh, Dh) uint8
  k_scale/v_scale : (L, P+1, page, Kh, Gs) bf16, Gs = Dh/group, init 1.0

A page id indexes every layer's pool at once.  Page 0 is the PARKING
page: never allocated; padded and finished batch rows of the decode
loop write their garbage there, and page-table rows are padded with it.

Alloc/free is host-side bookkeeping with per-page REFCOUNTS: ``alloc``
hands out pages at refcount 1, ``incref`` adds a holder (a request
sharing a cached prompt-prefix page, or the prefix index itself), and
``free`` is a decref -- a page returns to the (LIFO) free list only when
its last holder drops it.  Only whole prompt-prefix pages are shared,
and no write path reaches them (see ``repro.serve.paged_kv`` for the
share / copy-on-write contract, which carries over unchanged).

The tensors move only through ``write_prefill``/``write_chunk`` (page
scatter of a quantized prefill cache or chunk), the paged chunk prefill
and the decode step (``models.attention``).  The reference donates the
pool to a jitted scatter and gets a new buffer back; the port writes
the pool tensors IN PLACE (indexed assignment), so ``device_state``
hands out the live tensors and there is nothing to set back.

Chunk/page contract: prefill chunks are whole pages (``chunk == k *
page_size``) that start at page boundaries, so ``write_chunk`` is a pure
page scatter and a half-prefilled request frees its pages with no
partial-page state to unwind.

Disaggregated serving moves whole pages between two pools:
``export_pages`` gathers a request's posit8 codes and bf16 scales into a
detached payload, and ``import_pages`` scatters one into another pool's
pages, bitwise.

Only the dense family pages through this port so far; recurrent state
slabs (``export_state`` / ``import_state``) come with a later slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models.attention import kv_scale_cols

__all__ = ["PARKING_PAGE", "PagedKVPool", "paged_kv_bytes_per_step",
           "page_handoff_bytes"]

POOL_KEYS = ("k_codes", "v_codes", "k_scale", "v_scale")

# Page 0 is never allocated: dead decode rows re-map their writes here.
# Its scales start at the neutral 1.0, so even a masked read through it
# dequantizes to finite values.
PARKING_PAGE = 0


class PagedKVPool:
    """Fixed-size paged posit8 KV pool with host-side accounting.
    ``n_pages`` allocatable pages plus the parking page (id 0)."""

    @classmethod
    def page_kinds(cls, cfg) -> tuple:
        """Cache kinds the config needs: ``("kv",)`` for the dense family.
        The reference also pages MoE KV and recurrent state slabs; the
        port does not yet, and says so."""
        if cfg.family != "dense":
            raise ValueError(
                f"the port's paged pool serves the dense family only so "
                f"far; {cfg.name} is family {cfg.family!r} (moe KV and "
                f"ssm/hybrid state slabs come with later slices)")
        return ("kv",)

    def __init__(self, cfg, n_pages: int, page_size: int,
                 kv_group: Optional[int] = None, device=None):
        self.page_kinds(cfg)
        self.cfg = cfg
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.kv_group = kv_group
        self.device = resolve_device(device)
        hd = cfg.resolved_head_dim
        self.gs = kv_scale_cols(hd, kv_group)
        self.kv_layers = cfg.n_layers
        P = self.n_pages + 1
        code_shape = (self.kv_layers, P, self.page_size, cfg.n_kv_heads, hd)
        scale_shape = code_shape[:-1] + (self.gs,)
        self.k_codes = torch.zeros(code_shape, dtype=torch.uint8,
                                   device=self.device)
        self.v_codes = torch.zeros(code_shape, dtype=torch.uint8,
                                   device=self.device)
        self.k_scale = torch.ones(scale_shape, dtype=torch.bfloat16,
                                  device=self.device)
        self.v_scale = torch.ones(scale_shape, dtype=torch.bfloat16,
                                  device=self.device)
        # LIFO free list; ``_allocated`` == the pages with refcount >= 1
        self._free: List[int] = list(range(P - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._allocated: set = set()
        self.alloc_peak = 0

    # -- accounting ---------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def utilization(self) -> float:
        return self.used_pages / max(self.n_pages, 1)

    def pages_for(self, tokens: int) -> int:
        """KV pages needed to hold ``tokens`` cache slots."""
        return -(-tokens // self.page_size)

    def register_gauges(self, registry, namespace: str = "pool") -> None:
        """Expose the pool's occupancy as callback gauges on an
        ``obs.MetricRegistry`` (read lazily at snapshot time)."""
        registry.gauge(f"{namespace}/n_pages", fn=lambda: self.n_pages)
        registry.gauge(f"{namespace}/used_pages", fn=lambda: self.used_pages)
        registry.gauge(f"{namespace}/free_pages", fn=lambda: self.free_pages)
        registry.gauge(f"{namespace}/utilization",
                       fn=lambda: self.utilization)
        registry.gauge(f"{namespace}/alloc_peak", fn=lambda: self.alloc_peak)
        registry.gauge(
            f"{namespace}/page_bytes",
            fn=lambda: page_handoff_bytes(self.cfg, self.page_size,
                                          self.kv_group))

    # -- alloc / free -------------------------------------------------------

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages off the free list at refcount 1; None (and no
        change) if the pool cannot satisfy the request."""
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for pg in got:
            assert pg not in self._allocated, f"page {pg} double-allocated"
            self._allocated.add(pg)
            self._ref[pg] = 1
        self.alloc_peak = max(self.alloc_peak, self.used_pages)
        return got

    def incref(self, pages: List[int]) -> None:
        """Add one holder to already-allocated pages."""
        for pg in pages:
            assert pg in self._allocated, f"incref of unallocated page {pg}"
            self._ref[pg] += 1

    def free(self, pages: List[int]) -> None:
        """Drop ONE reference per page; a page returns to the free list
        only when its last holder lets go."""
        for pg in pages:
            assert 0 < pg <= self.n_pages, pg
            assert pg in self._allocated, f"double free of page {pg}"
            self._ref[pg] -= 1
            if self._ref[pg] == 0:
                del self._ref[pg]
                self._allocated.remove(pg)
                self._free.append(pg)

    def refcount(self, pg: int) -> int:
        """Current holder count of a page (0 = free)."""
        return self._ref.get(pg, 0)

    # -- device state -------------------------------------------------------

    def device_state(self) -> Dict[str, torch.Tensor]:
        """The pool leaves a paged step reads and writes (in place)."""
        return {k: getattr(self, k) for k in POOL_KEYS}

    # -- data movement ------------------------------------------------------

    def write_prefill(self, cache_q, pages: List[int]) -> None:
        """Scatter a quantized B=1 prefill cache (leaves (L, 1, S, Kh, X),
        S a multiple of ``page_size``) into ``pages`` in logical order."""
        self.write_chunk(cache_q, pages, 0)

    def write_chunk(self, cache_q, pages: List[int], start: int) -> None:
        """Scatter one quantized B=1 prefill CHUNK (leaves (L, 1, C, Kh, X),
        C whole pages) into a request's pages from the page-aligned slot
        ``start``.  A final chunk padded past the request's allocation
        writes only ``pages[start/page_size:]``; its pad pages drop."""
        leaf = cache_q["k_codes"]
        n_layers, b, c = leaf.shape[:3]
        assert b == 1, "prefill writes are per-request (B=1)"
        assert c % self.page_size == 0, (c, self.page_size)
        assert start % self.page_size == 0, (start, self.page_size)
        first = start // self.page_size
        nblk = min(c // self.page_size, len(pages) - first)
        assert nblk > 0, (start, c, len(pages))
        idx = torch.as_tensor(pages[first:first + nblk], dtype=torch.long,
                              device=self.device)
        s = nblk * self.page_size
        for key in POOL_KEYS:
            src = cache_q[key][:, 0, :s]                 # (L, S, Kh, X)
            getattr(self, key)[:, idx] = src.reshape(
                n_layers, nblk, self.page_size, *src.shape[2:])

    # -- page handoff (disaggregated prefill/decode) ------------------------

    def export_pages(self, pages: List[int]) -> Dict[str, torch.Tensor]:
        """Gather whole pages as a detached payload ``{key: (L, n, page,
        Kh, X)}`` in logical order: the posit8 codes and po2 group scales
        the handoff moves.  The gather is a copy queued on the pool's
        stream, so the caller may free the source pages at once: a later
        write into them runs after the copy."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        return {key: getattr(self, key)[:, idx] for key in POOL_KEYS}

    def import_pages(self, payload: Dict[str, torch.Tensor],
                     pages: List[int]) -> None:
        """Scatter an exported payload into this pool's ``pages`` (in
        place).  The source pool must share this one's geometry (layers,
        page size, heads, scale groups); the page ids need not match.
        Codes and scales land bitwise."""
        leaf = payload["k_codes"]
        if leaf.shape[0] != self.kv_layers or leaf.shape[1] != len(pages) \
                or tuple(leaf.shape[2:]) != tuple(self.k_codes.shape[2:]) \
                or tuple(payload["k_scale"].shape[2:]) \
                != tuple(self.k_scale.shape[2:]):
            raise ValueError(
                f"payload codes {tuple(leaf.shape)} / scales "
                f"{tuple(payload['k_scale'].shape)} do not fit {len(pages)} "
                f"pages of this pool {tuple(self.k_codes.shape)}")
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for key in POOL_KEYS:
            getattr(self, key)[:, idx] = payload[key].to(self.device)

    def gather_request(self, pages: List[int]) -> Dict[str, torch.Tensor]:
        """Read a request's pages back as a contiguous (L, 1, T, Kh, X)
        quantized cache (debug / test oracle)."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        out = {}
        for key in POOL_KEYS:
            x = getattr(self, key)[:, idx]               # (L, n, page, ...)
            out[key] = x.reshape(x.shape[0], 1, -1, *x.shape[3:])
        return out

    # -- roofline -----------------------------------------------------------

    def modeled_bytes_per_step(self, positions) -> float:
        """Modeled cache bytes one batched decode step moves: each live
        request reads its ceil((pos+1)/page) live pages over all layers."""
        return paged_kv_bytes_per_step(self.cfg, positions, self.page_size,
                                       self.kv_group)


def paged_kv_bytes_per_step(cfg, positions, page_size: int,
                            kv_group: Optional[int] = None) -> float:
    """Codes + scales bytes of the live pages of every request."""
    hd = cfg.resolved_head_dim
    gs = kv_scale_cols(hd, kv_group)
    toks = sum(-(-(int(p) + 1) // page_size) * page_size
               for p in np.atleast_1d(np.asarray(positions)))
    return float(2 * cfg.n_attn_layers * cfg.n_kv_heads * toks
                 * (hd * 1 + gs * 2))


def page_handoff_bytes(cfg, page_size: int,
                       kv_group: Optional[int] = None) -> int:
    """Bytes ONE page holds over every attention layer: K+V posit8 codes
    (1 byte per slot and feature) plus bf16 po2 group scales."""
    hd = cfg.resolved_head_dim
    gs = kv_scale_cols(hd, kv_group)
    return int(2 * cfg.n_attn_layers * page_size * cfg.n_kv_heads
               * (hd * 1 + gs * 2))
