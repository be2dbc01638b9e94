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

Page KINDS (``page_kinds``): attention layers page growable KV ("kv");
recurrent layers (mamba / rwkv) ride fixed-size state SLABS ("state"):
one slab per request holds its whole posit8 state tree (codes and bf16
group scales per leaf), admitted once for the request's lifetime and
rewritten in place by each decode step.  The slab buffers are the
``init_state_cache`` tree quantized, with the per-request axis (axis 1
of every leaf) widened to ``n_slabs + 1``; slab 0 is the PARKING slab,
where finished decode rows read and write.  A hybrid family (jamba)
holds both kinds, a pure-recurrent one (rwkv) zero-size KV leaves and
no pages.  Slabs refcount like pages and hand off bitwise through
``export_state`` / ``import_state``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import transformer as _transformer
from ..kernels.ref import kv_scale_cols

__all__ = ["PARKING_PAGE", "PARKING_SLAB", "PagedKVPool",
           "paged_kv_bytes_per_step", "page_handoff_bytes",
           "state_slab_bytes"]

POOL_KEYS = ("k_codes", "v_codes", "k_scale", "v_scale")

# Page 0 is never allocated: dead decode rows re-map their writes here.
# Its scales start at the neutral 1.0, so even a masked read through it
# dequantizes to finite values.
PARKING_PAGE = 0

# Slab 0 plays the same role on the state plane.
PARKING_SLAB = 0


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _state_layout(cfg, n: int, kv_group: Optional[int], device):
    """The quantized state tree of ``n`` requests (``ssm.quantize_state``
    of ``init_state_cache``: posit8 codes at 0, bf16 scales at the neutral
    1.0, so a read through the parking slab dequantizes to zeros)."""

    def rec(node):
        out = {}
        for key, val in sorted(node.items()):
            if isinstance(val, dict):
                out[key] = rec(val)
                continue
            shape = tuple(val.shape)
            out[key + "_codes"] = torch.zeros(shape, dtype=torch.uint8,
                                              device=device)
            out[key + "_scale"] = torch.ones(
                shape[:-1] + (kv_scale_cols(shape[-1], kv_group),),
                dtype=torch.bfloat16, device=device)
        return out

    return rec(_transformer.init_state_cache(cfg, n, "meta"))


class PagedKVPool:
    """Fixed-size paged posit8 cache pool with host-side accounting:
    ``n_pages`` allocatable KV pages and ``n_slabs`` allocatable state
    slabs, each plus its parking id 0."""

    # layer kinds per family: which cache planes the pool must hold
    _FAMILY_KINDS = {"dense": ("kv",), "moe": ("kv",),
                     "ssm": ("state",), "hybrid": ("kv", "state")}

    @classmethod
    def page_kinds(cls, cfg) -> tuple:
        """Cache kinds the config's layer mix needs: ``"kv"`` if any layer
        is attention, ``"state"`` if any is recurrent."""
        kinds = cls._FAMILY_KINDS.get(cfg.family)
        if kinds is None:
            raise ValueError(
                f"no page-kind mapping for family {cfg.family!r}: the "
                f"paged serving plane supports "
                f"{sorted(cls._FAMILY_KINDS)} (attention layers page "
                f"KV; recurrent layers ride fixed-size state slabs)")
        return kinds

    def __init__(self, cfg, n_pages: int, page_size: int,
                 kv_group: Optional[int] = None, n_slabs: int = 0,
                 device=None):
        kinds = self.page_kinds(cfg)
        self.has_kv = "kv" in kinds
        self.has_state = "state" in kinds
        self.cfg = cfg
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.kv_group = kv_group
        self.device = resolve_device(device)
        hd = cfg.resolved_head_dim
        self.gs = kv_scale_cols(hd, kv_group)
        # KV leaves span the attention layers only (none for rwkv: the
        # leaves stay, zero-size, so the key set is uniform)
        self.kv_layers = cfg.n_attn_layers if self.has_kv else 0
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
        # state-slab plane: the same accounting, its own id space
        self.n_slabs = int(n_slabs) if self.has_state else 0
        self.state: Dict[str, Any] = {}
        if self.has_state:
            self.state = _state_layout(cfg, self.n_slabs + 1, kv_group,
                                       self.device)
        self._slab_free: List[int] = list(range(self.n_slabs, 0, -1))
        self._slab_ref: Dict[int, int] = {}
        self._slab_allocated: set = set()
        self.slab_alloc_peak = 0

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
        """KV pages needed to hold ``tokens`` cache slots (0 for a
        pure-recurrent family: its whole footprint is one slab)."""
        if not self.has_kv:
            return 0
        return -(-tokens // self.page_size)

    @property
    def free_slabs(self) -> int:
        return len(self._slab_free)

    @property
    def used_slabs(self) -> int:
        return self.n_slabs - len(self._slab_free)

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
        if self.has_state:
            registry.gauge(f"{namespace}/n_slabs", fn=lambda: self.n_slabs)
            registry.gauge(f"{namespace}/used_slabs",
                           fn=lambda: self.used_slabs)
            registry.gauge(f"{namespace}/free_slabs",
                           fn=lambda: self.free_slabs)
            registry.gauge(f"{namespace}/slab_alloc_peak",
                           fn=lambda: self.slab_alloc_peak)
            registry.gauge(
                f"{namespace}/slab_bytes",
                fn=lambda: state_slab_bytes(self.cfg, self.kv_group))

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

    # -- slab alloc / free (the state plane: same discipline) ---------------

    def alloc_slab(self) -> Optional[int]:
        """Pop ONE slab at refcount 1 (a request needs exactly one for its
        whole lifetime); None, and no change, if none is free."""
        assert self.has_state, "slab alloc on a pool without state"
        if not self._slab_free:
            return None
        sl = self._slab_free.pop()
        assert sl not in self._slab_allocated, f"slab {sl} double-allocated"
        self._slab_allocated.add(sl)
        self._slab_ref[sl] = 1
        self.slab_alloc_peak = max(self.slab_alloc_peak, self.used_slabs)
        return sl

    def incref_slab(self, sl: int) -> None:
        assert sl in self._slab_allocated, f"incref of unallocated slab {sl}"
        self._slab_ref[sl] += 1

    def free_slab(self, sl: int) -> None:
        """Decref; the slab returns to the free list when its last holder
        lets go (mirrors :meth:`free`)."""
        assert 0 < sl <= self.n_slabs, sl
        assert sl in self._slab_allocated, f"double free of slab {sl}"
        self._slab_ref[sl] -= 1
        if self._slab_ref[sl] == 0:
            del self._slab_ref[sl]
            self._slab_allocated.remove(sl)
            self._slab_free.append(sl)

    def slab_refcount(self, sl: int) -> int:
        return self._slab_ref.get(sl, 0)

    # -- device state -------------------------------------------------------

    def device_state(self) -> Dict[str, Any]:
        """The pool leaves a paged step reads and writes (in place): the
        KV leaves for attention-bearing families and the ``"state"``
        subtree (the slab buffers) for recurrent ones."""
        out: Dict[str, Any] = {}
        if self.has_kv:
            out.update({k: getattr(self, k) for k in POOL_KEYS})
        if self.has_state:
            out["state"] = self.state
        return out

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
        if c % self.page_size:
            # recurrent-family chunks are unpadded (a pad token would run
            # through the state), so a hybrid prefix's final chunk may
            # end mid-page: pad its trailing block here with zero codes
            # and neutral scales, which decode overwrites or never reads
            pad = self.page_size - c % self.page_size
            cache_q = {key: torch.nn.functional.pad(
                cache_q[key], (0, 0, 0, 0, 0, pad),
                value=1.0 if key.endswith("_scale") else 0)
                for key in POOL_KEYS}
            c += pad
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

    # -- state slab movement ------------------------------------------------

    def write_state(self, state_q, slab: int) -> None:
        """Write one request's quantized state (leaves of batch width 1 on
        axis 1) into its slab, in place: prefill completion does it once,
        decode then rewrites the slab in the decode loop."""
        def put(dst, src):
            dst[:, slab:slab + 1] = src.to(dst.device)

        _tree_map(put, self.state, state_q)

    def export_state(self, slab: int) -> Dict[str, Any]:
        """One slab as a detached payload (batch width 1): the state side
        of the disaggregated handoff and of the scheduler's preemption
        snapshot.  A copy, so it stays valid after the slab is freed."""
        return _tree_map(lambda leaf: leaf[:, slab:slab + 1].clone(),
                         self.state)

    def import_state(self, payload, slab: int) -> None:
        """Write an exported state payload into this pool's ``slab``;
        codes and scales land bitwise."""
        self.write_state(payload, slab)

    # -- roofline -----------------------------------------------------------

    def modeled_bytes_per_step(self, positions) -> float:
        """Modeled cache bytes one batched decode step moves, per page
        kind: each live request reads its ceil((pos+1)/page) live KV pages
        over the attention layers, and reads and rewrites its slab."""
        total = paged_kv_bytes_per_step(self.cfg, positions, self.page_size,
                                        self.kv_group)
        if self.has_state:
            n_live = int(np.atleast_1d(np.asarray(positions)).size)
            total += 2.0 * state_slab_bytes(self.cfg, self.kv_group) * n_live
        return total


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


def state_slab_bytes(cfg, kv_group: Optional[int] = None) -> int:
    """Bytes ONE request's quantized recurrent state occupies: the sum of
    an ``export_state`` payload's leaves (posit8 codes + bf16 group
    scales).  A slab holds this much, a handoff moves it, and a decode
    step reads and rewrites it.  0 for pure-attention families."""
    if "state" not in PagedKVPool.page_kinds(cfg):
        return 0
    return int(sum(leaf.numel() * leaf.element_size()
                   for leaf in _leaves(_state_layout(cfg, 1, kv_group,
                                                     "meta"))))
