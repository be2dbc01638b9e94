"""Serving engines over the packed weight plane (the counterpart of
``repro.serve.engine``).

``ServeEngine`` batches a fixed set of requests: prefill, then one-token
decode steps, with an optional posit8 KV cache.  With ``quantized_kv``
the prefill cache is quantized to posit8 codes and bf16 po2 scales at
once, padded to ``max_len`` (scales pad with 1.0), and every decode step
writes its token's codes in place and reads only the live prefix through
the flash-decode kernel.

``ContinuousEngine`` serves continuous batching over the paged posit8 KV
pool (``serve/paged_kv.py``) under the scheduler of
``serve/scheduler.py``: chunked prefill in a bf16 carry or straight
through the pages (the paged chunk-prefill kernel), prefix caching, and
a K-step decode loop (the paged flash-decode kernel) that keeps every
operand on the device and syncs one (B, K) token buffer per dispatch.

Recurrent (rwkv6) and hybrid (jamba) families serve through the same
engines: the static engine's ``quantized_state`` keeps their state as
posit8 codes and round-trips it every step (the oracle of the paged
pool's state slabs); the continuous engine gives each request one state
slab, prefills in unpadded chunks on the carry context, writes the
state into the slab once when prefill completes, and gathers and
scatters the slabs of the running rows in the decode loop.

Both engines pack the weights once when they are built and cast the tied
read-out table to the compute dtype once then, not at every step.  The
reference's jit has no counterpart: the port runs eagerly, and a
function built here is the Python function itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..core.formats import torch_dtype
from ..core.policy import PrecisionPolicy
from ..kernels.ops import PackedTensor
from ..models import ssm, zoo
from ..models.transformer import attn_key
from ..obs import (NULL_RECORDER, MetricRegistry, bind_counters, host_span,
                   recording)
from .paged_kv import (PARKING_PAGE, PARKING_SLAB, POOL_KEYS, PagedKVPool,
                       _tree_map, state_slab_bytes)
from .scheduler import PREFILLING, RUNNING, Scheduler

__all__ = ["build_prefill_step", "build_prefill_chunk_step",
           "build_serve_step", "sample_tokens", "ServeEngine",
           "ContinuousEngine"]


def build_prefill_step(cfg: ModelConfig, last_logit_only: bool = False,
                       quantized_kv: bool = False,
                       kv_group: Optional[int] = None,
                       quantized_state: bool = False):
    """(params, batch) -> (logits, cache): the full-sequence forward that
    also fills the KV cache (posit8 under ``quantized_kv``) and the
    recurrent state (posit8 too with ``quantized_state``)."""

    def prefill(params, batch):
        logits, cache = zoo.apply_model(params, batch, cfg,
                                        last_only=last_logit_only)
        if quantized_kv:
            cache = zoo.quantize_cache(cache, kv_group,
                                       quantize_state=quantized_state)
        return logits, cache

    return prefill


def _next_token(logits, generator: Optional[torch.Generator],
                temperature: float) -> torch.Tensor:
    """Greedy (first-occurrence argmax) at temperature 0, else a sample of
    softmax(logits / temperature) drawn from ``generator``."""
    lg = logits[:, -1]
    if temperature > 0:
        probs = torch.softmax(lg.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(lg, dim=-1, keepdim=True)


def build_serve_step(cfg: ModelConfig):
    """(params, tokens (B, 1), cache, pos, pad, generator, temperature)
    -> (next tokens (B, 1), cache): one decode step with sampling fused
    in; the cache is updated in place.  ``pad`` (B,) int32 left-pad
    widths of a ragged batch, or None."""

    def serve_step(params, tokens, cache, pos: int, pad, generator,
                   temperature: float):
        logits, cache = zoo.decode_model(params, tokens, cfg, cache, pos, pad)
        return _next_token(logits, generator, temperature), cache

    return serve_step


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, PackedTensor)):
        return tree.to(device)
    return tree


def _serving_params(params, cfg: ModelConfig,
                    policy: Optional[PrecisionPolicy], device):
    """Parameters on ``device``, packed per ``policy``, with the tied
    read-out table cast to the compute dtype once (``embed()`` takes the
    same cast, so nothing changes)."""
    params = _to_device(params, device)
    if policy is not None:
        params = zoo.pack_params(params, policy)
    if "embed" not in params:        # an audio config reads out lm_head
        return params
    return dict(params, embed={
        "table": params["embed"]["table"].to(torch_dtype(cfg.dtype))})


class ServeEngine:
    """Static-batch serving with greedy / temperature sampling.

    ``quantized_state`` (recurrent and hybrid families, with
    ``quantized_kv``): the state after prefill is quantized to posit8
    once and every decode step round-trips it through posit8 -- what the
    continuous engine's state slabs hold, so this is their oracle."""

    # cache leaves with a sequence axis, laid out (L, B, S, H, ...)
    _SEQ_KEYS = frozenset({"k", "v", "k_codes", "v_codes", "k_scale",
                           "v_scale"})
    # scales pad with the neutral po2 scale 1.0, never 0.0
    _SCALE_KEYS = frozenset({"k_scale", "v_scale"})

    def __init__(self, cfg: ModelConfig, params, max_len: int = 2048,
                 quantized_kv: bool = False,
                 policy: Optional[PrecisionPolicy] = None, device=None,
                 quantized_state: bool = False):
        self.cfg = cfg
        self.max_len = max_len
        self.quantized_kv = quantized_kv
        self.quantized_state = quantized_state
        self.policy = policy
        self.device = resolve_device(device)
        self.params = _serving_params(params, cfg, policy, self.device)
        kv_group = policy.group_size if policy else None
        self._prefill = build_prefill_step(cfg, last_logit_only=True,
                                           quantized_kv=quantized_kv,
                                           kv_group=kv_group,
                                           quantized_state=quantized_state)
        self._step = build_serve_step(cfg)

    @torch.inference_mode()
    def generate(self, tokens, steps: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 lengths=None) -> np.ndarray:
        """tokens (B, S0) prompt -> (B, S0 + steps) completed.

        ``lengths``: optional (B,) true prompt lengths of a LEFT-padded
        ragged batch; pad tokens are masked out of attention and RoPE
        positions start at each request's first real token."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                 device=self.device)
        b, s0 = tokens.shape
        if s0 + steps > self.max_len:
            raise ValueError(f"prompt {s0} + {steps} steps exceeds max_len "
                             f"{self.max_len}")
        batch = {"tokens": tokens}
        pad = None
        if lengths is not None:
            if self.cfg.family not in ("dense", "moe") or \
                    self.cfg.rope_kind != "default":
                raise ValueError(
                    "ragged prompts need a pure-attention family with "
                    "default RoPE (SSM state would still absorb pads)")
            lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int32,
                                      device=self.device)
            pad = (s0 - lengths).to(torch.int32)
            idx = torch.arange(s0, dtype=torch.int32, device=self.device)[None]
            batch["positions"] = torch.clamp(idx - pad[:, None], min=0)
            batch["kv_mask"] = idx >= pad[:, None]
        logits, cache = self._prefill(self.params, batch)
        cache = self._pad_cache(cache)
        last = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        outs = [tokens]
        for i in range(steps):
            outs.append(last)
            last, cache = self._step(self.params, last, cache, s0 + i, pad,
                                     generator, temperature)
        return torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)

    def _pad_cache(self, cache):
        """Grow the prefill-length KV leaves to ``max_len`` slots (seq axis
        2), at any depth of the tree; recurrent state passes through."""
        out = {}
        for key, x in cache.items():
            if isinstance(x, dict):
                x = self._pad_cache(x)
            elif key in self._SEQ_KEYS and x.shape[2] < self.max_len:
                fill = 1.0 if key in self._SCALE_KEYS else 0.0
                full = torch.full(x.shape[:2] + (self.max_len,) + x.shape[3:],
                                  fill, dtype=x.dtype, device=x.device)
                full[:, :, : x.shape[2]] = x
                x = full
            out[key] = x
        return out


# ---------------------------------------------------------------------------
# Continuous batching over the paged posit8 KV pool
# ---------------------------------------------------------------------------

def build_prefill_chunk_step(cfg: ModelConfig,
                             kv_group: Optional[int] = None,
                             paged: bool = False):
    """(params, tokens (1, C), ctx, start (1,)) -> the chunk step of
    chunked prefill: forward one CHUNK of C tokens at positions
    ``start .. start+C-1``, attending causally to ``ctx`` plus itself.

    ``paged=False`` (carry): ``ctx`` is the family's ``init_cache`` tree:
    a bf16 KV carry ``{"k", "v"}`` (L, 1, T, Kh, Dh) for attention layers
    and the f32 state carried from the previous chunk for recurrent ones;
    returns (logits (1, C, V), the chunk's cache -- its kv and its final
    state -- and that cache with its kv quantized for
    ``PagedKVPool.write_chunk``).  ``paged=True`` (attention-only
    families): ``ctx`` is the pool leaves plus ``page_table`` (1, NP); the
    chunk is written into its pages in place and read back through the
    page table (the paged chunk-prefill kernel); returns (logits, ctx)."""
    if paged and cfg.family not in ("dense", "moe"):
        raise ValueError(
            f"prefill_context='pages' re-reads the prefix through the "
            f"page table, but family {cfg.family!r} carries recurrent "
            f"state that never lands in pages: chunk on the carry path")
    if cfg.rope_kind != "default":
        raise ValueError("chunked prefill serves 1-D token streams "
                         f"(rope_kind={cfg.rope_kind!r})")

    def chunk_step(params, tokens, ctx, start):
        c = tokens.shape[1]
        positions = start[:, None] + torch.arange(
            c, dtype=torch.int32, device=tokens.device)[None]
        logits, new_cache = zoo.apply_model(
            params, {"tokens": tokens, "positions": positions}, cfg,
            mode="prefill_chunk", cache=ctx)
        if paged:
            return logits, new_cache
        with host_span("fwd.kv_write"):
            return logits, new_cache, zoo.quantize_cache(new_cache, kv_group)

    return chunk_step


def _check_stateful_context(kinds, cfg, prefill_context: str) -> None:
    """Recurrent state never lands in pages, so a stateful family cannot
    take the pages context (nor, with it, the prefix cache)."""
    if "state" in kinds and prefill_context == "pages":
        raise ValueError(
            f"family {cfg.family!r} carries recurrent state, which never "
            f"lands in pages and cannot be re-read through a page table: "
            f"serve it with prefill_context='carry' (which also rules out "
            f"prefix_cache -- a cached prefix cannot reproduce the state "
            f"of tokens this request never forwarded)")


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer hash (xor-shift-multiply) of int64 values in
    [0, 2**32); the constants stay below 2**31, so no product overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def sample_tokens(logits: torch.Tensor, temperature: float, seed: int,
                  rids: torch.Tensor, gen_idx: torch.Tensor) -> torch.Tensor:
    """Next tokens (N,) int64 from logits (N, V), on their device.

    Temperature 0: first-occurrence argmax (as ``jnp.argmax``).  Above:
    Gumbel-max over ``logits / temperature`` with noise hashed from
    (seed, rid, token index, vocab id) -- a counter-based stream, so the
    token drawn for a request is a function of (seed, rid, token index)
    and its logits only, whatever K, batch or schedule.  The reference's
    ``fold_in`` stream cannot be reproduced in torch; this one has the
    same property."""
    lg = logits.float()
    if temperature <= 0:
        return torch.argmax(lg, dim=-1)
    key = _mix32(torch.full_like(rids, seed & _M32, dtype=torch.int64))
    key = _mix32(key ^ rids.long())
    key = _mix32(key ^ gen_idx.long())
    vocab = torch.arange(lg.shape[-1], dtype=torch.int64, device=lg.device)
    bits = _mix32(key[:, None] ^ vocab[None])
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))     # in (0, 1)
    return torch.argmax(lg / temperature - torch.log(-torch.log(u)), dim=-1)


@contextlib.contextmanager
def _sync_guard(on: bool):
    """Raise on any host-device synchronisation inside the block when
    ``on`` (the port's counterpart of ``jax.transfer_guard``): a device
    value read back, or a host value copied to the card, fails the run
    instead of silently serialising it.  Operands are staged before it."""
    if not on:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _build_decode_loop(cfg: ModelConfig, temperature: float, k_steps: int,
                       seed: int):
    """The K-step decode dispatch of the continuous engine.

    (params, tokens (B, 1), positions (B,), cache {pool leaves},
     page_table (B, NP), slab_table (B,), done (B,) bool, budget (B,),
     eos (B,), rids (B,), gen_idx (B,)) -> sampled (B, K) int32; the pool
    is written in place.

    A Python loop of ``k_steps`` decode+sample iterations on device
    tensors (the reference's ``lax.scan``), static in shape: fused
    sampling (``sample_tokens``), device-side position bumps and a
    done-mask.  A row finishes when it samples its ``eos`` or spends its
    ``budget``; finished and padded rows freeze their token and position
    and re-map their page-table row to the parking page, so their
    remaining iterations write page 0 at position 0.  Recurrent layers
    (ssm / hybrid) gather their rows' posit8 state slabs by
    ``slab_table`` (finished rows: the parking slab), decode round-trips
    the state through posit8 inside the model, and the slabs are
    scattered back each iteration.  Nothing is read back to the host
    inside the loop."""
    has_state = cfg.family in ("ssm", "hybrid")
    has_kv = cfg.family != "ssm"
    akey = attn_key(cfg) if cfg.family == "hybrid" else None

    def loop(params, tokens, positions, cache, page_table, slab_table, done,
             budget, eos, rids, gen_idx):
        out = torch.empty((tokens.shape[0], k_steps), dtype=torch.int32,
                          device=tokens.device)
        for i in range(k_steps):
            if has_state:
                slab_idx = torch.where(done, PARKING_SLAB, slab_table).long()
                state = _tree_map(lambda leaf: leaf[:, slab_idx],
                                  cache["state"])
            if not has_kv:
                step_cache = state
            else:
                kv = {k: cache[k] for k in POOL_KEYS}
                step_cache = dict(state, **{akey: kv}) if has_state \
                    else kv
                step_cache["page_table"] = torch.where(
                    done[:, None], PARKING_PAGE, page_table)
                step_cache["positions"] = torch.where(done, 0, positions)
            logits, _ = zoo.decode_model(params, tokens, cfg, step_cache, 0)
            if has_state:                # the gathered state, updated
                def put(buf, new):
                    buf[:, slab_idx] = new
                _tree_map(put, cache["state"], state)
            with host_span("fwd.sample"):
                nxt = sample_tokens(logits[:, 0], temperature, seed, rids,
                                    gen_idx).to(torch.int32)
                nxt = torch.where(done, tokens[:, 0].to(torch.int32), nxt)
                budget = torch.where(done, budget, budget - 1)
                new_done = done | (nxt == eos) | (budget <= 0)
                positions = torch.where(done, positions, positions + 1)
                gen_idx = torch.where(done, gen_idx, gen_idx + 1)
                out[:, i] = nxt
                tokens = nxt[:, None].long()
                done = new_done
        return out

    return loop


def _decode_horizon(req, decode_steps: int) -> int:
    """Pages to pre-claim for: the decode slots the next dispatch can
    write for ``req`` -- at most ``decode_steps``, capped by its
    remaining token budget."""
    return min(decode_steps,
               max(req.max_new_tokens - len(req.generated), 1))


class _PageTableCache:
    """Epoch-cached device page table: ``get`` re-uploads the (B, NP)
    table only when the scheduler epoch or the running-row order
    changed; otherwise the resident tensor is bit-identical and reused.
    The (B,) slab table rides the same entry: a row's slab can only
    change on the transitions that bump the epoch."""

    def __init__(self):
        self.dev = None
        self.slab_dev = None
        self.epoch = -1
        self.rows: List[int] = []

    def get(self, running, epoch: int, b: int, n_pages_per_req: int,
            device):
        """-> (page table, slab table, uploaded?) for the rid-ordered
        batch."""
        rows = [req.rid for req in running]
        if self.dev is None or epoch != self.epoch or rows != self.rows:
            page_table = np.zeros((b, n_pages_per_req + 1), np.int32)
            for row, req in enumerate(running):
                page_table[row, :len(req.pages)] = req.pages
                if req.slab is not None:
                    page_table[row, -1] = req.slab
            with host_span("sync.page_table"):
                both = torch.from_numpy(page_table).to(device)
            self.dev, self.slab_dev = both[:, :-1], both[:, -1]
            self.epoch = epoch
            self.rows = rows
            return self.dev, self.slab_dev, True
        return self.dev, self.slab_dev, False


def _dispatch_decode_loop(loop, params, pool, running, b: int,
                          pt_cache: _PageTableCache, epoch: int,
                          n_pages_per_req: int, guard: bool):
    """Launch one K-step decode dispatch for the rid-ordered ``running``
    batch: build the (B,) host operands, stage them on the device in ONE
    copy, fetch the epoch-cached page and slab tables, then run the loop
    (under the sync guard when ``guard``).  Returns the in-flight
    dispatch record; its (B, K) token buffer is still on the device.
    Spans: ``decode.stage`` (the operands, their upload and the page
    table) and ``decode.forward`` (the loop's enqueue)."""
    with host_span("decode.stage"):
        ops = np.zeros((7, b), np.int32)
        tokens, positions, done, budget, eos, rids, gen_idx = ops
        done[:] = 1                      # padding rows stay dead
        eos[:] = -1                      # -1: matches no vocab id
        for row, req in enumerate(running):
            tokens[row] = req.next_token
            positions[row] = req.position
            done[row] = 0
            budget[row] = req.max_new_tokens - len(req.generated)
            if req.eos_id is not None:
                eos[row] = req.eos_id
            rids[row] = req.rid
            gen_idx[row] = len(req.generated)
        with host_span("sync.decode_operands"):
            dev = torch.from_numpy(ops).to(pool.device)
        dev_table, slab_table, uploaded = pt_cache.get(
            running, epoch, b, n_pages_per_req, pool.device)
    with host_span("decode.forward"), _sync_guard(guard):
        toks_dev = loop(params, dev[0][:, None].long(), dev[1],
                        pool.device_state(), dev_table, slab_table,
                        dev[2].bool(), dev[3], dev[4], dev[5], dev[6])
    return {"running": running, "budget": budget.copy(),
            "toks_dev": toks_dev, "uploaded": int(uploaded)}


def _apply_decode_tokens(disp, toks: np.ndarray, retire) -> int:
    """Replay the device done-logic of a dispatch on host: walk each
    row's (K,) tokens until its budget or EOS froze it, retiring done
    requests through ``retire``.  Returns the decoded request count."""
    k_steps = toks.shape[1]
    for row, req in enumerate(disp["running"]):
        for j in range(min(k_steps, int(disp["budget"][row]))):
            nxt = int(toks[row, j])
            req.generated.append(nxt)
            req.next_token = nxt
            if req.done:
                break
        if req.done:
            retire(req)
    return len(disp["running"])


class _ChunkPrefillMixin:
    """Chunked paged prefill, shared by ``ContinuousEngine`` and the
    disaggregated ``PrefillWorker``.  The host object provides ``cfg``,
    ``params``, ``device``, ``scheduler`` (and its ``pool``),
    ``page_size``, ``max_pages_per_req``,
    ``prefill_chunk_tokens``, ``prefill_context``, ``temperature``,
    ``seed``, the chunk steps ``_chunk_step`` / ``_chunk_step_paged``,
    the ``_prefill_ctx`` carry dict, a ``prefill_tokens_computed``
    counter and a ``_trace`` recorder."""

    def _empty_ctx(self, width: int = 0):
        """The family's zero cache: a bf16 carry {"k", "v"} (L, 1, width,
        Kh, Dh), the zero rwkv state stack, or a hybrid group's mix of
        both."""
        return zoo.init_cache(self.cfg, 1, width, device=self.device)

    def _grow_ctx(self, ctx, kv, start: int, ln: int):
        """Fold one non-final chunk's cache into the prefill carry.  KV
        GROWS: the carry is allocated ONCE at the prompt's page-rounded
        width and written in place from then on (the reference donates it
        to a ``dynamic_update_slice``).  Recurrent state is REPLACED: the
        chunk's final state is all the next chunk needs."""
        if not self.pool.has_kv:
            return kv                    # rwkv: the state stack replaces
        if self.pool.has_state:          # hybrid: the attention sub grows
            ak = attn_key(self.cfg)
            out = dict(kv)
            out[ak] = self._grow_kv(ctx[ak], kv[ak], start, ln, ak)
            return out
        return self._grow_kv(ctx, kv, start, ln, None)

    def _grow_kv(self, carry, kv, start: int, ln: int, sub):
        if carry["k"].shape[2] == 0:
            carry = self._empty_ctx(self.pool.pages_for(ln) * self.page_size)
            if sub is not None:
                carry = carry[sub]
        c = kv["k"].shape[2]
        for key in ("k", "v"):
            carry[key][:, :, start:start + c] = kv[key]
        return carry

    def _sample(self, lg: torch.Tensor, req) -> int:
        """The first token, from one (V,) logit row at prefill completion:
        the decode loop's sampler on the same stream, then one scalar read
        back."""
        rid = torch.full((1,), req.rid, dtype=torch.int32, device=lg.device)
        idx = torch.full((1,), len(req.generated), dtype=torch.int32,
                         device=lg.device)
        tok = sample_tokens(lg[None], self.temperature, self.seed, rid,
                            idx)[0]
        with host_span("sync.first_token"):
            return int(tok)

    def _prefill_chunk(self, req) -> int:
        """Run at most ONE prefill chunk for ``req``: allocate the pages its
        slots land in (lazy, can preempt younger requests), forward it
        against the request's prefilled context, and write its codes into
        pages.  Completes prefill (samples the first token, PREFILLING ->
        RUNNING) when the chunk covers the prefix's last token.  Returns
        the prefill tokens spent (the padded width; 0 if ``req`` was
        preempted before any compute)."""
        sched = self.scheduler
        prefix = req.prefix
        ln = prefix.size
        # past the matched shared pages of a prefix-cache hit
        start = req.prefilled
        stateful = self.pool.has_state
        if stateful:
            # UNPADDED: every forwarded token runs through the recurrent
            # state, so a pad token would corrupt it (``write_chunk`` pads
            # a trailing partial page of KV instead)
            c = ln - start if self.prefill_chunk_tokens is None \
                else min(self.prefill_chunk_tokens, ln - start)
        elif self.prefill_chunk_tokens is None:
            # monolithic: one chunk covering every remaining page slot
            c = self.pool.pages_for(ln) * self.page_size - start
        else:
            c = self.prefill_chunk_tokens
        real = min(c, ln - start)
        if not sched.ensure_prefill_capacity(req, start + real):
            return 0                     # self-preempted: pool too dry
        paged = self.prefill_context == "pages"
        with host_span("prefill.stage"):
            toks = np.zeros((1, c), np.int64)
            toks[0, :real] = prefix[start:start + real]
            with host_span("sync.chunk_operands"):
                toks = torch.from_numpy(toks).to(self.device)
            start_t = torch.full((1,), start, dtype=torch.int32,
                                 device=self.device)
            if paged:
                pt = np.zeros((1, self.max_pages_per_req), np.int32)
                pt[0, :len(req.pages)] = req.pages
                cache = self.pool.device_state()
                with host_span("sync.chunk_operands"):
                    cache["page_table"] = torch.from_numpy(pt).to(
                        self.device)
            else:
                cache = self._prefill_ctx.get(req.rid)
                if start == 0 or cache is None:
                    cache = self._empty_ctx()
        with host_span("prefill.forward"):
            if paged:
                logits, _ = self._chunk_step_paged(self.params, toks, cache,
                                                   start_t)
            else:
                logits, kv, chunk_q = self._chunk_step(self.params, toks,
                                                       cache, start_t)
        if not paged:
            with host_span("prefill.write"):
                if self.pool.has_kv:
                    self.pool.write_chunk(
                        chunk_q[attn_key(self.cfg)] if stateful else chunk_q,
                        req.pages, start)
                if start + real < ln:    # full chunk: extend the carry
                    self._prefill_ctx[req.rid] = self._grow_ctx(
                        cache, kv, start, ln)
                elif stateful:
                    # prefill completion writes the carried state into the
                    # request's slab ONCE, quantized as the static engine
                    # quantizes its cache after prefill
                    state = kv if not self.pool.has_kv else {
                        k: v for k, v in kv.items()
                        if k != attn_key(self.cfg)}
                    self.pool.write_state(
                        ssm.quantize_state(state, self.pool.kv_group),
                        req.slab)
        req.prefilled = start + real
        self.prefill_tokens_computed += real
        self._trace.event("PREFILL_CHUNK", rid=req.rid, start=start,
                          width=c, real=real)
        if req.prefilled == ln:
            self._prefill_ctx.pop(req.rid, None)
            nxt = self._sample(logits[0, real - 1], req)
            req.generated.append(nxt)
            req.next_token = nxt
            sched.prefill_complete(req)
        return c

    def _prefill_phase(self) -> List[Any]:
        """Chunked prefill, oldest first, inside the per-step budget of
        ``prefill_chunk_tokens`` (None = whole prefixes).  Returns the
        requests whose prefill completed this step and drops the carries
        of requests no longer mid-prefill."""
        sched = self.scheduler
        budget = self.prefill_chunk_tokens
        spent = 0
        completed = []
        for req in [r for r in sched.running if r.status == PREFILLING]:
            while req.status == PREFILLING and \
                    (budget is None or spent < budget):
                spent += self._prefill_chunk(req)
            if req.status == RUNNING:
                completed.append(req)
        live = {r.rid for r in sched.running if r.status == PREFILLING}
        for rid in [r for r in self._prefill_ctx if r not in live]:
            del self._prefill_ctx[rid]
        return completed


@dataclasses.dataclass
class ContinuousEngine(_ChunkPrefillMixin):
    """Continuous-batching serving over a paged posit8 KV pool.

    One decode dispatch of shape ``max_batch`` serves every running
    request at its own position.  Each step (1) ensures page capacity for
    the running requests, (2) admits queued requests (FIFO, gated on
    unclaimed free pages), (3) prefills admitted requests in page-aligned
    CHUNKS inside a per-step token budget, (4) runs one K-step decode
    dispatch for everyone running, and (5) retires finished requests --
    with LIFO preemption when the pool runs dry.

    ``prefill_chunk_tokens`` (a multiple of ``page_size`` dividing
    ``max_len``; None = one whole-prefix chunk) bounds the prefill tokens
    of one step.  ``prefill_context``: ``"carry"`` (default) attends to
    the prefilled prefix as a transient bf16 carry, which matches a
    monolithic prefill; ``"pages"`` re-reads it from its posit8 pages
    through the paged chunk-prefill kernel.  ``prefix_cache`` shares
    whole prompt-prefix pages between requests and implies (and needs)
    the pages context.  ``decode_steps`` K decode+sample iterations run
    per dispatch; temperature-0 outputs are the same for every K.  At
    temperature 0 with ``page_size == default_kv_block(max_len)`` and the
    carry context, outputs match per-request ``ServeEngine.generate``.

    Recurrent and hybrid families hold ``n_state_slabs`` state slabs
    (default ``max_batch``: one per batch slot, so slabs never gate
    admission below it); every admitted request holds one for its whole
    lifetime.  They prefill on the carry context only, so neither
    ``prefill_context="pages"`` nor ``prefix_cache`` serves them.

    ``sync_guard`` runs each decode loop under
    ``torch.cuda.set_sync_debug_mode("error")`` on a CUDA device, so a
    hidden host-device sync on the decode path raises.  ``trace`` is an
    ``obs.TraceRecorder`` for lifecycle events and step spans (None: the
    shared no-op recorder)."""

    cfg: ModelConfig
    params: Any
    n_pages: int = 64
    page_size: Optional[int] = None
    max_batch: int = 8
    max_len: int = 512
    policy: Optional[PrecisionPolicy] = None
    temperature: float = 0.0
    eos_id: Optional[int] = None
    seed: int = 0
    prefill_chunk_tokens: Optional[int] = None
    prefill_context: Optional[str] = None
    prefix_cache: bool = False
    decode_steps: int = 1
    n_state_slabs: Optional[int] = None
    trace: Any = None
    sync_guard: bool = False
    device: Any = None

    _COUNTERS = (
        "steps_run",
        "prefill_tokens_computed",  # real tokens forwarded
        "decode_dispatches",        # decode-loop calls
        "page_table_uploads",       # (B, NP) host->device uploads
        "token_host_bytes",         # device->host sampled-token sync
    )

    def __post_init__(self):
        from ..kernels.flash_decode import default_kv_block
        if self.cfg.frontend != "none":
            raise ValueError(
                "ContinuousEngine serves token prompts; vision/audio "
                "frontends need per-request frame/patch embeddings the "
                "request queue does not carry")
        kinds = PagedKVPool.page_kinds(self.cfg)
        self.device = resolve_device(self.device)
        self.params = _serving_params(self.params, self.cfg, self.policy,
                                      self.device)
        kv_group = self.policy.group_size if self.policy else None
        if self.page_size is None:
            self.page_size = default_kv_block(self.max_len)
        if self.max_len % self.page_size:
            rounded = -(-self.max_len // self.page_size) * self.page_size
            raise ValueError(
                f"max_len={self.max_len} must be a multiple of "
                f"page_size={self.page_size}: the page-table row maps "
                f"whole pages -- round max_len up to {rounded} or pick a "
                f"page size that divides it")
        self.max_pages_per_req = self.max_len // self.page_size
        if self.prefill_chunk_tokens is not None:
            c = self.prefill_chunk_tokens
            if c <= 0 or c % self.page_size or self.max_len % c:
                raise ValueError(
                    f"prefill_chunk_tokens={c} must be a positive "
                    f"multiple of page_size={self.page_size} that "
                    f"divides max_len={self.max_len}")
        if self.prefill_context is None:
            self.prefill_context = "pages" if self.prefix_cache else "carry"
        if self.prefill_context not in ("carry", "pages"):
            raise ValueError(self.prefill_context)
        _check_stateful_context(kinds, self.cfg, self.prefill_context)
        if self.prefix_cache and self.prefill_context == "carry":
            raise ValueError(
                "prefix_cache shares posit8 pages a hit request never "
                "forwarded itself, so its chunks can only attend to the "
                "prefix through the page table: use "
                "prefill_context='pages' (the default under prefix_cache)")
        if self.decode_steps < 1:
            raise ValueError(
                f"decode_steps={self.decode_steps} must be >= 1")
        self.metrics = MetricRegistry()
        self._trace = self.trace if self.trace is not None else NULL_RECORDER
        if self._trace.enabled and self._trace.hist_registry is None:
            self._trace.hist_registry = self.metrics
        bind_counters(self, self.metrics, "engine")
        n_slabs = 0
        if "state" in kinds:
            n_slabs = self.n_state_slabs \
                if self.n_state_slabs is not None else self.max_batch
        pool = PagedKVPool(self.cfg, self.n_pages, self.page_size, kv_group,
                           n_slabs=n_slabs, device=self.device)
        pool.register_gauges(self.metrics, "pool")
        self.scheduler = Scheduler(pool, self.max_batch,
                                   max_pages_per_req=self.max_pages_per_req,
                                   prefix_cache=self.prefix_cache,
                                   registry=self.metrics, trace=self._trace)
        self.metrics.gauge(
            "engine/kv_bytes_per_step_model",
            fn=lambda: self.pool.modeled_bytes_per_step(self.last_positions)
            if self.last_positions else 0.0)
        # the state term alone: a slab read and rewritten per live request
        self.metrics.gauge(
            "engine/state_bytes_per_step_model",
            fn=lambda: 2.0 * state_slab_bytes(self.cfg, kv_group)
            * len(self.last_positions) if self.pool.has_state else 0.0)
        self._chunk_step = build_prefill_chunk_step(self.cfg, kv_group)
        # the paged-context step is attention-only (its constructor rejects
        # stateful families), so it exists only when selected
        self._chunk_step_paged = build_prefill_chunk_step(
            self.cfg, kv_group, paged=True) \
            if self.prefill_context == "pages" else None
        # bf16 carries of requests mid-prefill (rid -> {"k", "v"})
        self._prefill_ctx: Dict[int, Any] = {}
        self._decode_loop = _build_decode_loop(
            self.cfg, self.temperature, self.decode_steps, self.seed)
        self._pt_cache = _PageTableCache()
        # positions the LAST decode dispatch started from ([] if none)
        self.last_positions: List[int] = []
        # rids admitted by the LAST step
        self.last_admitted: List[int] = []

    @property
    def pool(self):
        return self.scheduler.pool

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None) -> int:
        """Queue one request; returns its id (the scheduler validates
        that it fits the pool and the ``max_len`` page-table row)."""
        return self.scheduler.submit(
            prompt, max_new_tokens,
            eos_id if eos_id is not None else self.eos_id)

    def step(self) -> int:
        """One engine step: capacity for the running batch FIRST, then
        admission, chunked prefill within the token budget, ONE K-step
        decode dispatch for everyone running, retirement.  Returns the
        decoded request count.  The engine's recorder is the active one
        (``obs.recording``) for the step, so the forward's spans land
        there."""
        sched = self.scheduler
        tr = self._trace
        with recording(tr), tr.span("step"):
            with tr.span("capacity"):
                for req in list(sched.running):
                    if req.status == RUNNING:  # a victim may drop mid-loop
                        sched.ensure_capacity(
                            req,
                            horizon=_decode_horizon(req, self.decode_steps))
            with tr.span("admit"):
                self.last_admitted = [r.rid for r in sched.admit()]
            with tr.span("prefill"):
                for req in self._prefill_phase():
                    if req.done:
                        sched.retire(req)
            running = []
            for req in list(sched.running):
                if req.status == RUNNING and sched.ensure_capacity(
                        req, horizon=_decode_horizon(req, self.decode_steps)):
                    running.append(req)
            self.last_positions = [req.position for req in running]
            if not running:
                return 0
            with tr.span("decode_dispatch"):
                disp = _dispatch_decode_loop(
                    self._decode_loop, self.params, self.pool, running,
                    self.max_batch, self._pt_cache, sched.epoch,
                    self.max_pages_per_req,
                    self.sync_guard and self.device.type == "cuda")
            self.decode_dispatches += 1
            self.page_table_uploads += disp["uploaded"]
            tr.event("DECODE_DISPATCH", batch=len(running),
                     k=self.decode_steps, uploaded=disp["uploaded"])
            with tr.span("decode_sync"):
                # the ONE (B, K) host sync of the step
                toks = disp["toks_dev"].cpu().numpy()
            self.token_host_bytes += toks.nbytes
            tr.event("DECODE_SYNC", token_bytes=toks.nbytes)
            n = _apply_decode_tokens(disp, toks, sched.retire)
            self.steps_run += 1
            return n

    def reset_counters(self) -> None:
        """Zero every run counter of the engine, scheduler and prefix
        index, and the registry's histograms; the pool's current
        allocation becomes the new peak baseline."""
        for c in self._COUNTERS:
            setattr(self, c, 0)
        self.pool.alloc_peak = self.pool.used_pages
        self.scheduler.reset_counters()
        self.metrics.reset()

    def run(self, max_steps: int = 100000) -> Dict[int, np.ndarray]:
        """Step until every submitted request finished; returns
        {rid: prompt+generated}."""
        steps = 0
        while self.scheduler.has_work:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("continuous engine failed to drain")
        return {rid: req.output
                for rid, req in self.scheduler.finished.items()}
