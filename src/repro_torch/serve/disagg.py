"""Disaggregated prefill/decode serving over a posit8 page handoff (the
counterpart of ``repro.serve.disagg``).

The interleaved ``ContinuousEngine`` runs each prefill chunk inside the
decode step's critical path.  This module splits the engine in two:

  ``PrefillWorker``   owns its own posit8 page pool and the chunk-budget
                      admitter (admission, chunk pacing, prefix-cache
                      hits, mid-prefill preemption).  When a request's
                      prefill completes, its pages are EXPORTED (posit8
                      codes + po2 group scales: the wire format is the
                      pool format) and the request parks until the
                      handoff channel has room.
  ``PageHandoffChannel``
                      a depth-bounded (default 2) queue of ``(request,
                      payload)`` pairs; a payload is the gathered page
                      leaves (``paged_kv.page_handoff_bytes`` a page),
                      copied to the decode worker's device on push.
  ``DecodeWorker``    owns its own pool and the K-step decode loop of the
                      continuous engine, fed only by imported handoffs.
                      Imported pages scatter bitwise into its pool; the
                      ``DecodeRunner`` keeps the mapping epoch, so the
                      page table stays cached across handoffs that do not
                      change the batch.

``DisaggEngine.step`` overlaps the two: the decode dispatch is issued
first, the prefill worker then runs a whole admit/chunk/handoff step,
and only afterwards does the engine wait for the dispatch's (B, K) token
buffer.  On the card both workers issue to the current CUDA stream (the
split-K counters of ``rmmec_matmul`` are one array per device, so its
calls must reach the card on one stream at a time): the overlap is the
host's, which issues the prefill step's launches while the card runs the
decode loop.  ``dispatch`` therefore ends with a non-blocking copy of
the token buffer into pinned host memory and a CUDA event, and ``sync``
waits on that event only, not on the prefill work queued after it.
``last_decode_step_s`` times the dispatch and sync halves only.

Backpressure is structural: a completed prefill parks holding its
prefill pages and its admitter slot until the channel drains, a full
channel blocks further exports, and a handoff stays queued until the
decode pool can allocate its pages.  When the decode pool runs dry
mid-decode the runner BOUNCES its youngest request back to the
admitter's queue front (``Scheduler.reaccept``), where it re-prefills
prompt+generated and crosses the channel again.  ``submit`` rejects a
request whose total footprint cannot fit the decode pool, so a lone
bounced request always fits on retry.

PARITY: at temperature 0 the outputs are token for token those of the
interleaved ``ContinuousEngine`` (the same chunk code through
``_ChunkPrefillMixin``, the same dispatch/replay code through
``_dispatch_decode_loop``/``_apply_decode_tokens``, bitwise page
export/import, and a sampler keyed on (seed, rid, token index)).
Recurrent and hybrid families hand off their state slab with their
pages: the payload is then ``{"state": export_state(slab)[, "kv":
export_pages(pages)]}``, and the decode side allocates a slab (rolling
back its pages if none is free) before importing it.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..core.policy import PrecisionPolicy
from ..obs import NULL_RECORDER, MetricRegistry, bind_counters, recording
from .engine import (_apply_decode_tokens, _build_decode_loop,
                     _check_stateful_context, _ChunkPrefillMixin,
                     _decode_horizon, _dispatch_decode_loop,
                     _PageTableCache, _serving_params,
                     build_prefill_chunk_step)
from .paged_kv import PagedKVPool, _leaves, _tree_map
from .scheduler import RUNNING, DecodeRunner, Request, Scheduler

__all__ = ["PageHandoffChannel", "PrefillWorker", "DecodeWorker",
           "DisaggEngine"]


class PageHandoffChannel:
    """Depth-bounded queue of completed prefills crossing from the
    prefill worker to the decode worker.

    Each entry is ``(request, payload)``, the payload the request's
    gathered pool leaves (``PagedKVPool.export_pages``): the handoff
    moves the compressed cache, never a bf16 one.  A stateful family's
    payload is the nested ``{"state": ..., "kv": ...}`` (``"kv"`` only
    for a hybrid), so a request's slab crosses in the same entry.  ``depth`` bounds the
    prefills in flight; a full channel parks further completions on the
    prefill side, holding their pages and batch slots.  ``push`` copies
    the payload to ``device`` (the decode worker's) without blocking."""

    _COUNTERS = ("handoffs",        # payloads pushed
                 "handoff_pages",   # pages moved
                 "handoff_bytes")   # bytes moved (sum of the leaves' sizes)

    def __init__(self, depth: int = 2, device=None,
                 registry: Optional[MetricRegistry] = None,
                 trace=None, namespace: str = "channel"):
        if depth < 1:
            raise ValueError(f"channel depth {depth} must be >= 1")
        self.depth = int(depth)
        self.device = device
        self._q: Deque[Tuple[Request, Dict[str, torch.Tensor]]] = deque()
        self.metrics = registry if registry is not None else MetricRegistry()
        self._trace = trace if trace is not None else NULL_RECORDER
        bind_counters(self, self.metrics, namespace)

    def reset_counters(self) -> None:
        for c in self._COUNTERS:
            setattr(self, c, 0)

    def __len__(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        return len(self._q) >= self.depth

    def push(self, req: Request,
             payload: Dict[str, torch.Tensor]) -> None:
        assert not self.full, "push on a full channel (check .full first)"
        with self._trace.span("channel_push", rid=req.rid):
            if self.device is not None:
                payload = _tree_map(
                    lambda v: v.to(self.device, non_blocking=True), payload)
        kv = payload.get("kv") if "state" in payload else payload
        pages = int(kv["k_codes"].shape[1]) if kv is not None else 0
        nbytes = sum(v.numel() * v.element_size()
                     for v in _leaves(payload))
        self.handoffs += 1
        self.handoff_pages += pages
        self.handoff_bytes += nbytes
        self._trace.event("HANDOFF", rid=req.rid, pages=pages, bytes=nbytes)
        self._q.append((req, payload))

    def peek(self) -> Tuple[Request, Dict[str, torch.Tensor]]:
        return self._q[0]

    def pop(self) -> Tuple[Request, Dict[str, torch.Tensor]]:
        return self._q.popleft()


class PrefillWorker(_ChunkPrefillMixin):
    """The prefill half: the continuous engine's chunk-budget admitter
    over its own posit8 pool, exporting completed prefills into the
    handoff channel.

    It runs the interleaved engine's chunk code (``_ChunkPrefillMixin``).
    A completed prefill (first token sampled, PREFILLING -> RUNNING)
    parks on ``_ready`` until the channel has room; parked requests still
    hold their pages and admitter slots and remain preemption victims --
    a preempted parked request drops off ``_ready`` and parks again after
    its re-prefill."""

    _COUNTERS = ("prefill_tokens_computed",)

    def __init__(self, cfg: ModelConfig, params: Any, n_pages: int,
                 page_size: int, max_batch: int, max_pages_per_req: int,
                 kv_group: Optional[int], temperature: float, seed: int,
                 prefill_chunk_tokens: Optional[int], prefill_context: str,
                 prefix_cache: bool, device,
                 registry: Optional[MetricRegistry] = None, trace=None):
        self.cfg = cfg
        self.params = params
        self.device = device
        self.page_size = page_size
        self.max_pages_per_req = max_pages_per_req
        self.temperature = temperature
        self.seed = seed
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.prefill_context = prefill_context
        self.metrics = registry if registry is not None else MetricRegistry()
        self._trace = trace if trace is not None else NULL_RECORDER
        n_slabs = max_batch \
            if "state" in PagedKVPool.page_kinds(cfg) else 0
        pool = PagedKVPool(cfg, n_pages, page_size, kv_group,
                           n_slabs=n_slabs, device=device)
        pool.register_gauges(self.metrics, "prefill/pool")
        self.scheduler = Scheduler(pool, max_batch,
                                   max_pages_per_req=max_pages_per_req,
                                   prefix_cache=prefix_cache,
                                   registry=self.metrics, trace=self._trace,
                                   namespace="prefill/scheduler")
        self._chunk_step = build_prefill_chunk_step(cfg, kv_group)
        # the paged context is attention-only (DisaggEngine rejects it for
        # stateful families), so the step exists only when selected
        self._chunk_step_paged = build_prefill_chunk_step(
            cfg, kv_group, paged=True) if prefill_context == "pages" else None
        self._prefill_ctx: Dict[int, Any] = {}
        self._ready: List[Request] = []       # completed, awaiting channel
        bind_counters(self, self.metrics, "prefill")

    @property
    def pool(self) -> PagedKVPool:
        return self.scheduler.pool

    def reset_counters(self) -> None:
        for c in self._COUNTERS:
            setattr(self, c, 0)
        self.pool.alloc_peak = self.pool.used_pages
        self.scheduler.reset_counters()

    def _drain_ready(self, channel: PageHandoffChannel) -> int:
        """Export parked completions into the channel, oldest first,
        until it fills.  Export before release: the payload is a copy, so
        it stays valid after the source pages (and slab) return to the
        free lists (prefix-shared pages just decref back to the index).
        A stateful family exports its slab, plus its pages for a
        hybrid."""
        sent = 0
        while self._ready:
            req = self._ready[0]
            if req.status != RUNNING:
                # preempted while parked: the admitter already freed its
                # pages and requeued it; it parks again after re-prefill
                self._ready.pop(0)
                continue
            if channel.full:
                break
            if self.pool.has_state:
                payload: Dict = {"state": self.pool.export_state(req.slab)}
                if req.pages:
                    payload["kv"] = self.pool.export_pages(req.pages)
            else:
                payload = self.pool.export_pages(req.pages)
            self.scheduler.release(req)
            channel.push(req, payload)
            self._ready.pop(0)
            sent += 1
        return sent

    def step(self, channel: PageHandoffChannel) -> int:
        """One prefill-side step: drain parked completions, admit, run the
        chunk budget, park or retire this step's completions, drain
        again.  Returns handoffs pushed.  The worker's recorder is the
        active one (``obs.recording``) for the step."""
        with recording(self._trace):
            sent = self._drain_ready(channel)
            for req in self.scheduler.admit():
                if req.status == RUNNING:
                    # a resumed snapshot (a bounced stateful request): its
                    # state (+ KV) is back, nothing to prefill -- park it
                    # for the handoff straight away
                    self._ready.append(req)
            for req in self._prefill_phase():
                if req.done:
                    # budget of 1 / instant EOS: never needs a decode side
                    self.scheduler.retire(req)
                else:
                    self._ready.append(req)
            return sent + self._drain_ready(channel)


class DecodeWorker:
    """The decode half: the continuous engine's K-step decode loop over
    its own posit8 pool, fed only by imported page handoffs.

    ``dispatch`` and ``sync`` are split so the engine can run the prefill
    step between them: ``dispatch`` issues the loop and a non-blocking
    copy of its (B, K) token buffer to pinned host memory followed by a
    CUDA event; ``sync`` waits on that event and replays the done-logic.
    Both run the interleaved engine's ``_dispatch_decode_loop`` /
    ``_apply_decode_tokens``."""

    _COUNTERS = ("decode_dispatches",   # decode-loop calls
                 "page_table_uploads",  # (B, NP) host->device uploads
                 "token_host_bytes")    # device->host sampled-token sync

    def __init__(self, cfg: ModelConfig, params: Any, n_pages: int,
                 page_size: int, max_batch: int, max_pages_per_req: int,
                 kv_group: Optional[int], temperature: float, seed: int,
                 decode_steps: int, device, sync_guard: bool = False,
                 registry: Optional[MetricRegistry] = None, trace=None):
        self.params = params
        self.device = device
        self.max_batch = max_batch
        self.max_pages_per_req = max_pages_per_req
        self.decode_steps = decode_steps
        self.sync_guard = sync_guard
        self.metrics = registry if registry is not None else MetricRegistry()
        self._trace = trace if trace is not None else NULL_RECORDER
        n_slabs = max_batch \
            if "state" in PagedKVPool.page_kinds(cfg) else 0
        pool = PagedKVPool(cfg, n_pages, page_size, kv_group,
                           n_slabs=n_slabs, device=device)
        pool.register_gauges(self.metrics, "decode/pool")
        self.runner = DecodeRunner(pool, max_batch, registry=self.metrics,
                                   trace=self._trace,
                                   namespace="decode/runner")
        self._decode_loop = _build_decode_loop(cfg, temperature,
                                               decode_steps, seed)
        self._pt_cache = _PageTableCache()
        # the pinned (B, K) landing buffer of the token copy (card only)
        self._toks_host: Optional[torch.Tensor] = None
        self.last_positions: List[int] = []
        bind_counters(self, self.metrics, "decode")

    @property
    def pool(self) -> PagedKVPool:
        return self.runner.pool

    def reset_counters(self) -> None:
        for c in self._COUNTERS:
            setattr(self, c, 0)
        self.pool.alloc_peak = self.pool.used_pages
        self.runner.reset_counters()

    def admit_handoffs(self, channel: PageHandoffChannel) -> int:
        """Import queued handoffs while a batch slot AND pool pages are
        available.  A handoff the pool cannot place stays queued (the
        channel is the buffer): head-of-line blocking here is the
        backpressure that parks the prefill side rather than thrashing
        decode with bounces."""
        took = 0
        while len(channel) and self.runner.has_slot:
            req, payload = channel.peek()
            nested = "state" in payload
            kv = payload.get("kv") if nested else payload
            n = int(kv["k_codes"].shape[1]) if kv is not None else 0
            pages = self.pool.alloc(n) if n else []
            if pages is None:
                break                     # decode pool dry: retry next step
            slab = None
            if nested:
                slab = self.pool.alloc_slab()
                if slab is None:          # state plane dry: roll back
                    if pages:
                        self.pool.free(pages)
                    break
            with self._trace.span("channel_pull", rid=req.rid):
                if kv is not None:
                    self.pool.import_pages(kv, pages)
                if nested:
                    self.pool.import_state(payload["state"], slab)
            self.runner.accept(req, pages, slab)
            channel.pop()
            took += 1
        return took

    def dispatch(self):
        """Issue one K-step decode dispatch for everyone running (after
        claiming each request's decode window, bouncing the youngest on
        pool exhaustion), then the token copy.  Returns the in-flight
        dispatch record, or None if nothing decoded."""
        runner = self.runner
        running = []
        for req in list(runner.running):
            if req.status == RUNNING and runner.ensure_capacity(
                    req, horizon=_decode_horizon(req, self.decode_steps)):
                running.append(req)
        self.last_positions = [req.position for req in running]
        if not running:
            return None
        disp = _dispatch_decode_loop(
            self._decode_loop, self.params, self.pool, running,
            self.max_batch, self._pt_cache, runner.epoch,
            self.max_pages_per_req,
            self.sync_guard and self.device.type == "cuda")
        toks_dev = disp["toks_dev"]
        if toks_dev.is_cuda:
            if self._toks_host is None:
                self._toks_host = torch.empty(
                    toks_dev.shape, dtype=toks_dev.dtype, pin_memory=True)
            self._toks_host.copy_(toks_dev, non_blocking=True)
            disp["ready"] = torch.cuda.Event()
            disp["ready"].record()
        self.decode_dispatches += 1
        self.page_table_uploads += disp["uploaded"]
        self._trace.event("DECODE_DISPATCH", batch=len(running),
                          k=self.decode_steps, uploaded=disp["uploaded"])
        return disp

    def sync(self, disp) -> int:
        """Wait for a dispatch's (B, K) tokens and replay the device
        done-logic; retires finished requests to the runner.  Returns the
        decoded request count."""
        if disp is None:
            return 0
        if "ready" in disp:
            # the decode side's one (B, K) host sync: the loop and the
            # copy only, not the prefill work queued after them
            disp["ready"].synchronize()
            toks = self._toks_host.numpy()
        else:
            toks = disp["toks_dev"].numpy()
        self.token_host_bytes += toks.nbytes
        self._trace.event("DECODE_SYNC", token_bytes=toks.nbytes)
        return _apply_decode_tokens(disp, toks, self.runner.retire)


@dataclasses.dataclass
class DisaggEngine:
    """Disaggregated prefill/decode serving engine (see the module doc).

    A drop-in for ``ContinuousEngine`` at the submit/step/run level; the
    pool splits into ``prefill_pages`` + ``decode_pages`` (two pools) and
    ``channel_depth`` bounds the prefills in flight across the handoff.
    ``prefill_device`` / ``decode_device`` place the workers (None: the
    card).  ``last_decode_step_s`` is the previous step's decode-side
    wall time EXCLUDING the prefill step run between dispatch and sync.
    ``sync_guard`` runs each decode loop under the port's sync guard on a
    CUDA device."""

    cfg: ModelConfig
    params: Any
    prefill_pages: int = 64
    decode_pages: int = 64
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
    channel_depth: int = 2
    prefill_device: Any = None
    decode_device: Any = None
    trace: Any = None
    sync_guard: bool = False

    _COUNTERS = ("steps_run",)

    def __post_init__(self):
        from ..kernels.flash_decode import default_kv_block
        if self.cfg.frontend != "none":
            raise ValueError(
                "DisaggEngine serves token prompts; vision/audio "
                "frontends need per-request frame/patch embeddings the "
                "request queue does not carry")
        kinds = PagedKVPool.page_kinds(self.cfg)
        self.prefill_device = resolve_device(self.prefill_device)
        self.decode_device = resolve_device(self.decode_device)
        kv_group = self.policy.group_size if self.policy else None
        if self.page_size is None:
            self.page_size = default_kv_block(self.max_len)
        if self.max_len % self.page_size:
            rounded = -(-self.max_len // self.page_size) * self.page_size
            raise ValueError(
                f"max_len={self.max_len} must be a multiple of "
                f"page_size={self.page_size} (round up to {rounded})")
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
                "prefix_cache needs prefill_context='pages' (shared "
                "posit8 pages are only readable through the page table)")
        if self.decode_steps < 1:
            raise ValueError(
                f"decode_steps={self.decode_steps} must be >= 1")
        # one registry + recorder spans the engine and both workers
        self.metrics = MetricRegistry()
        self._trace = self.trace if self.trace is not None else NULL_RECORDER
        if self._trace.enabled and self._trace.hist_registry is None:
            self._trace.hist_registry = self.metrics
        bind_counters(self, self.metrics, "engine")
        params_p = _serving_params(self.params, self.cfg, self.policy,
                                   self.prefill_device)
        params_d = params_p if self.decode_device == self.prefill_device \
            else _serving_params(self.params, self.cfg, self.policy,
                                 self.decode_device)
        self.prefill = PrefillWorker(
            self.cfg, params_p, self.prefill_pages, self.page_size,
            self.max_batch, self.max_pages_per_req, kv_group,
            self.temperature, self.seed, self.prefill_chunk_tokens,
            self.prefill_context, self.prefix_cache, self.prefill_device,
            registry=self.metrics, trace=self._trace)
        self.decode = DecodeWorker(
            self.cfg, params_d, self.decode_pages, self.page_size,
            self.max_batch, self.max_pages_per_req, kv_group,
            self.temperature, self.seed, self.decode_steps,
            self.decode_device, sync_guard=self.sync_guard,
            registry=self.metrics, trace=self._trace)
        self.channel = PageHandoffChannel(self.channel_depth,
                                          device=self.decode_device,
                                          registry=self.metrics,
                                          trace=self._trace)
        # the decode side's critical path (dispatch + sync) per step
        self._step_hist = self.metrics.histogram("engine/decode_step_ms")
        self.last_decode_step_s = 0.0

    # -- request intake -----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None) -> int:
        """Queue one request; returns its id.  Beyond the admitter's own
        checks, the request's TOTAL footprint must fit the decode pool
        alone: a bounced request retries against an otherwise empty
        decode side, so this is the no-livelock guarantee."""
        prompt_arr = np.asarray(prompt, np.int32).reshape(-1)
        need = self.decode.pool.pages_for(
            prompt_arr.size + int(max_new_tokens))
        if need > self.decode.pool.n_pages:
            raise ValueError(
                f"request needs {need} pages but the decode pool only "
                f"has {self.decode.pool.n_pages}: raise decode_pages or "
                f"shorten the request")
        return self.prefill.scheduler.submit(
            prompt_arr, max_new_tokens,
            eos_id if eos_id is not None else self.eos_id)

    # -- one engine step ----------------------------------------------------

    def step(self) -> int:
        """One disaggregated step, in the order of the overlap:

          1. import queued handoffs (they must land before the dispatch
             so a new arrival decodes this step),
          2. issue the decode dispatch,
          3. hand bounced decode requests back to the admitter,
          4. run a whole prefill-side step (admit / chunks / handoff)
             while the card runs the decode loop,
          5. wait for the dispatch's tokens and retire.

        ``last_decode_step_s`` sums (2) and (5) only.  Returns the
        decoded request count."""
        tr = self._trace
        with recording(tr), tr.span("step"):
            with tr.span("admit"):
                self.decode.admit_handoffs(self.channel)
            t0 = time.perf_counter()
            with tr.span("decode_dispatch"):
                disp = self.decode.dispatch()
            t1 = time.perf_counter()
            for req in self.decode.runner.drain_bounced():
                self.prefill.scheduler.reaccept(req)
            with tr.span("prefill"):
                self.prefill.step(self.channel)
            t2 = time.perf_counter()
            with tr.span("decode_sync"):
                n = self.decode.sync(disp)
            t3 = time.perf_counter()
            self.last_decode_step_s = (t1 - t0) + (t3 - t2)
            self._step_hist.observe(self.last_decode_step_s * 1e3)
            self.steps_run += 1
            return n

    # -- aggregate views ----------------------------------------------------

    @property
    def finished(self) -> Dict[int, Request]:
        """rid -> finished request, across both sides (instant-done
        requests retire on the prefill side and never cross)."""
        return {**self.prefill.scheduler.finished,
                **self.decode.runner.finished}

    @property
    def has_work(self) -> bool:
        return (self.prefill.scheduler.has_work or len(self.channel) > 0
                or bool(self.decode.runner.running))

    @property
    def prefill_tokens_computed(self) -> int:
        return self.prefill.prefill_tokens_computed

    @property
    def decode_dispatches(self) -> int:
        return self.decode.decode_dispatches

    @property
    def page_table_uploads(self) -> int:
        return self.decode.page_table_uploads

    @property
    def token_host_bytes(self) -> int:
        return self.decode.token_host_bytes

    @property
    def handoffs(self) -> int:
        return self.channel.handoffs

    @property
    def handoff_pages(self) -> int:
        return self.channel.handoff_pages

    @property
    def handoff_bytes(self) -> int:
        return self.channel.handoff_bytes

    @property
    def decode_bounces(self) -> int:
        return self.decode.runner.bounce_count

    # -- counters -----------------------------------------------------------

    def reset_counters(self) -> None:
        """Zero every run counter on every layer (engine, both workers,
        their scheduler/runner, the channel) and the registry's
        histograms."""
        for c in self._COUNTERS:
            setattr(self, c, 0)
        self.last_decode_step_s = 0.0
        self.prefill.reset_counters()
        self.decode.reset_counters()
        self.channel.reset_counters()
        self.metrics.reset()

    # -- drive to completion ------------------------------------------------

    def run(self, max_steps: int = 100000) -> Dict[int, np.ndarray]:
        """Step until every submitted request finished; returns
        {rid: prompt+generated}."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("disaggregated engine failed to drain")
        return {rid: req.output for rid, req in self.finished.items()}
