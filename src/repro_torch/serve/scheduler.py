"""Continuous-batching scheduler: FIFO admission gated on free pages,
LIFO preemption, retire-on-EOS (the counterpart of
``repro.serve.scheduler``; pure host logic, ported line for line).

The scheduler owns the REQUEST state machine and the page accounting;
it never touches the model.  The engine drives it:

  submit()          WAITING, queued FIFO.
  admit()           WAITING -> PREFILLING while a batch slot is open and
                    the pool's UNCLAIMED free pages can cover the
                    request's whole prefix plus one decode slot.  Strict
                    FIFO: a too-big head blocks the queue.  Pages are
                    claimed lazily, chunk by chunk
                    (``ensure_prefill_capacity``); the claim accounting
                    keeps co-admitted requests from fighting over the
                    same free pages.
  ensure_capacity() before every decode dispatch for each running
                    request: allocates the pages its next decode writes
                    land in.  On pool exhaustion the YOUNGEST request is
                    preempted (pages freed, re-queued at the FRONT); a
                    RUNNING victim keeps its tokens and re-prefills its
                    prefix on re-admission, a PREFILLING one restarts.
  retire()          RUNNING -> FINISHED; pages return the same step.

ORDERING CONTRACT: the engine runs ``ensure_capacity`` for the running
batch BEFORE ``admit``, so a newcomer is only admitted against pages the
running batch did not need this step.

PREFIX CACHING (``prefix_cache=True``): whole prompt-prefix pages of
completed prefills are registered in a page-aligned ``PrefixIndex`` and
SHARED read-only with later requests whose prompt starts with the same
token blocks (XR traffic repeats a scene/system preamble ahead of every
query); unreferenced cached pages are evicted LRU, leaf first, before
any request is preempted.

DISAGGREGATED SERVING (``serve/disagg.py``): the prefill side's
``Scheduler`` hands a completed prefill over with ``release`` (its pages
exported), and takes a request bounced from the decode side back at the
queue front with ``reaccept``.  ``DecodeRunner`` is the decode side's
half: accepted handoffs, horizon claims on the decode pool, bouncing the
youngest request when that pool runs dry, retirement.

RECURRENT STATE (ssm / hybrid families): a request also holds ONE state
slab for its whole lifetime, allocated at admission, so admission is
gated on a free slab too.  Preempting (or bouncing) a RUNNING stateful
request SNAPSHOTS it -- its slab, plus its KV pages for a hybrid,
exported to ``Request.resume`` -- and re-admission imports the snapshot
and goes straight back to RUNNING: nothing is re-prefilled and nothing
is charged as wasted.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..obs import NULL_RECORDER, MetricRegistry, bind_counters
from .paged_kv import PagedKVPool

__all__ = ["Request", "Scheduler", "PrefixIndex", "DecodeRunner", "WAITING",
           "PREFILLING", "RUNNING", "FINISHED"]

WAITING = "waiting"
PREFILLING = "prefilling"
RUNNING = "running"
FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One generation request and its paged-cache bookkeeping."""

    rid: int
    prompt: np.ndarray                  # (len,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    status: str = WAITING
    pages: List[int] = dataclasses.field(default_factory=list)
    generated: List[int] = dataclasses.field(default_factory=list)
    next_token: int = -1                # fed to the next decode step
    preemptions: int = 0
    prefilled: int = 0                  # chunk cursor: prefix tokens paged in
    cached_tokens: int = 0              # leading tokens served by shared pages
    slab: Optional[int] = None          # state-slab id (recurrent families)
    # preemption snapshot of a stateful request: its exported posit8
    # state (+ KV pages for hybrids); resume imports it and decodes on
    resume: Optional[Dict] = None

    @property
    def prefix(self) -> np.ndarray:
        """Tokens whose KV must be live: prompt + generated so far."""
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    @property
    def position(self) -> int:
        """Cache slot the next decode step writes."""
        return len(self.prompt) + len(self.generated) - 1

    @property
    def done(self) -> bool:
        if self.generated and self.eos_id is not None \
                and self.generated[-1] == self.eos_id:
            return True
        return len(self.generated) >= self.max_new_tokens

    @property
    def output(self) -> np.ndarray:
        return self.prefix


@dataclasses.dataclass
class _PrefixEntry:
    """One cached whole-page prompt block: its pool page, its parent
    digest, the EXACT tokens of its block (the collision guard), its
    chain depth and how many cached children extend it."""

    page: int
    parent: Optional[int]
    block: Tuple[int, ...]
    depth: int
    children: int = 0


class PrefixIndex:
    """Page-aligned prefix cache: whole-page prompt token blocks ->
    shared pool pages, with LRU leaf-first eviction.

    Keys form a DIGEST CHAIN ``key_i = hash((key_{i-1}, block_i))``; every
    entry stores its exact ``(parent, block)`` and a lookup verifies
    both, so a collision degrades to a miss.  The index holds its OWN
    reference on every cached page; a cached page at refcount 1 is the
    only kind eviction may take.  ``hits``/``hit_tokens`` count per
    ADMISSION."""

    _COUNTERS = ("hits",          # admissions served by cached pages
                 "hit_tokens",    # prefill tokens served cached
                 "misses",        # prefix-enabled admissions with no match
                 "evictions")

    def __init__(self, pool: PagedKVPool,
                 registry: Optional[MetricRegistry] = None,
                 namespace: str = "prefix"):
        self.pool = pool
        self._entries: "OrderedDict[int, _PrefixEntry]" = OrderedDict()
        self.metrics = registry if registry is not None else MetricRegistry()
        bind_counters(self, self.metrics, namespace)
        self.metrics.gauge(
            f"{namespace}/hit_rate",
            fn=lambda: self.hits / max(self.hits + self.misses, 1))

    def reset_counters(self) -> None:
        for c in self._COUNTERS:
            setattr(self, c, 0)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def cached_pages(self) -> List[int]:
        return [e.page for e in self._entries.values()]

    @staticmethod
    def _blocks(prompt: np.ndarray, psize: int, n: int):
        """The first ``n`` whole-page token blocks of ``prompt`` as the
        digest-chain walk ``(key, parent_key, block_tokens, index)``."""
        key = None
        for i in range(n):
            blk = tuple(int(t) for t in prompt[i * psize:(i + 1) * psize])
            parent, key = key, hash((key, blk))
            yield key, parent, blk, i

    def _lookup(self, key: int, parent: Optional[int],
                blk: Tuple[int, ...]) -> Optional[_PrefixEntry]:
        entry = self._entries.get(key)
        if entry is not None and entry.parent == parent \
                and entry.block == blk:
            return entry
        return None

    def match(self, prompt: np.ndarray) -> List[int]:
        """Keys of the longest cached chain of whole prompt pages, CAPPED
        at the page strictly before the one holding the prompt's last
        token (a hit always recomputes at least one prompt token)."""
        psize = self.pool.page_size
        keys = []
        for key, parent, blk, _ in self._blocks(
                prompt, psize, (len(prompt) - 1) // psize):
            if self._lookup(key, parent, blk) is None:
                break
            keys.append(key)
        return keys

    def acquire(self, prompt: np.ndarray) -> List[int]:
        """Attach the matched prefix: one new reference per shared page,
        entries bumped to MRU.  Returns the pages in logical order."""
        keys = self.match(prompt)
        pages = [self._entries[k].page for k in keys]
        self.pool.incref(pages)
        for k in keys:
            self._entries.move_to_end(k)
        return pages

    def insert(self, prompt: np.ndarray, pages: List[int]) -> None:
        """Register every whole prompt page of a completed prefill; blocks
        already cached are bumped to MRU, and a collision ends the chain."""
        psize = self.pool.page_size
        for key, parent, blk, i in self._blocks(prompt, psize,
                                                len(prompt) // psize):
            entry = self._entries.get(key)
            if entry is None:
                self.pool.incref([pages[i]])
                self._entries[key] = _PrefixEntry(pages[i], parent, blk,
                                                  i + 1)
                if parent is not None:
                    self._entries[parent].children += 1
            elif entry.parent != parent or entry.block != blk:
                break
            self._entries.move_to_end(key)

    def evict(self, n: int) -> int:
        """Free up to ``n`` cached pages nobody else references, LRU among
        the LEAVES of the prefix chains.  Returns how many were freed."""
        freed = 0
        while freed < n:
            victim = next(
                (key for key, e in self._entries.items()
                 if e.children == 0 and self.pool.refcount(e.page) == 1),
                None)
            if victim is None:
                break
            entry = self._entries.pop(victim)
            if entry.parent is not None:
                self._entries[entry.parent].children -= 1
            self.pool.free([entry.page])
            self.evictions += 1
            freed += 1
        return freed

    def reclaimable_pages(self) -> int:
        """How many cached pages eviction could hand back right now."""
        blocked = {key: 0 for key in self._entries}
        n = 0
        for key in sorted(self._entries,
                          key=lambda k: -self._entries[k].depth):
            e = self._entries[key]
            if self.pool.refcount(e.page) == 1 and blocked[key] == 0:
                n += 1
            elif e.parent is not None:
                blocked[e.parent] += 1
        return n


def _snapshot(pool: PagedKVPool, req: Request) -> Dict:
    """The exact-resume payload of a RUNNING stateful request: its slab,
    plus its KV pages for a hybrid (both copies, valid once freed)."""
    snap: Dict = {"state": pool.export_state(req.slab)}
    if req.pages:
        snap["kv"] = pool.export_pages(req.pages)
    return snap


class Scheduler:
    """FIFO admission + LIFO preemption over a shared ``PagedKVPool``."""

    _COUNTERS = ("preemption_count",
                 "prefill_preemptions",   # victims dropped mid-prefill
                 "wasted_prefill_tokens")  # prefix KV tossed by preemption

    def __init__(self, pool: PagedKVPool, max_batch: int,
                 max_pages_per_req: Optional[int] = None,
                 prefix_cache: bool = False,
                 registry: Optional[MetricRegistry] = None,
                 trace=None,
                 namespace: str = "scheduler"):
        self.pool = pool
        self.max_batch = int(max_batch)
        # widest page-table row of the engine's fixed-shape decode step
        self.max_pages_per_req = max_pages_per_req
        self.metrics = registry if registry is not None else MetricRegistry()
        self._trace = trace if trace is not None else NULL_RECORDER
        self.prefix = PrefixIndex(pool, registry=self.metrics,
                                  namespace=f"{namespace}/prefix") \
            if prefix_cache else None
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []      # admission order
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0
        bind_counters(self, self.metrics, namespace)
        self.preempted_log: List[int] = []    # rids, in preemption order
        self.retired_log: List[int] = []      # rids, in retirement order
        # bumped on every transition that can change a page-table row;
        # the engine re-uploads its device page table only when it moves
        self.epoch = 0

    def reset_counters(self) -> None:
        """Zero the run counters and logs (the prefix index's too)."""
        for c in self._COUNTERS:
            setattr(self, c, 0)
        self.preempted_log.clear()
        self.retired_log.clear()
        if self.prefix is not None:
            self.prefix.reset_counters()

    # -- queue --------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0 or max_new_tokens < 1:
            raise ValueError("a request needs a prompt and max_new_tokens "
                             ">= 1")
        total = prompt.size + int(max_new_tokens)
        need = self.pool.pages_for(total)
        if need > self.pool.n_pages:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.pool.n_pages}: raise n_pages or shorten the request")
        if self.max_pages_per_req is not None \
                and need > self.max_pages_per_req:
            raise ValueError(
                f"prompt+new = {total} exceeds max_len="
                f"{self.max_pages_per_req * self.pool.page_size} "
                f"({need} pages > the {self.max_pages_per_req}-page "
                f"table row of the engine's decode step)")
        # a recurrent/hybrid request needs one state slab for its whole
        # lifetime, so a pool without any can never serve it
        if self.pool.has_state and self.pool.n_slabs < 1:
            raise ValueError(
                f"family {self.pool.cfg.family!r} keeps per-request "
                f"recurrent state, but the pool has n_slabs=0: size the "
                f"pool with at least one state slab")
        req = Request(self._next_rid, prompt, int(max_new_tokens), eos_id)
        self._next_rid += 1
        self.waiting.append(req)
        self._trace.event("SUBMIT", rid=req.rid,
                          prompt_tokens=int(prompt.size),
                          max_new_tokens=int(max_new_tokens))
        return req.rid

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- admission ----------------------------------------------------------

    def _admission_budget(self) -> int:
        """Free pages, plus what prefix-cache eviction could reclaim, minus
        the outstanding claims of already-admitted PREFILLING requests."""
        budget = self.pool.free_pages
        if self.prefix is not None:
            budget += self.prefix.reclaimable_pages()
        for r in self.running:
            if r.status == PREFILLING:
                claim = self.pool.pages_for(len(r.prefix) + 1) - len(r.pages)
                budget -= max(claim, 0)
        return budget

    def admit(self) -> List[Request]:
        """Move FIFO-head requests to PREFILLING while a batch slot is
        open and the budget covers the NEW pages the head still needs
        (under prefix caching, after attaching its cached prefix)."""
        admitted = []
        while self.waiting and len(self.running) < self.max_batch:
            head = self.waiting[0]
            if head.resume is not None:
                # a preemption snapshot: import it and go straight back
                # to RUNNING; the head blocks (strict FIFO) until it fits
                if not self._admit_resume(head):
                    break
                self.waiting.popleft()
                self.running.append(head)
                admitted.append(head)
                self._trace.event("RESUME", rid=head.rid,
                                  generated=len(head.generated))
                continue
            # a stateful head needs its ONE slab now (admitted requests
            # hold theirs already, so free_slabs is the whole claim)
            if self.pool.has_state and self.pool.free_slabs < 1:
                break
            shared = self.prefix.acquire(head.prompt) \
                if self.prefix is not None else []
            need = self.pool.pages_for(len(head.prefix) + 1) - len(shared)
            if need > self._admission_budget():
                if shared:
                    self.pool.free(shared)   # detach: head stays queued
                break                    # head-of-line blocks: strict FIFO
            self.waiting.popleft()
            head.status = PREFILLING
            head.pages = list(shared)
            if self.pool.has_state:
                head.slab = self.pool.alloc_slab()
            head.cached_tokens = len(shared) * self.pool.page_size
            head.prefilled = head.cached_tokens
            if shared:
                self.prefix.hits += 1
                self.prefix.hit_tokens += head.cached_tokens
            elif self.prefix is not None:
                self.prefix.misses += 1
            self.running.append(head)
            admitted.append(head)
            self._trace.event("ADMIT", rid=head.rid,
                              cached_tokens=head.cached_tokens)
        if admitted:
            self.epoch += 1
        return admitted

    def _admit_resume(self, head: Request) -> bool:
        """Import a preemption snapshot: allocate the pages and slab it
        needs, write the payload back, RUNNING.  False (nothing changed)
        if the pool cannot host it yet."""
        snap = head.resume
        kv = snap.get("kv")
        n = int(kv["k_codes"].shape[1]) if kv is not None else 0
        if n > self._admission_budget():
            return False
        if self.pool.has_state and self.pool.free_slabs < 1:
            return False
        pages: List[int] = []
        if n:
            if self.prefix is not None and self.pool.free_pages < n:
                self.prefix.evict(n - self.pool.free_pages)
            got = self.pool.alloc(n)
            if got is None:
                return False
            pages = got
        slab = self.pool.alloc_slab() if self.pool.has_state else None
        if kv is not None:
            self.pool.import_pages(kv, pages)
        if "state" in snap:
            self.pool.import_state(snap["state"], slab)
        head.pages = pages
        head.slab = slab
        head.resume = None
        head.status = RUNNING
        return True

    def prefill_complete(self, req: Request) -> None:
        """PREFILLING -> RUNNING; under prefix caching the request's whole
        prompt pages register in the index here."""
        assert req.status == PREFILLING, req.status
        req.status = RUNNING
        self.epoch += 1
        if self.prefix is not None:
            self.prefix.insert(req.prompt, req.pages)
        self._trace.event("PREFILL_COMPLETE", rid=req.rid,
                          prompt_tokens=len(req.prompt),
                          cached_tokens=req.cached_tokens)

    # -- capacity / preemption ----------------------------------------------

    def _grow(self, req: Request, need_pages: int) -> bool:
        """Grow ``req``'s page list to ``need_pages``: free list first,
        then prefix-cache eviction, then preempt the youngest request.
        False if ``req`` itself was preempted."""
        grew = False
        while need_pages > len(req.pages):
            got = self.pool.alloc(1)
            if got is not None:
                req.pages.extend(got)
                grew = True
                continue
            if self.prefix is not None and self.prefix.evict(1):
                continue
            victim = self.running[-1]    # youngest admitted
            self.preempt(victim)
            if victim is req:
                return False
        if grew:
            self.epoch += 1
        return True

    def ensure_capacity(self, req: Request, horizon: int = 1) -> bool:
        """Own every page the next ``horizon`` decode writes land in
        (slots ``position .. position+horizon-1``).  False if ``req``
        itself was preempted.  Pure-recurrent families: always True (the
        slab allocated at admission is the whole footprint)."""
        if not self.pool.has_kv:
            return True
        last = req.position + max(int(horizon), 1) - 1
        return self._grow(req, last // self.pool.page_size + 1)

    def ensure_prefill_capacity(self, req: Request, upto: int) -> bool:
        """Own every page for prefix slots [0, upto) (lazy, per chunk).
        False if ``req`` itself was preempted."""
        return self._grow(req, self.pool.pages_for(upto))

    def preempt(self, req: Request) -> None:
        """Free the victim's pages (and slab) and put it back at the FRONT
        of the queue; it keeps its generated tokens and re-prefills from
        chunk 0.  Tokens served off shared pages were never computed by
        it, so they are not counted as wasted.  A RUNNING stateful victim
        is snapshotted instead (its slab, plus KV pages for a hybrid):
        resume imports it bitwise, so nothing is wasted."""
        assert req.status in (RUNNING, PREFILLING), req.status
        self._trace.event("PREEMPT", rid=req.rid, was=req.status)
        snapshot = self.pool.has_state and req.status == RUNNING
        if req.status == PREFILLING:
            self.prefill_preemptions += 1
            self.wasted_prefill_tokens += max(
                req.prefilled - req.cached_tokens, 0)
        elif snapshot:
            req.resume = _snapshot(self.pool, req)
        else:
            self.wasted_prefill_tokens += max(
                req.position + 1 - req.cached_tokens, 0)
        self.pool.free(req.pages)
        req.pages = []
        if req.slab is not None:
            self.pool.free_slab(req.slab)
            req.slab = None
        if not snapshot:
            req.prefilled = 0
            req.cached_tokens = 0
            req.next_token = -1
        req.status = WAITING
        req.preemptions += 1
        self.preemption_count += 1
        self.preempted_log.append(req.rid)
        self.running.remove(req)
        self.waiting.appendleft(req)
        self.epoch += 1

    def reaccept(self, req: Request) -> None:
        """Queue-front re-entry of a request BOUNCED back from a decode
        runner (disaggregated serving): the twin of :meth:`preempt` for a
        victim whose pages lived in the decode pool, which the runner
        already freed.  It keeps its generated tokens and re-prefills
        prompt+generated on re-admission; its whole prefix counts as
        wasted, as a RUNNING victim's does (a stateful one resumes from
        its snapshot and wastes nothing)."""
        assert req.status == WAITING and not req.pages, \
            (req.status, req.pages)
        # a stateful bounce carries a snapshot: resume is exact
        if req.resume is None:
            self.wasted_prefill_tokens += req.position + 1
        req.preemptions += 1
        self.preemption_count += 1
        self.preempted_log.append(req.rid)
        self.waiting.appendleft(req)

    # -- retirement ---------------------------------------------------------

    def retire(self, req: Request) -> None:
        """RUNNING -> FINISHED.  ``free`` is a decref: private pages return
        to the pool; published prompt pages stay cached in the index."""
        assert req.status == RUNNING
        self.pool.free(req.pages)
        req.pages = []
        if req.slab is not None:
            self.pool.free_slab(req.slab)
            req.slab = None
        req.status = FINISHED
        self.running.remove(req)
        self.finished[req.rid] = req
        self.retired_log.append(req.rid)
        self.epoch += 1
        self._trace.event("RETIRE", rid=req.rid,
                          generated=len(req.generated))

    # -- page handoff (disaggregated serving) -------------------------------

    def release(self, req: Request) -> None:
        """Prefill-side end of a page handoff: the request's pages have
        been exported, so drop this side's references and remove it from
        the running set -- it stays RUNNING, on the decode side now.
        Prompt pages published to the prefix index stay cached there."""
        assert req.status == RUNNING, req.status
        self.pool.free(req.pages)
        req.pages = []
        if req.slab is not None:
            self.pool.free_slab(req.slab)
            req.slab = None
        self.running.remove(req)
        self.epoch += 1


class DecodeRunner:
    """The decode-side half of disaggregated serving: the decode pool's
    accounting for RUNNING requests only -- accepted handoffs, K-step
    horizon claims, retirement on EOS/budget, and the mapping epoch the
    engine keys its page-table cache on.

    A request only arrives here through an accepted page handoff, already
    RUNNING with its first token sampled.  When the decode pool runs dry
    the YOUNGEST accepted request is BOUNCED: its decode pages freed, the
    request queued on ``bounced`` for the engine to hand back to the
    admitter (``Scheduler.reaccept``), where it re-prefills
    prompt+generated.  ``DisaggEngine.submit`` caps a request's total
    need at the decode pool, so a lone request always fits."""

    _COUNTERS = ("bounce_count",)

    def __init__(self, pool: PagedKVPool, max_batch: int,
                 registry: Optional[MetricRegistry] = None,
                 trace=None, namespace: str = "runner"):
        self.pool = pool
        self.max_batch = int(max_batch)
        self.running: List[Request] = []      # acceptance order
        self.finished: Dict[int, Request] = {}
        self.bounced: List[Request] = []      # drained by the engine
        self.retired_log: List[int] = []
        self.metrics = registry if registry is not None else MetricRegistry()
        self._trace = trace if trace is not None else NULL_RECORDER
        bind_counters(self, self.metrics, namespace)
        self.epoch = 0

    def reset_counters(self) -> None:
        for c in self._COUNTERS:
            setattr(self, c, 0)
        self.retired_log.clear()

    @property
    def has_slot(self) -> bool:
        return len(self.running) < self.max_batch

    def accept(self, req: Request, pages: List[int],
               slab: Optional[int] = None) -> None:
        """Take ownership of a handed-off request whose payload has been
        imported into this pool's ``pages`` (its page-table row here) and,
        for recurrent families, state ``slab``."""
        assert self.has_slot and req.status == RUNNING, req.status
        req.pages = list(pages)
        req.slab = slab
        self.running.append(req)
        self.epoch += 1

    def ensure_capacity(self, req: Request, horizon: int = 1) -> bool:
        """Own every page the next ``horizon`` decode writes land in,
        bouncing the youngest accepted request when the pool is dry.
        False if ``req`` itself was bounced.  Pure-recurrent: always True
        (the slab accepted with the handoff is the whole footprint)."""
        if not self.pool.has_kv:
            return True
        last = req.position + max(int(horizon), 1) - 1
        need = last // self.pool.page_size + 1
        grew = False
        while need > len(req.pages):
            got = self.pool.alloc(1)
            if got is not None:
                req.pages.extend(got)
                grew = True
                continue
            victim = self.running[-1]         # youngest accepted
            self.bounce(victim)
            if victim is req:
                return False
        if grew:
            self.epoch += 1
        return True

    def bounce(self, req: Request) -> None:
        """Evict a running request from the decode side: free its pages
        and reset its prefill cursor, so the admitter re-prefills
        prompt+generated from chunk 0 (the generated tokens survive).  A
        stateful request snapshots instead, as ``Scheduler.preempt`` does:
        the prefill side hands the snapshot back across untouched."""
        assert req.status == RUNNING, req.status
        if self.pool.has_state:
            req.resume = _snapshot(self.pool, req)
        else:
            req.next_token = -1
            req.prefilled = 0
            req.cached_tokens = 0
        self.pool.free(req.pages)
        req.pages = []
        if req.slab is not None:
            self.pool.free_slab(req.slab)
            req.slab = None
        req.status = WAITING
        self.bounce_count += 1
        self.running.remove(req)
        self.bounced.append(req)
        self.epoch += 1
        self._trace.event("BOUNCE", rid=req.rid,
                          generated=len(req.generated))

    def drain_bounced(self) -> List[Request]:
        out, self.bounced = self.bounced, []
        return out

    def retire(self, req: Request) -> None:
        """RUNNING -> FINISHED on the decode side; its pages and slab
        return to the decode pool the same step."""
        assert req.status == RUNNING, req.status
        self.pool.free(req.pages)
        req.pages = []
        if req.slab is not None:
            self.pool.free_slab(req.slab)
            req.slab = None
        req.status = FINISHED
        self.running.remove(req)
        self.finished[req.rid] = req
        self.retired_log.append(req.rid)
        self.epoch += 1
        self._trace.event("RETIRE", rid=req.rid,
                          generated=len(req.generated))
