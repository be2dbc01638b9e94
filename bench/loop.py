"""The closed loop: clients drive ``ContinuousEngine.submit``/``step``,
each sending its next request as soon as its last reply has finished.

A run goes through these phases:

  lead    the traffic's lead clients send their first request alone
          (a shared preamble then lands in the prefix cache once);
  ramp    every other client sends its first request; the loop runs
          until each client has seen its first token, so the window
          opens on a full batch;
  window  ``seconds`` long, ended at the first step boundary past it;
          clients whose reply finished send their next request;
  extra   with ``--trace 1``, a few more seconds of the same loop under
          the profiler;
  tail    no new requests; the loop runs on until every request sent in
          the window has its first token (at most ``TAIL_S``).

Every token is stamped with the host clock at the end of the engine
step that produced it: that is when a client could first see it.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = ["Served", "Run", "drive", "TAIL_S"]

TAIL_S = 60.0
RAMP_S = 900.0


@dataclasses.dataclass
class Served:
    """One request as a client sees it."""

    rid: int
    client: int
    submit: float
    prompt: np.ndarray
    max_new: int
    req: object = None                  # the engine's request
    times: List[float] = dataclasses.field(default_factory=list)
    done: Optional[float] = None

    @property
    def served(self) -> np.ndarray:
        return np.asarray(self.req.generated[:len(self.times)], np.int64)


@dataclasses.dataclass
class Run:
    requests: List[Served]
    t0: float                   # the window opens
    t1: float                   # and closes (a step boundary)
    steps: List[dict]           # per window step: start, end, running, admitted
    counters0: Dict[str, float]
    counters1: Dict[str, float]
    unanswered: int             # window requests without a first token


def counters(eng) -> Dict[str, float]:
    sched = eng.scheduler
    out = {"prefill_tokens_computed": eng.prefill_tokens_computed,
           "decode_dispatches": eng.decode_dispatches,
           "steps_run": eng.steps_run,
           "preemptions": sched.preemption_count,
           "pool_pages_free": sched.pool.free_pages}
    if sched.prefix is not None:
        out["prefix_hit_tokens"] = sched.prefix.hit_tokens
        out["prefix_hits"] = sched.prefix.hits
    return out


def drive(eng, clients: List[List[tuple]], lead: int, seconds: float,
          clock: Callable[[], float] = time.perf_counter,
          on_window: Optional[Callable[[str, float], None]] = None,
          extra_s: float = 0.0,
          log: Optional[Callable[[str], None]] = None) -> Run:
    """Run the closed loop of ``clients`` (each a list of (prompt,
    max_new) it sends in turn) on ``eng``.  ``on_window(event, t)`` is
    called with "open" before the window's first step, "step" after each
    window step and "close" once it has closed; with ``extra_s``, the
    loop then runs on for that long between "extra" and "extra_done"
    (the traced run's profiled steps)."""
    sched = eng.scheduler
    nxt = [0] * len(clients)
    live: Dict[int, Served] = {}
    busy = [False] * len(clients)
    every: List[Served] = []

    def send(c: int, now: float) -> None:
        if nxt[c] >= len(clients[c]):
            return                      # this client has said all it had
        prompt, new = clients[c][nxt[c]]
        nxt[c] += 1
        rid = eng.submit(prompt, new)
        s = Served(rid, c, now, prompt, new, sched.waiting[-1])
        live[rid] = s
        every.append(s)
        busy[c] = True

    def step() -> float:
        eng.step()
        now = clock()
        for rid in list(live):
            s = live[rid]
            n = len(s.req.generated)
            if n > len(s.times):
                s.times.extend([now] * (n - len(s.times)))
            if s.req.status == "finished":
                s.done = now
                busy[s.client] = False
                del live[rid]
        return now

    now = clock()
    for c in range(min(lead, len(clients))):
        send(c, now)
    began = clock()
    deadline = began + RAMP_S
    said = [began]
    nsteps = [0]

    def ramping() -> None:
        nsteps[0] += 1
        t = clock()
        if t > deadline:
            raise RuntimeError(f"the ramp took over {RAMP_S:.0f} s")
        if log is not None and t > said[0] + 10.0:
            said[0] = t
            log(f"[bench] ramp {t - began:.1f} s: {nsteps[0]} steps, "
                f"{len(sched.running)} running, {len(sched.waiting)} "
                f"waiting, {eng.prefill_tokens_computed} prompt tokens "
                f"computed, {sum(1 for s in every if s.times)} of "
                f"{len(every)} requests answered")

    while any(not every[i].times for i in range(len(every))):
        now = step()
        ramping()
    firsts = list(every)
    for c in range(len(clients)):
        if not busy[c]:
            send(c, now)
            firsts.append(every[-1])
    while any(not s.times for s in firsts):
        now = step()
        ramping()
        for c in range(len(clients)):
            if not busy[c]:
                send(c, now)

    gc.collect()
    gc.freeze()
    t0 = clock()
    c0 = counters(eng)
    if on_window is not None:
        on_window("open", t0)
    steps = []
    now = t0
    for c in range(len(clients)):
        if not busy[c]:
            send(c, now)
    while now < t0 + seconds:
        start = now
        now = step()
        steps.append({"start": start, "end": now,
                      "positions": list(eng.last_positions),
                      "admitted": list(eng.last_admitted)})
        if on_window is not None:
            on_window("step", now)
        for c in range(len(clients)):
            if not busy[c]:
                send(c, now)
    t1 = now
    c1 = counters(eng)
    if on_window is not None:
        on_window("close", t1)
    if extra_s > 0:
        # the traced run's profiled steps, after the window and past its
        # clock, so what the profiler costs the host reaches no metric
        # read from the window
        on_window("extra", now)
        end = clock() + extra_s
        while now < end:
            now = step()
            for c in range(len(clients)):
                if not busy[c]:
                    send(c, now)
        on_window("extra_done", now)
    waiting = [s for s in every if t0 <= s.submit <= t1 and not s.times]
    while waiting and clock() < t1 + TAIL_S and sched.has_work:
        step()
        waiting = [s for s in waiting if not s.times]
    gc.unfreeze()
    return Run(every, t0, t1, steps, c0, c1, len(waiting))
