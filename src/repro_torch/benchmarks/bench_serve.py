"""Serving-plane benchmark: continuous batching over the paged posit8 KV
pool against static batching (the counterpart of
``benchmarks/bench_serve.py``: the same traffic, seeds, scenarios, rows
and every assertion on tokens, bytes and counts).

  * throughput and request latency p50/p99 (from the lifecycle trace's
    SUBMIT -> RETIRE stamps) of a staggered-arrival trace on
    ``ContinuousEngine`` against one static left-padded ``ServeEngine``
    batch; page-pool utilization;
  * MODELED KV bytes/step: the paged bytes are a function of live
    positions only -- re-serving under an 8x ``max_len`` must not move
    a single step (asserted);
  * CHUNKED PREFILL: a long prompt lands while short requests decode;
    chunked and monolithic outputs equal per-request static
    ``generate`` token for token (asserted); p99 engine-step time,
    chunked against monolithic, is reported with a ``met`` flag;
  * DISAGGREGATED prefill/decode on a prefill-burst trace: outputs equal
    the static oracle (asserted), channel bytes == handoff pages x
    ``page_handoff_bytes`` and the trace's HANDOFF events mirror the
    channel counters (asserted), the Chrome trace validates (asserted);
    decode p99, disaggregated against interleaved, reported with a
    ``met`` flag;
  * PREFIX CACHING on shared-preamble arrivals: outputs equal the
    cache-off engine's (asserted) and each later sharer re-prefills at
    most half its prompt (asserted);
  * the K-step decode loop: the trace's dispatch count == the engine
    counter == its registry mirror == ``(gen-1)/K`` (asserted), one
    (B, K) token buffer to the host a dispatch, equal tokens for every K
    (asserted);
  * PAGED STATE: an RWKV cohort on the state-slab plane, the slab gauge
    == ``2 * state_slab_bytes * live`` every step, zero KV pages, K=1 ==
    K=4 (asserted).

The two latency claims are performance claims and are not asserted: the
port is host-bound, and ``DisaggEngine`` runs both workers on one
stream, so either may miss on a card.  The reference's compile-count
assertions have no counterpart: the port runs eagerly and retraces
nothing.  Its transfer guard is the port's sync guard, on a CUDA card.

The config is the reference's reduced qwen2 (and reduced rwkv6 for the
state cohort), or with ``full`` both at their published sizes.  Results
go to stdout as CSV and to ``build/bench_torch/BENCH_serve.json``, the
trace to ``build/bench_torch/serve_trace.json``.

  python -m repro_torch.benchmarks.bench_serve [--smoke] [--full]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..models import zoo
from ..obs import TraceRecorder, validate_chrome_trace
from ..roofline.analysis import decode_kv_bytes
from ..serve.disagg import DisaggEngine
from ..serve.engine import ContinuousEngine, ServeEngine
from ..serve.paged_kv import (page_handoff_bytes, paged_kv_bytes_per_step,
                              state_slab_bytes)
from .common import OUT_DIR, bench_config, device_name, emit, write_json


def _trace(cfg, n_req, rng):
    """(arrival_step, prompt, gen) per request: ragged lengths, two
    requests arriving every other engine step."""
    out = []
    for i in range(n_req):
        plen = int(rng.integers(3, 13))
        gen = int(rng.integers(4, 25))
        out.append((i // 2, rng.integers(0, cfg.vocab, (plen,)).astype(
            np.int32), gen))
    return out


def _serve_continuous(cfg, params, trace, n_pages, page_size, max_batch,
                      max_len, device):
    rec = TraceRecorder()
    eng = ContinuousEngine(cfg, params, n_pages=n_pages,
                           page_size=page_size, max_batch=max_batch,
                           max_len=max_len, trace=rec, device=device)
    # warm up off the clock, then reset the counters and the trace
    warm = eng.submit(trace[0][1], 2)
    eng.run()
    eng.scheduler.finished.pop(warm)
    eng.reset_counters()
    rec.clear()
    eng.sync_guard = True

    pending = sorted(trace, key=lambda t: t[0])
    util, positions_per_step = [], []
    t0 = time.perf_counter()
    rids = {}
    i = 0
    while pending or eng.scheduler.has_work:
        while pending and pending[0][0] <= i:
            _, prompt, gen = pending.pop(0)
            rids[eng.submit(prompt, gen)] = (prompt, gen)
        eng.step()
        positions_per_step.append(list(eng.last_positions))
        util.append(eng.metrics.value("pool/utilization"))
        i += 1
    dt = time.perf_counter() - t0
    toks = sum(len(eng.scheduler.finished[r].generated) for r in rids)
    slo = rec.request_slo()
    assert set(slo) == set(rids), (set(slo), set(rids))
    assert rec.count("RETIRE") == len(rids), rec.count("RETIRE")
    lat = np.asarray([slo[r]["e2e_ms"] for r in rids])
    return eng, dict(
        tokens=toks, wall_s=dt, tokens_per_s=toks / dt,
        engine_steps=i,
        latency_p50_ms=float(np.percentile(lat, 50)),
        latency_p99_ms=float(np.percentile(lat, 99)),
        slo_ms=rec.slo_summary(),
        pool_util_mean=float(np.mean(util)),
        pool_util_peak=float(np.max(util)),
        peak_pages=eng.pool.alloc_peak,
        preemptions=eng.scheduler.preemption_count,
    ), positions_per_step


def _serve_long_prompt(cfg, params, page_size, max_len, chunk, device):
    """A long prompt arrives while short requests decode; returns the
    outputs and the p99 of the per-step-index median step time.
    ``chunk=None`` is the monolithic baseline."""
    rng = np.random.default_rng(3)
    shorts = [(rng.integers(0, cfg.vocab, (6,)).astype(np.int32), 24)
              for _ in range(3)]
    long_req = (rng.integers(0, cfg.vocab, (5 * page_size,)).astype(
        np.int32), 8)
    eng = ContinuousEngine(cfg, params, n_pages=24, page_size=page_size,
                           max_batch=4, max_len=max_len,
                           prefill_chunk_tokens=chunk, device=device)

    def drive():
        rids = {}
        for p, g in shorts:
            rids[eng.submit(p, g)] = (p, g)
        steps = []
        k = 0
        while eng.scheduler.has_work:
            if k == 3:   # the long prompt lands mid-decode
                rids[eng.submit(*long_req)] = long_req
            t0 = time.perf_counter()
            eng.step()
            steps.append(time.perf_counter() - t0)
            k += 1
        return rids, steps

    drive()                              # warm-up
    reps = []
    for _ in range(3):
        rids, steps = drive()
        reps.append(steps)
    med = np.median(np.asarray(reps), axis=0) * 1e3
    p99 = float(np.percentile(med, 99))
    outs = {r: eng.scheduler.finished[r].output for r in rids}
    return rids, outs, p99


def _serve_disagg_burst(cfg, params, page_size, max_len, disagg, device):
    """Three short requests decode while long prompts land every three
    steps.  Returns the engine, outputs and the p99 of the per-decoded-
    step median latency: the interleaved engine's whole step, the
    disaggregated decode side's dispatch + sync (``last_decode_step_s``)."""
    rng = np.random.default_rng(9)
    shorts = [(rng.integers(0, cfg.vocab, (6,)).astype(np.int32), 24)
              for _ in range(3)]
    longs = [(rng.integers(0, cfg.vocab,
                           (4 * page_size,)).astype(np.int32), 4)
             for _ in range(2)]
    rec = TraceRecorder() if disagg else None
    if disagg:
        eng = DisaggEngine(cfg, params, prefill_pages=24, decode_pages=24,
                           page_size=page_size, max_batch=4,
                           max_len=max_len, prefill_chunk_tokens=page_size,
                           trace=rec, prefill_device=device,
                           decode_device=device)
    else:
        eng = ContinuousEngine(cfg, params, n_pages=24,
                               page_size=page_size, max_batch=4,
                               max_len=max_len,
                               prefill_chunk_tokens=page_size, device=device)

    def drive():
        rids = {}
        for p, g in shorts:
            rids[eng.submit(p, g)] = (p, g)
        lat = []
        pend = list(longs)
        k = 0
        while pend or (eng.has_work if disagg
                       else eng.scheduler.has_work):
            if pend and k >= 3 * (len(longs) - len(pend) + 1):
                p, g = pend.pop(0)
                rids[eng.submit(p, g)] = (p, g)
            t0 = time.perf_counter()
            n = eng.step()
            dt = eng.last_decode_step_s if disagg \
                else time.perf_counter() - t0
            if n:
                lat.append(dt)
            k += 1
        return rids, lat

    drive()                            # warm-up
    if disagg:
        eng.decode.sync_guard = True
    else:
        eng.sync_guard = True
    reps = []
    for _ in range(3):
        rids, lat = drive()
        reps.append(lat)
    med = np.median(np.asarray(reps), axis=0) * 1e3
    fin = eng.finished if disagg else eng.scheduler.finished
    outs = {r: fin[r].output for r in rids}
    return eng, rids, outs, float(np.percentile(med, 99)), rec


def _preamble_trace(cfg, rng, n_req, pre_tokens, arrival_gap):
    """Every prompt opens with the SAME ``pre_tokens``-long preamble and
    a short unique tail; ``arrival_gap`` steps separate arrivals, so
    every request after the first is a cache hit."""
    pre = rng.integers(0, cfg.vocab, (pre_tokens,)).astype(np.int32)
    out = []
    for i in range(n_req):
        tail = rng.integers(0, cfg.vocab,
                            (int(rng.integers(2, 6)),)).astype(np.int32)
        out.append((i * arrival_gap, np.concatenate([pre, tail]),
                    int(rng.integers(4, 10))))
    return out


def _serve_shared_preamble(cfg, params, trace, n_pages, page_size,
                           max_batch, max_len, prefix_cache, device):
    """Serve the shared-preamble trace on the pages context (cache on or
    off); returns per-rid outputs + stats."""
    eng = ContinuousEngine(cfg, params, n_pages=n_pages,
                           page_size=page_size, max_batch=max_batch,
                           max_len=max_len, prefill_chunk_tokens=page_size,
                           prefill_context="pages",
                           prefix_cache=prefix_cache, device=device)
    # warm up with a SUB-PAGE prompt: it seeds no reusable prefix
    warm = eng.submit(trace[0][1][:3], 2)
    eng.run()
    eng.scheduler.finished.pop(warm)
    eng.reset_counters()

    pending = sorted(trace, key=lambda t: t[0])
    arrive, first_tok, rids = {}, {}, {}
    i = n_retired = 0
    while pending or eng.scheduler.has_work:
        while pending and pending[0][0] <= i:
            _, prompt, gen = pending.pop(0)
            rid = eng.submit(prompt, gen)
            rids[rid] = (prompt, gen)
            arrive[rid] = time.perf_counter()
        eng.step()
        now = time.perf_counter()
        for req in eng.scheduler.running:
            if req.generated and req.rid not in first_tok:
                first_tok[req.rid] = now
        log = eng.scheduler.retired_log
        for rid_ in log[n_retired:]:
            first_tok.setdefault(rid_, now)
        n_retired = len(log)
        i += 1
    ttft = np.asarray([first_tok[r] - arrive[r] for r in rids]) * 1e3
    sched = eng.scheduler
    outs = {r: sched.finished[r].output for r in rids}
    return outs, dict(
        engine_steps=i,
        prefill_tokens_computed=eng.prefill_tokens_computed,
        prefix_hits=sched.prefix.hits if sched.prefix else 0,
        prefix_hit_tokens=sched.prefix.hit_tokens if sched.prefix else 0,
        ttft_p50_ms=float(np.percentile(ttft, 50)),
        ttft_p99_ms=float(np.percentile(ttft, 99)),
        peak_pages=eng.pool.alloc_peak,
        preemptions=sched.preemption_count,
    )


def _serve_decode_loop(cfg, params, page_size, max_batch, max_len,
                       n_pages, gen, k_steps, device, traced=False):
    """One full-batch lockstep cohort decoded with ``decode_steps=K``:
    ``(gen - 1) / K`` dispatches in closed form; with ``traced`` the
    trace's DECODE_DISPATCH count is held to the engine counter and its
    registry mirror."""
    rec = TraceRecorder() if traced else None
    eng = ContinuousEngine(cfg, params, n_pages=n_pages,
                           page_size=page_size, max_batch=max_batch,
                           max_len=max_len, decode_steps=k_steps,
                           trace=rec, device=device)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, (4,)).astype(np.int32)
               for _ in range(max_batch)]
    warm = eng.submit(prompts[0], 2)
    eng.run()
    eng.scheduler.finished.pop(warm)
    eng.reset_counters()
    if rec is not None:
        rec.clear()
    eng.sync_guard = True

    rids = [eng.submit(p, gen) for p in prompts]
    t0 = time.perf_counter()
    eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(eng.scheduler.finished[r].generated) for r in rids)
    outs = [np.asarray(eng.scheduler.finished[r].generated) for r in rids]
    if rec is not None:
        assert rec.count("DECODE_DISPATCH") == eng.decode_dispatches \
            == eng.metrics.value("engine/decode_dispatches"), \
            (rec.count("DECODE_DISPATCH"), eng.decode_dispatches)
    return outs, dict(
        decode_steps=k_steps,
        tokens=toks, wall_s=dt, tokens_per_s=toks / dt,
        decode_dispatches=eng.decode_dispatches,
        dispatches_per_token=eng.decode_dispatches / (toks - len(rids)),
        page_table_uploads=eng.page_table_uploads,
        token_host_bytes=eng.token_host_bytes,
    )


def _serve_recurrent(cfg, params, max_batch, max_len, gen, k_steps, device):
    """A full-batch RWKV cohort on the state-slab plane: one slab per
    live request and zero pages every step, and the state gauge == the
    pool model == ``2 * state_slab_bytes * live``."""
    eng = ContinuousEngine(cfg, params, n_pages=2, page_size=16,
                           max_batch=max_batch, max_len=max_len,
                           decode_steps=k_steps, device=device)
    sb = state_slab_bytes(cfg)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab, (4,)).astype(np.int32)
               for _ in range(max_batch)]
    warm = eng.submit(prompts[0], 2)
    eng.run()
    eng.scheduler.finished.pop(warm)
    eng.reset_counters()
    eng.sync_guard = True

    rids = [eng.submit(p, gen) for p in prompts]
    t0 = time.perf_counter()
    while eng.scheduler.has_work:
        eng.step()
        live = len(eng.scheduler.running)
        assert eng.pool.used_slabs == live, (eng.pool.used_slabs, live)
        assert eng.pool.used_pages == 0, eng.pool.used_pages
        served = list(eng.last_positions)
        gauge = eng.metrics.value("engine/state_bytes_per_step_model")
        assert gauge == eng.pool.modeled_bytes_per_step(served), gauge
        assert gauge == 2.0 * sb * len(served), (gauge, sb, len(served))
    dt = time.perf_counter() - t0
    assert eng.pool.slab_alloc_peak == max_batch, eng.pool.slab_alloc_peak
    assert eng.pool.used_slabs == 0 and eng.pool.alloc_peak == 0
    assert eng.scheduler.preemption_count == 0
    want = (gen - 1) // k_steps
    assert eng.decode_dispatches == want, (k_steps, eng.decode_dispatches)
    assert eng.token_host_bytes == want * max_batch * k_steps * 4
    toks = sum(len(eng.scheduler.finished[r].generated) for r in rids)
    outs = [np.asarray(eng.scheduler.finished[r].generated) for r in rids]
    return outs, dict(
        decode_steps=k_steps,
        tokens=toks, wall_s=dt, tokens_per_s=toks / dt,
        decode_dispatches=eng.decode_dispatches,
        state_bytes_per_step_model=2.0 * sb * max_batch,
        slab_alloc_peak=eng.pool.slab_alloc_peak,
        kv_pages_allocated=eng.pool.alloc_peak,
    )


def _serve_static(cfg, params, trace, max_len, device):
    """The static plan: wait for every arrival, left-pad one batch,
    decode until the longest request's budget."""
    eng = ServeEngine(cfg, params, max_len=max_len, quantized_kv=True,
                      device=device)
    lens = [t[1].size for t in trace]
    s0 = max(lens)
    toks = np.zeros((len(trace), s0), np.int32)
    for i, (_, p, _) in enumerate(trace):
        toks[i, s0 - p.size:] = p
    steps = max(t[2] for t in trace)
    eng.generate(toks, steps=2, lengths=np.asarray(lens))      # warm-up
    t0 = time.perf_counter()
    eng.generate(toks, steps=steps, lengths=np.asarray(lens))
    dt = time.perf_counter() - t0
    useful = sum(t[2] for t in trace)
    return dict(wall_s=dt, steps=steps, batch=len(trace),
                useful_tokens=useful, tokens_per_s=useful / dt)


def _static_oracle(cfg, params, max_len, device, rids, outs, what):
    static = ServeEngine(cfg, params, max_len=max_len, quantized_kv=True,
                         device=device)
    for rid, (p, g) in rids.items():
        want = static.generate(p[None], steps=g)[0]
        assert np.array_equal(outs[rid], want), \
            f"{what} must stay token-for-token identical to static " \
            f"per-request generation (rid {rid})"


def run(device=None, smoke: bool = False, full: bool = False,
        out_dir=None) -> dict:
    dev = resolve_device(device)
    out_dir = out_dir or OUT_DIR
    cfg = bench_config(full=full)
    n_req = 8 if smoke else 16
    page_size = 16
    max_len = 48
    max_batch = 8
    n_pages = 6 * max_batch
    rng = np.random.default_rng(0)
    params = zoo.init_model(cfg, torch.Generator(dev).manual_seed(0))
    trace = _trace(cfg, n_req, rng)
    results = {"config": {"arch": cfg.name, "n_req": n_req,
                          "page_size": page_size, "max_len": max_len,
                          "max_batch": max_batch, "n_pages": n_pages,
                          "device": device_name(dev)}}
    scenario_wall = {}
    t_sc = time.perf_counter()

    def lap(name):
        nonlocal t_sc
        scenario_wall[name] = round(time.perf_counter() - t_sc, 3)
        t_sc = time.perf_counter()

    eng, cont, positions_per_step = _serve_continuous(
        cfg, params, trace, n_pages, page_size, max_batch, max_len, dev)
    static = _serve_static(cfg, params, trace, max_len, dev)
    results["continuous"] = cont
    results["static"] = static
    emit("serve/continuous_tokens_per_s", 1e6 / max(cont["tokens_per_s"],
                                                    1e-9),
         f"tokens_per_s={cont['tokens_per_s']:.1f};"
         f"p50_ms={cont['latency_p50_ms']:.1f};"
         f"p99_ms={cont['latency_p99_ms']:.1f}")
    emit("serve/static_tokens_per_s", 1e6 / max(static["tokens_per_s"],
                                                1e-9),
         f"tokens_per_s={static['tokens_per_s']:.1f}")
    emit("serve/pool_utilization", 0.0,
         f"mean={cont['pool_util_mean']:.2f};"
         f"peak={cont['pool_util_peak']:.2f};"
         f"preemptions={cont['preemptions']}")
    lap("continuous_vs_static")

    # --- modeled KV bytes/step: live pages vs max_len plans
    paged_steps = [paged_kv_bytes_per_step(cfg, pos, page_size)
                   for pos in positions_per_step if pos]
    paged_mean = float(np.mean(paged_steps))
    _, _, positions_8x = _serve_continuous(
        cfg, params, trace, n_pages, page_size, max_batch, 8 * max_len, dev)
    paged_8x = [paged_kv_bytes_per_step(cfg, pos, page_size)
                for pos in positions_8x if pos]
    assert paged_steps == paged_8x, \
        "paged KV bytes/step must not depend on max_len"
    bsz = static["batch"]
    front_pos = max(t[1].size for t in trace) + static["steps"] - 1
    static_q = decode_kv_bytes(cfg, bsz, max_len, front_pos,
                               quantized=True, blk=page_size)
    static_q_8x = decode_kv_bytes(cfg, bsz, 8 * max_len, front_pos,
                                  quantized=True, blk=page_size)
    static_bf16 = decode_kv_bytes(cfg, bsz, max_len, front_pos,
                                  quantized=False)
    static_bf16_8x = decode_kv_bytes(cfg, bsz, 8 * max_len, front_pos,
                                     quantized=False)
    results["kv_bytes_per_step"] = {
        "paged_mean": paged_mean,
        "paged_mean_8x_maxlen": float(np.mean(paged_8x)),
        "paged_peak": float(np.max(paged_steps)),
        "static_posit8_lenaware_front": static_q,
        "static_posit8_lenaware_front_8x_maxlen": static_q_8x,
        "static_bf16_full": static_bf16,
        "static_bf16_full_8x_maxlen": static_bf16_8x,
        "paged_vs_static_bf16_gain": static_bf16 / paged_mean,
    }
    emit("serve/kv_bytes_per_step", 0.0,
         f"paged={paged_mean:.0f};static_posit8={static_q:.0f};"
         f"static_bf16={static_bf16:.0f};"
         f"gain={static_bf16 / paged_mean:.2f}x")
    assert paged_mean <= static_q, \
        "live-page accounting must beat the shared-front static plan"
    assert static_bf16_8x == 8 * static_bf16, \
        "the bf16 plan pays max_len (that is the waste being removed)"
    lap("kv_bytes_per_step")

    # --- chunked prefill: long-prompt arrival, p99 step latency
    lp_max_len = 112                     # default_kv_block(112) == 16 ==
    #                                      page: the static-parity condition
    rids_m, outs_m, p99_mono = _serve_long_prompt(
        cfg, params, page_size, lp_max_len, None, dev)
    rids_c, outs_c, p99_chunk = _serve_long_prompt(
        cfg, params, page_size, lp_max_len, page_size, dev)
    for rids, outs in ((rids_m, outs_m), (rids_c, outs_c)):
        _static_oracle(cfg, params, lp_max_len, dev, rids, outs,
                       "chunked/monolithic prefill")
    met = p99_chunk < p99_mono
    results["chunked_prefill"] = {
        "long_prompt_tokens": 5 * page_size,
        "prefill_chunk_tokens": page_size,
        "p99_step_ms_monolithic": p99_mono,
        "p99_step_ms_chunked": p99_chunk,
        "p99_stall_reduction": p99_mono / max(p99_chunk, 1e-9),
        "claim": "chunked p99 < monolithic p99", "met": met,
        "static_parity": True,
    }
    emit("serve/chunked_prefill_p99_step", p99_chunk * 1e3,
         f"chunked_p99_ms={p99_chunk:.2f};mono_p99_ms={p99_mono:.2f};"
         f"stall_reduction={p99_mono / max(p99_chunk, 1e-9):.2f}x;"
         f"met={int(met)};static_parity=1")
    lap("chunked_prefill")

    # --- disaggregated prefill/decode on the burst trace
    eng_i, rids_i, outs_i, p99_inter, _ = _serve_disagg_burst(
        cfg, params, page_size, lp_max_len, False, dev)
    eng_d, rids_d, outs_d, p99_disagg, rec_d = _serve_disagg_burst(
        cfg, params, page_size, lp_max_len, True, dev)
    for rids, outs in ((rids_i, outs_i), (rids_d, outs_d)):
        _static_oracle(cfg, params, lp_max_len, dev, rids, outs,
                       "disaggregated serving")
    met = p99_disagg <= p99_inter
    # channel traffic is EXACTLY the posit8 page model
    assert eng_d.handoff_bytes == eng_d.handoff_pages * \
        page_handoff_bytes(cfg, page_size), eng_d.handoff_bytes
    # 4 drives x 5 requests, every one crosses the channel exactly once
    assert eng_d.handoffs == 4 * len(rids_d), eng_d.handoffs
    assert eng_d.decode_bounces == 0, eng_d.decode_bounces
    # the trace mirrors the channel counters across all 4 drives
    assert rec_d.count("HANDOFF") == eng_d.handoffs, \
        (rec_d.count("HANDOFF"), eng_d.handoffs)
    assert rec_d.arg_sum("HANDOFF", "pages") == eng_d.handoff_pages, \
        rec_d.arg_sum("HANDOFF", "pages")
    assert rec_d.arg_sum("HANDOFF", "bytes") == eng_d.handoff_bytes, \
        rec_d.arg_sum("HANDOFF", "bytes")
    assert eng_d.metrics.value("channel/handoffs") == eng_d.handoffs
    trace_json = os.path.join(out_dir, "serve_trace.json")
    os.makedirs(out_dir, exist_ok=True)
    rec_d.write_chrome_trace(trace_json)
    with open(trace_json) as f:
        tstats = validate_chrome_trace(json.load(f))
    results["disagg"] = {
        "trace_events": tstats,
        "n_req": len(rids_d),
        "long_prompt_tokens": 4 * page_size,
        "p99_decode_step_ms_interleaved": p99_inter,
        "p99_decode_step_ms_disagg": p99_disagg,
        "decode_stall_reduction": p99_inter / max(p99_disagg, 1e-9),
        "claim": "disaggregated decode p99 <= interleaved p99", "met": met,
        "handoffs": eng_d.handoffs,
        "handoff_pages": eng_d.handoff_pages,
        "handoff_bytes": eng_d.handoff_bytes,
        "handoff_bytes_per_page": page_handoff_bytes(cfg, page_size),
        "decode_bounces": eng_d.decode_bounces,
        "static_parity": True,
    }
    emit("serve/disagg_decode_p99_step", p99_disagg * 1e3,
         f"disagg_p99_ms={p99_disagg:.2f};"
         f"interleaved_p99_ms={p99_inter:.2f};met={int(met)};"
         f"handoffs={eng_d.handoffs};"
         f"handoff_bytes={eng_d.handoff_bytes};"
         f"bounces={eng_d.decode_bounces};static_parity=1")
    emit("serve/trace_artifact", 0.0,
         f"events={tstats['total']};spans={tstats['spans']};"
         f"instants={tstats['instants']};"
         f"path={os.path.normpath(trace_json)}")
    del eng_i, eng_d
    lap("disagg")

    # --- prefix caching: shared-preamble arrivals, cache on vs off
    pre_pages = 2
    pre_trace = _preamble_trace(cfg, np.random.default_rng(5), 6,
                                pre_pages * page_size,
                                arrival_gap=pre_pages + 1)
    outs_off, off = _serve_shared_preamble(
        cfg, params, pre_trace, 32, page_size, 4, max_len, False, dev)
    outs_on, on = _serve_shared_preamble(
        cfg, params, pre_trace, 32, page_size, 4, max_len, True, dev)
    for rid in outs_off:
        assert np.array_equal(outs_on[rid], outs_off[rid]), (
            "prefix-cache hits must stay token-for-token identical to "
            f"the cache-off engine (rid {rid})")
    assert on["preemptions"] == 0 and off["preemptions"] == 0, (on, off)
    assert on["prefix_hits"] == len(pre_trace) - 1, on
    later_prompt = sum(t[1].size for t in pre_trace[1:])
    later_computed = later_prompt - on["prefix_hit_tokens"]
    assert later_prompt >= 2 * later_computed, (
        "prefix caching must at least halve the prefill tokens of "
        f"requests after the first sharer ({later_computed} computed "
        f"of {later_prompt})")
    results["prefix_cache"] = {
        "preamble_tokens": pre_pages * page_size,
        "n_req": len(pre_trace),
        "prefill_tokens_computed_off": off["prefill_tokens_computed"],
        "prefill_tokens_computed_on": on["prefill_tokens_computed"],
        "prefill_tokens_saved": on["prefix_hit_tokens"],
        "later_req_prefill_reduction":
            later_prompt / max(later_computed, 1),
        "prefix_hits": on["prefix_hits"],
        "ttft_p50_ms_off": off["ttft_p50_ms"],
        "ttft_p50_ms_on": on["ttft_p50_ms"],
        "ttft_p99_ms_off": off["ttft_p99_ms"],
        "ttft_p99_ms_on": on["ttft_p99_ms"],
        "parity": True,
    }
    emit("serve/prefix_cache_ttft_p50", on["ttft_p50_ms"] * 1e3,
         f"on_p50_ms={on['ttft_p50_ms']:.2f};"
         f"off_p50_ms={off['ttft_p50_ms']:.2f};"
         f"on_p99_ms={on['ttft_p99_ms']:.2f};"
         f"off_p99_ms={off['ttft_p99_ms']:.2f}")
    emit("serve/prefix_cache_prefill_tokens", 0.0,
         f"computed_on={on['prefill_tokens_computed']};"
         f"computed_off={off['prefill_tokens_computed']};"
         f"saved={on['prefix_hit_tokens']};"
         f"later_req_reduction="
         f"{later_prompt / max(later_computed, 1):.1f}x;parity=1")
    lap("prefix_cache")

    # --- the K-step decode loop: one (B, K) token sync per dispatch
    gen = 17                       # 1 prefill-sampled + 16 decoded
    dl_results = {}
    base_out = None
    for k_steps in (1, 4, 8):
        # K=1 untraced, K=4/8 traced: equal tokens also show tracing
        # changes no arithmetic
        outs, stats = _serve_decode_loop(
            cfg, params, page_size, max_batch, max_len, n_pages, gen,
            k_steps, dev, traced=k_steps != 1)
        want = (gen - 1) // k_steps
        assert stats["decode_dispatches"] == want, (k_steps, stats)
        assert stats["token_host_bytes"] == want * max_batch * \
            k_steps * 4, (k_steps, stats)
        if base_out is None:
            base_out = outs
        for a, b_ in zip(base_out, outs):
            assert np.array_equal(a, b_), \
                f"decode_steps={k_steps} changed temperature-0 output"
        dl_results[f"K{k_steps}"] = stats
        emit(f"serve/decode_loop_K{k_steps}",
             1e6 / max(stats["tokens_per_s"], 1e-9),
             f"tokens_per_s={stats['tokens_per_s']:.1f};"
             f"dispatches={stats['decode_dispatches']};"
             f"dispatches_per_token="
             f"{stats['dispatches_per_token']:.3f};"
             f"pt_uploads={stats['page_table_uploads']};"
             f"token_bytes={stats['token_host_bytes']};"
             f"logits_bytes=0")
    dl_results["logits_bytes_removed_per_run"] = \
        (gen - 1) * max_batch * cfg.vocab * 4
    results["decode_loop"] = dl_results
    lap("decode_loop")

    # --- paged STATE: an RWKV cohort on the slab plane
    r_cfg = bench_config("rwkv6-1.6b", full=full)
    r_params = zoo.init_model(r_cfg, torch.Generator(dev).manual_seed(1))
    r_batch = 4
    rec_results = {"state_slab_bytes": state_slab_bytes(r_cfg)}
    rec_base = None
    for k_steps in (1, 4):
        outs, stats = _serve_recurrent(r_cfg, r_params, r_batch, max_len,
                                       gen, k_steps, dev)
        if rec_base is None:
            rec_base = outs
        for a, b_ in zip(rec_base, outs):
            assert np.array_equal(a, b_), \
                f"recurrent decode_steps={k_steps} changed temp-0 output"
        rec_results[f"K{k_steps}"] = stats
        emit(f"serve/recurrent_K{k_steps}",
             1e6 / max(stats["tokens_per_s"], 1e-9),
             f"tokens_per_s={stats['tokens_per_s']:.1f};"
             f"dispatches={stats['decode_dispatches']};"
             f"state_bytes_per_step="
             f"{stats['state_bytes_per_step_model']:.0f};"
             f"slab_peak={stats['slab_alloc_peak']};kv_pages=0")
    results["recurrent"] = rec_results
    del r_params
    lap("recurrent")

    # --- slot waste: reserved slots vs live tokens
    reserved = bsz * max_len
    live_mean = float(np.mean([sum(p + 1 for p in pos)
                               for pos in positions_per_step if pos]))
    results["slot_waste"] = {
        "static_reserved_slots": reserved,
        "paged_live_tokens_mean": live_mean,
        "reserved_over_live": reserved / max(live_mean, 1.0),
    }
    emit("serve/slot_waste", 0.0,
         f"static_reserved={reserved};live_mean={live_mean:.0f};"
         f"ratio={reserved / max(live_mean, 1.0):.1f}x")
    lap("slot_waste")
    results["scenario_wall_s"] = scenario_wall
    write_json(results, "BENCH_serve.json", out_dir)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="small trace")
    ap.add_argument("--full", action="store_true",
                    help="qwen2-0.5b and rwkv6-1.6b at their published "
                         "sizes (default: reduced)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    run(args.device, smoke=args.smoke, full=args.full)


if __name__ == "__main__":
    main()
