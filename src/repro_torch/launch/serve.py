"""Serving CLI of the port: static batched generation, continuous
batching over the paged posit8 KV pool, or disaggregated prefill/decode
serving, with the packed weight plane.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --policy mixed --batch 8 --prompt-len 128 --steps 32 --quantized-kv

``--continuous`` (alias ``--paged``) serves a ragged request mix (2 x ``--batch`` requests
around the nominal prompt and step counts) through ``ContinuousEngine``:
FIFO admission against a pool of ``--n-pages`` pages, one batched decode
dispatch for all running requests.  ``--prefill-chunk N`` prefills in
chunks of N tokens, ``--prefix-cache`` gives every prompt a shared
one-page preamble served from the pool's prefix cache, and
``--decode-steps K`` runs K decode+sample iterations per dispatch.

  ... --continuous --batch 8 --n-pages 48 [--page-size 16]
      [--prefill-chunk 16] [--prefix-cache] [--decode-steps 4]

``--disagg`` serves the same mix through ``DisaggEngine`` instead: a
prefill worker (admission + chunk budget) and a decode worker over two
pools of ``--n-pages`` pages each, joined by a double-buffered posit8
page-handoff channel; the host issues each prefill step while the card
runs the decode dispatch before it.

  ... --disagg --batch 8 --n-pages 48 --prefill-chunk 16 --decode-steps 4

``--trace OUT.json`` records the paged engines' request-lifecycle events
and step spans and writes a Chrome-trace JSON after the run;
``--metrics`` prints a Prometheus text snapshot of the engine's metric
registry after the run.  ``--profile OUT.json`` runs ``torch.profiler``
over the run's steps after its first two (the kernels' first use),
writes ONE Chrome trace that holds the profiler's events (the card's
kernels on a CUDA device) and the engine's spans, down to the forward's
sub-blocks, on the profiler's clock, and prints the card's idle seconds
by the innermost span the host was in when each idle gap began.  The
static engine carries no telemetry and says so.

  ... --continuous --batch 8 --prefill-chunk 16 --profile prof.json

``--arch`` takes all ten registered configs.  The recurrent and hybrid
families keep posit8 state slabs in the paged engines and prefill on the
carry context, so ``--prefix-cache`` is refused for them.  The paged
engines refuse the audio and vision frontends (musicgen-medium,
qwen2-vl-7b), whose requests carry frame / patch embeddings, and the
static engine needs those embeddings in its batch: serve them through
``zoo.apply_model`` / ``zoo.decode_model``, as the reference does.

  ... --arch rwkv6-1.6b --continuous --batch 4 --prefill-chunk 16
  ... --arch jamba-v0.1-52b --disagg --batch 4 --prefill-chunk 16

It runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path
(use ``--reduced`` there).  Weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..core.policy import PrecisionPolicy
from ..models import zoo
from ..obs import TraceRecorder, clock_offset_us
from ..parallel.sharding import split_devices
from ..serve.disagg import DisaggEngine
from ..serve.engine import ContinuousEngine, ServeEngine

# engine steps before ``--profile`` starts the profiler: the first use
# of every kernel (and, on the card, its load) falls in them
PROFILE_AFTER = 2


def _static(args, cfg, params, policy, device, gen) -> None:
    eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.steps + 8,
                      quantized_kv=args.quantized_kv, policy=policy,
                      device=device)
    toks = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (args.batch, args.prompt_len))
    t0 = time.perf_counter()
    out = eng.generate(toks, steps=args.steps, temperature=args.temperature,
                       generator=gen)
    dt = time.perf_counter() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s) on {device}")
    print(out[:, args.prompt_len:][:2])


def _profiled_run(eng, more, rec, path: str, device) -> None:
    """Step ``eng`` while ``more()``, under ``torch.profiler`` after the
    first ``PROFILE_AFTER`` steps; write the profiler's Chrome trace to
    ``path`` with ``rec``'s spans placed on its clock (``rec.anchor``),
    and print the card's idle seconds by span."""
    cuda = device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for _ in range(PROFILE_AFTER):
        if more():
            eng.step()
    if cuda:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        stamp = rec.anchor()
        while more():
            eng.step()
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    offset = clock_offset_us(events, stamp)
    gaps = rec.gaps_by_span(events, offset)
    trace["traceEvents"] = events + rec.chrome_trace(offset)["traceEvents"]
    with open(path, "w") as f:
        json.dump(trace, f)
    print(f"wrote the profiler's trace with the engine's spans on its clock "
          f"to {path}; the card idle by span (s):")
    for kind, sec in sorted(gaps.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:>20}: {sec:.6f}")


def _continuous(args, cfg, params, policy, device) -> None:
    from ..kernels.flash_decode import default_kv_block
    rec = TraceRecorder() \
        if (args.trace or args.metrics or args.profile) else None
    rng = np.random.default_rng(args.seed)
    max_len = args.prompt_len + args.steps + 8
    page_size = args.page_size
    if args.prefill_chunk and page_size is None:
        page_size = args.prefill_chunk       # chunk == k * page, k = 1
    if args.prefix_cache:
        # the shared preamble rides on top of the nominal prompt length
        if page_size is None:
            page_size = default_kv_block(max_len)
        max_len += page_size
    # the page table maps whole pages and chunks divide max_len: round up
    for unit in (args.prefill_chunk, page_size):
        if unit and max_len % unit:
            max_len += unit - max_len % unit
    common = dict(page_size=page_size, max_batch=args.batch,
                  max_len=max_len, policy=policy,
                  temperature=args.temperature, seed=args.seed,
                  prefill_chunk_tokens=args.prefill_chunk,
                  prefix_cache=args.prefix_cache,
                  decode_steps=args.decode_steps, trace=rec)
    if args.disagg:
        # prefill and decode cards from the cards present (one card: both
        # workers share it), as the reference splits its devices
        pdev, ddev = split_devices([device] if device.type == "cpu"
                                   else None)
        eng = DisaggEngine(cfg, params, prefill_pages=args.n_pages,
                           decode_pages=args.n_pages, prefill_device=pdev[0],
                           decode_device=ddev[0], **common)
    else:
        eng = ContinuousEngine(cfg, params, n_pages=args.n_pages,
                               device=device, **common)
    preamble = rng.integers(0, cfg.vocab, (eng.page_size,)) \
        if args.prefix_cache else None
    rids = []
    for _ in range(2 * args.batch):
        plen = max(1, args.prompt_len - int(rng.integers(0, 4)))
        steps = max(1, args.steps - int(rng.integers(0, args.steps // 2 + 1)))
        prompt = rng.integers(0, cfg.vocab, (plen,))
        if preamble is not None:
            prompt = np.concatenate([preamble, prompt])
            steps = max(1, min(steps, max_len - prompt.size))
        rids.append(eng.submit(prompt, steps))
    t0 = time.perf_counter()
    if args.profile:
        more = (lambda: eng.has_work) if args.disagg \
            else (lambda: eng.scheduler.has_work)
        _profiled_run(eng, more, rec, args.profile, device)
    else:
        eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    finished = eng.finished if args.disagg else eng.scheduler.finished
    sched = eng.prefill.scheduler if args.disagg else eng.scheduler
    toks = sum(len(finished[r].generated) for r in rids)
    print(f"served {len(rids)} requests / {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) over {eng.steps_run} engine steps on "
          f"{device}")
    print(f"decode loop: K={eng.decode_steps}, {eng.decode_dispatches} "
          f"dispatches, {eng.page_table_uploads} page-table uploads, "
          f"{eng.token_host_bytes} token bytes to host")
    if args.disagg:
        print(f"disagg: {eng.handoffs} handoffs / {eng.handoff_pages} pages "
              f"/ {eng.handoff_bytes} posit8 bytes over the channel (depth "
              f"{eng.channel.depth}), {eng.decode_bounces} decode-side "
              f"bounces; pools prefill {eng.prefill.pool.n_pages} (peak "
              f"{eng.prefill.pool.alloc_peak}) / decode "
              f"{eng.decode.pool.n_pages} (peak "
              f"{eng.decode.pool.alloc_peak}) x {eng.page_size} slots")
    else:
        print(f"pool: {eng.pool.n_pages} pages x {eng.pool.page_size} "
              f"slots, peak used {eng.pool.alloc_peak}, preemptions "
              f"{sched.preemption_count} (mid-prefill "
              f"{sched.prefill_preemptions}, wasted prefill tokens "
              f"{sched.wasted_prefill_tokens})")
    chunk = eng.prefill_chunk_tokens
    print(f"prefill: {f'chunked, {chunk} tokens/step' if chunk else 'monolithic'}"
          f" ({eng.prefill_context} context), {eng.prefill_tokens_computed} "
          f"tokens computed")
    if args.prefix_cache:
        px = sched.prefix
        print(f"prefix cache: {px.hits} hits, {px.hit_tokens} prefill tokens "
              f"served from shared pages, {len(px)} pages cached, "
              f"{px.evictions} evictions")
    for r in rids[:2]:
        print(f"  req {r}: {np.asarray(finished[r].generated)}")
    if rec is not None:
        print("slo (ms):")
        for name, s in rec.slo_summary().items():
            print(f"  {name:>17}: p50 {s['p50']:8.2f}  p95 {s['p95']:8.2f}  "
                  f"p99 {s['p99']:8.2f}  (n={s['n']})")
    if args.trace:
        rec.write_chrome_trace(args.trace)
        print(f"wrote Chrome trace ({len(rec)} events) to {args.trace} -- "
              f"open in Perfetto (ui.perfetto.dev) or chrome://tracing")
    if args.metrics:
        print(eng.metrics.prometheus_text(), end="")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--policy", default="mixed",
                    help="mixed (the paper's posit8/FP4 scheme), a format "
                         "name for a uniform policy, or fp32/none")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--quantized-kv", action="store_true",
                    help="posit8 KV cache of the static engine (the "
                         "continuous engine always pages posit8 KV)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--continuous", "--paged", action="store_true",
                    help="serve through the paged-KV ContinuousEngine")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated prefill/decode serving: a prefill "
                         "worker and a decode worker joined by a posit8 "
                         "page-handoff channel (implies paged serving; "
                         "each side gets its own --n-pages pool)")
    ap.add_argument("--n-pages", type=int, default=48,
                    help="paged pool size (allocatable pages; per side "
                         "under --disagg)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per page (default: the decode KV block, "
                         "or --prefill-chunk when that is set)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: max prefill tokens one engine "
                         "step may process (default: monolithic)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share whole common-preamble pages between "
                         "requests; the mix gets a one-page shared preamble")
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="decode+sample iterations per dispatch "
                         "(temperature-0 output is the same for every K)")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="record request-lifecycle events and step spans "
                         "and write a Chrome-trace JSON (open in "
                         "Perfetto); paged engines only")
    ap.add_argument("--metrics", action="store_true",
                    help="print a Prometheus text snapshot of the "
                         "engine's metric registry after the run; paged "
                         "engines only")
    ap.add_argument("--profile", metavar="OUT.json", default=None,
                    help="run torch.profiler over the steps after the "
                         "first two, write its Chrome trace with the "
                         "engine's spans on its clock and print the "
                         "card's idle seconds by span; paged engines only")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device).manual_seed(args.seed)
    params = zoo.init_model(cfg, gen)
    policy = None
    if args.policy not in ("fp32", "none"):
        policy = (PrecisionPolicy.paper_mixed() if args.policy == "mixed"
                  else PrecisionPolicy.uniform(args.policy))
    if args.continuous or args.disagg:
        _continuous(args, cfg, params, policy, device)
    else:
        if args.trace or args.metrics or args.profile:
            print("note: --trace/--metrics need the paged engines "
                  "(--continuous/--disagg); the static engine carries "
                  "no telemetry")
        _static(args, cfg, params, policy, device, gen)


if __name__ == "__main__":
    main()
