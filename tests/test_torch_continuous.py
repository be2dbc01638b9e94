"""Continuous batching of the PyTorch port against the JAX package: the
scheduler on one trace (admission order, preemption and retirement logs,
prefix-cache counters), ``ContinuousEngine`` token for token on bridged
weights (carry and pages contexts, chunked and monolithic, K in {1, 4},
under preemption and prefix hits), the pool codes a prefill writes, the
port's own counter-based sampler, the copied ``obs`` registry and the
``--continuous`` CLI.

The carry context runs the default bfloat16 config.  The pages context
re-reads the prefix through posit8 pages in another summation order than
the reference's XLA loop, which splits a bf16 near-tie now and then, so
it runs the float32 config, where the two agree token for token."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import jax_to_numpy, one_torch_thread  # noqa: E402,F401
from repro import obs as jobs  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve import paged_kv as jpk  # noqa: E402
from repro.serve import scheduler as jsch  # noqa: E402
from repro.serve.engine import ContinuousEngine as JaxEngine  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serve import paged_kv as tpk  # noqa: E402
from repro_torch.serve import scheduler as tsch  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine, sample_tokens  # noqa: E402

JCFG = jax_get_config("qwen2-0.5b").reduced()
TCFG = get_config("qwen2-0.5b").reduced()
ENGINE = dict(n_pages=6, page_size=16, max_batch=4, max_len=64)


def _traffic():
    """Seven requests from numpy seed 0: long generations that outgrow
    their admission claim (so the 6-page pool preempts), and three that
    share a two-page preamble (so the prefix cache hits)."""
    rng = np.random.default_rng(0)
    pre = rng.integers(0, JCFG.vocab, 32).astype(np.int32)
    reqs = []
    for i, (n, new) in enumerate([(10, 30), (3, 20), (14, 28), (12, 12),
                                  (40, 7), (9, 10), (6, 5)]):
        prompt = rng.integers(0, JCFG.vocab, n).astype(np.int32)
        if i % 2:
            prompt = np.concatenate([pre, prompt])[:64 - new]
        reqs.append((prompt, new))
    return reqs


REQS = _traffic()


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def params():
    """The JAX parameters and their bridged copy (bf16 and f32 configs
    share the same f32 weights)."""
    jp = jT.lm_init(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax_to_numpy(jp), device="cpu")


def _run(engine_cls, cfg, p, reqs, **kw):
    eng = engine_cls(cfg, p, **{**ENGINE, **kw})
    rids = [eng.submit(prompt, new) for prompt, new in reqs]
    out = eng.run()
    return [np.asarray(out[r]) for r in rids], eng.scheduler


# scenario -> (float32 config?, engine options)
SCENARIOS = {
    "carry-chunked": (False, dict(prefill_chunk_tokens=16)),
    "carry-monolithic": (False, dict()),
    "pages-chunked-prefix": (True, dict(prefix_cache=True,
                                        prefill_chunk_tokens=16)),
    "pages-monolithic": (True, dict(prefill_context="pages")),
}

_JAX_RUNS = {}


def _jax_run(params, scenario, k):
    """The reference engine's run of a scenario (cached per module)."""
    key = (scenario, k)
    if key not in _JAX_RUNS:
        f32, kw = SCENARIOS[scenario]
        cfg = _f32(JCFG) if f32 else JCFG
        _JAX_RUNS[key] = _run(JaxEngine, cfg, params[0], REQS,
                              decode_steps=k, **kw)
    return _JAX_RUNS[key]


# (scenario, port K, reference K).  Under preemption the carry context
# re-prefills a victim's generated tokens from a bf16 carry instead of
# posit8 pages, so its tokens depend on where the preemption fell, which
# depends on K: compare the same K.  The pages context is K-invariant.
ENGINE_CASES = [("carry-chunked", 1, 1), ("carry-chunked", 4, 4),
                ("carry-monolithic", 1, 1), ("pages-chunked-prefix", 1, 1),
                ("pages-chunked-prefix", 4, 1), ("pages-monolithic", 4, 1)]


@pytest.mark.parametrize("scenario,k,jax_k", ENGINE_CASES)
def test_engine_tokens_equal_jax(params, scenario, k, jax_k):
    f32, kw = SCENARIOS[scenario]
    want, jsched = _jax_run(params, scenario, jax_k)
    got, tsched = _run(ContinuousEngine, _f32(TCFG) if f32 else TCFG,
                       params[1], REQS, decode_steps=k, device="cpu", **kw)
    assert jsched.preemption_count >= 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if k == jax_k:
        assert tsched.preempted_log == jsched.preempted_log
        assert tsched.retired_log == jsched.retired_log
        assert tsched.wasted_prefill_tokens == jsched.wasted_prefill_tokens
    if tsched.prefix is not None:
        assert tsched.prefix.hits >= 1
        if k == jax_k:
            assert (tsched.prefix.hits, tsched.prefix.hit_tokens) == \
                (jsched.prefix.hits, jsched.prefix.hit_tokens)


def test_prefilled_pool_codes_equal_jax(params):
    """The posit8 codes and scales a monolithic pages-context prefill
    writes into the pool (read back with ``gather_request``) are exactly
    the reference pool's, in the float32 config."""
    prompt, _ = REQS[4]
    pools = []
    for cls, cfg, p, extra in ((JaxEngine, _f32(JCFG), params[0], {}),
                               (ContinuousEngine, _f32(TCFG), params[1],
                                {"device": "cpu"})):
        eng = cls(cfg, p, prefill_context="pages", **ENGINE, **extra)
        eng.submit(prompt, 4)
        eng.step()                       # prefill + one decode dispatch
        (req,) = eng.scheduler.running
        n = req.position + 1             # live slots: prompt + 1 decoded
        pools.append({k: _bits(v)[:, :, :n] for k, v in
                      eng.pool.gather_request(req.pages).items()})
    want, got = pools
    for key in tpk.POOL_KEYS:
        np.testing.assert_array_equal(got[key], want[key])


def _bits(x) -> np.ndarray:
    """Codes as numpy; bf16 scales as their 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


# ---------------------------------------------------------------------------
# scheduler on one trace, no model
# ---------------------------------------------------------------------------

def _drive(sched_mod, pool):
    """A model-free engine loop: chunked page-in, capacity with a 2-slot
    horizon, one token per running request per step, deterministic
    tokens.  Returns the trace of observable scheduler decisions."""
    s = sched_mod.Scheduler(pool, max_batch=3, max_pages_per_req=8,
                            prefix_cache=True)
    rng = np.random.default_rng(3)
    pre = rng.integers(0, 50, 8).astype(np.int32)
    trace = []
    for step in range(80):
        if step < 24 and step % 2 == 0:
            tail = rng.integers(0, 50, int(rng.integers(1, 12)))
            prompt = np.concatenate([pre, tail]) if rng.random() < 0.6 \
                else tail
            s.submit(prompt, int(rng.integers(1, 9)))
        for r in list(s.running):
            if r.status == sched_mod.RUNNING:
                s.ensure_capacity(r, horizon=2)
        trace.append(("admit", [r.rid for r in s.admit()]))
        for r in [r for r in s.running if r.status == sched_mod.PREFILLING]:
            upto = min(r.prefilled + 4, len(r.prefix))
            if s.ensure_prefill_capacity(r, upto):
                r.prefilled = upto
                if upto == len(r.prefix):
                    r.generated.append((r.rid * 7 + len(r.generated)) % 50)
                    s.prefill_complete(r)
        for r in list(s.running):
            if r.status == sched_mod.RUNNING and s.ensure_capacity(r):
                r.generated.append((r.rid * 7 + len(r.generated)) % 50)
                if r.done:
                    s.retire(r)
        trace.append(("state", s.epoch, [(r.rid, r.status, list(r.pages))
                                         for r in s.running],
                      [r.rid for r in s.waiting], pool.free_pages))
    reqs = {**{r.rid: r for r in s.running}, **s.finished,
            **{r.rid: r for r in s.waiting}}
    trace.append(("logs", s.preempted_log, s.retired_log,
                  {rid: (r.preemptions, r.cached_tokens, list(r.generated))
                   for rid, r in reqs.items()}))
    trace.append(("counters", s.preemption_count, s.prefill_preemptions,
                  s.wasted_prefill_tokens, s.prefix.hits,
                  s.prefix.hit_tokens, s.prefix.misses, s.prefix.evictions,
                  sorted(s.prefix.cached_pages)))
    return trace


def test_scheduler_trace_equals_jax():
    want = _drive(jsch, jpk.PagedKVPool(JCFG, 9, 4))
    got = _drive(tsch, tpk.PagedKVPool(TCFG, 9, 4, device="cpu"))
    assert got == want
    logs = want[-2]
    assert logs[1] and logs[2]           # it preempted and retired
    assert want[-1][3] >= 1 and want[-1][6] >= 1   # hits and evictions


def test_scheduler_rejects_what_the_reference_rejects():
    s = tsch.Scheduler(tpk.PagedKVPool(TCFG, 4, 4, device="cpu"), 2,
                       max_pages_per_req=3)
    with pytest.raises(ValueError, match="pool only has"):
        s.submit(np.arange(1, 20), 4)
    with pytest.raises(ValueError, match="exceeds max_len"):
        s.submit(np.arange(1, 12), 4)


# ---------------------------------------------------------------------------
# the port's own sampler and engine contract
# ---------------------------------------------------------------------------

def test_sampler_is_a_function_of_seed_rid_and_index():
    logits = torch.from_numpy(np.random.default_rng(4).normal(
        size=(6, 64)).astype(np.float32))
    rids = torch.tensor([3, 1, 4, 1, 5, 9], dtype=torch.int32)
    idx = torch.tensor([0, 2, 7, 3, 1, 0], dtype=torch.int32)
    a = sample_tokens(logits, 0.8, 11, rids, idx)
    perm = torch.tensor([5, 2, 0, 4, 1, 3])
    b = sample_tokens(logits[perm], 0.8, 11, rids[perm], idx[perm])
    assert torch.equal(a[perm], b)                # row order is irrelevant
    many = torch.stack([sample_tokens(logits, 0.8, s, rids, idx)
                        for s in range(8)])
    assert len({tuple(r.tolist()) for r in many}) > 1   # seeds differ
    ties = torch.zeros((2, 5))
    ties[:, 2:4] = 1.0
    assert sample_tokens(ties, 0.0, 0, rids[:2], idx[:2]).tolist() == [2, 2]


def test_sampling_is_k_and_schedule_invariant(params):
    """temperature > 0: the same seed gives every request the same tokens
    for K = 1 and K = 4 and with staggered arrivals; another seed does
    not."""
    cfg = _f32(TCFG)
    kw = dict(temperature=0.8, device="cpu", prefill_context="pages",
              **ENGINE)

    def run(k, seed, staggered=False):
        eng = ContinuousEngine(cfg, params[1], decode_steps=k, seed=seed,
                               **kw)
        rids = [eng.submit(p, n) for p, n in REQS[:4]]
        if staggered:
            for _ in range(3):
                eng.step()
        rids += [eng.submit(p, n) for p, n in REQS[4:]]
        out = eng.run()
        return [out[r] for r in rids]

    a, b, c = run(1, 3), run(4, 3), run(4, 3, staggered=True)
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert any(not np.array_equal(x, y) for x, y in zip(a, run(1, 4)))


def test_engine_trace_counters_and_reset(params):
    """Tracing leaves the tokens unchanged; lifecycle counts tie out with
    the engine counters; ``reset_counters`` zeroes every registry."""
    kw = dict(device="cpu", prefix_cache=True, prefill_chunk_tokens=16,
              decode_steps=2)
    plain, _ = _run(ContinuousEngine, TCFG, params[1], REQS[:3], **kw)
    rec = tobs.TraceRecorder()
    eng = ContinuousEngine(TCFG, params[1], trace=rec, **{**ENGINE, **kw})
    rids = [eng.submit(p, n) for p, n in REQS[:3]]
    out = eng.run()
    for r, want in zip(rids, plain):
        np.testing.assert_array_equal(out[r], want)
    assert rec.count("DECODE_DISPATCH") == eng.decode_dispatches > 0
    assert rec.count("RETIRE") == 3 == len(eng.scheduler.retired_log)
    assert rec.arg_sum("DECODE_SYNC", "token_bytes") == eng.token_host_bytes
    assert eng.metrics.value("engine/decode_dispatches") == \
        eng.decode_dispatches
    assert eng.metrics.value("pool/used_pages") == eng.pool.used_pages
    eng.reset_counters()
    snap = eng.metrics.snapshot()
    assert all(v == 0 for k, v in snap.items()
               if k.startswith(("engine/", "scheduler/"))
               and not k.endswith("hit_rate")
               and k != "engine/kv_bytes_per_step_model")
    assert eng.pool.alloc_peak == eng.pool.used_pages


def test_engine_rejects_bad_configurations(params):
    with pytest.raises(ValueError, match="pages"):
        ContinuousEngine(TCFG, params[1], prefix_cache=True,
                         prefill_context="carry", device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="multiple of page_size"):
        ContinuousEngine(TCFG, params[1], prefill_chunk_tokens=24,
                         device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="must be a multiple"):
        ContinuousEngine(TCFG, params[1], device="cpu",
                         **{**ENGINE, "max_len": 56})
    with pytest.raises(ValueError, match="no page-kind mapping"):
        ContinuousEngine(dataclasses.replace(TCFG, family="audio"),
                         params[1], device="cpu", **ENGINE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ContinuousEngine(TCFG, params[1], **ENGINE)


def test_continuous_cli_on_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--reduced", "--continuous", "--batch",
        "2", "--prompt-len", "12", "--steps", "5", "--n-pages", "8",
        "--prefill-chunk", "16", "--prefix-cache", "--decode-steps", "2"])
    serve.main()
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "prefix cache:" in out


# ---------------------------------------------------------------------------
# the copied obs package
# ---------------------------------------------------------------------------

def _exercise(mod):
    """One sequence of registry and recorder operations."""
    reg = mod.MetricRegistry()

    class Owner:
        _COUNTERS = ("a", "b")

    o = Owner()
    mod.bind_counters(o, reg, "own")
    o.a += 3
    o.b = 2.5
    box = [7]
    reg.gauge("g/live", fn=lambda: box[0])
    reg.gauge("g/set").set(4)
    h = reg.histogram("h/lat")
    for v in (1e-4, 3e-3, 3e-3, 0.2, 50.0):
        h.observe(v)
    rec = mod.TraceRecorder(capacity=4)
    rec.hist_registry = reg
    for i in range(6):
        rec.event("SUBMIT", rid=i, prompt_tokens=10 + i)
    with rec.span("step"):
        pass
    snap = reg.snapshot()
    snap.pop("span/step")                # a measured duration
    out = (snap, reg.prometheus_text().split("repro_span_step")[0],
           rec.count("SUBMIT"), rec.arg_sum("SUBMIT", "prompt_tokens"),
           rec.dropped, len(rec), mod.summarize([1.0, 2.0, 4.0]),
           mod.percentiles([1.0, 2.0, 3.0, 4.0]))
    o.a = 0
    reg.reset()
    return out + (reg.snapshot()["own/a"], reg.value("g/live"))


def test_obs_copy_matches_reference():
    assert _exercise(tobs) == _exercise(jobs)
    assert tobs.LIFECYCLE_EVENTS == jobs.LIFECYCLE_EVENTS
    assert tobs.SPAN_KINDS == jobs.SPAN_KINDS
    rec = tobs.TraceRecorder()
    rec.event("SUBMIT", rid=0)
    with rec.span("step"):
        pass
    counts = tobs.validate_chrome_trace(rec.chrome_trace())
    assert counts == jobs.validate_chrome_trace(rec.chrome_trace())
    assert counts["spans"] == 1 and counts["instants"] == 1
