"""Disaggregated serving of the PyTorch port (``repro_torch.serve.disagg``)
against the JAX package and against its own engines: the page handoff
(export/import bitwise, bytes equal to ``page_handoff_bytes``), the
channel's depth and backpressure, decode-pool pressure that bounces, the
``submit`` guard, temperature-0 parity with the port's continuous and
static engines at K = 1 and 4 (also with the prefix cache), the tokens
and the admit/handoff/bounce/retire log of JAX's ``DisaggEngine`` on one
trace, and the ``--disagg`` CLI.

The carry context runs the default bfloat16 config.  Runs on the pages
context (prefix cache) use the float32 config, where the port and JAX
agree token for token (in bf16 a near-tie splits now and then)."""

import dataclasses
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import jax_to_numpy, one_torch_thread  # noqa: E402,F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.obs import TraceRecorder as JaxRecorder  # noqa: E402
from repro.serve.disagg import DisaggEngine as JaxDisagg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.obs import TraceRecorder  # noqa: E402
from repro_torch.serve.disagg import DisaggEngine, PageHandoffChannel  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine, ServeEngine  # noqa: E402
from repro_torch.serve.paged_kv import (POOL_KEYS, PagedKVPool,  # noqa: E402
                                        page_handoff_bytes)

JCFG = jax_get_config("qwen2-0.5b").reduced()
CFG = get_config("qwen2-0.5b").reduced()
F32 = dataclasses.replace(CFG, dtype="float32")
SIZES = dict(page_size=16, max_batch=8, max_len=48)


def _reqs(seed, spec):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG.vocab, (n,)).astype(np.int32), g)
            for n, g in spec]



@pytest.fixture(scope="module")
def jparams():
    return jT.lm_init(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax_to_numpy(jparams), device="cpu")


def _drive(eng, reqs):
    rids = [eng.submit(p, g) for p, g in reqs]
    out = eng.run()
    return [np.asarray(out[r]) for r in rids]


def _disagg(cfg, params, reqs, **kw):
    kw = {"prefill_pages": 40, "decode_pages": 40, **SIZES, **kw}
    eng = DisaggEngine(cfg, params, prefill_device="cpu",
                       decode_device="cpu", **kw)
    return _drive(eng, reqs), eng


def _continuous(cfg, params, reqs, n_pages=40, **kw):
    eng = ContinuousEngine(cfg, params, n_pages=n_pages, device="cpu",
                           **{**SIZES, **kw})
    return _drive(eng, reqs), eng


# ---------------------------------------------------------------------------
# the page handoff
# ---------------------------------------------------------------------------

def _filled_pool(seed):
    pool = PagedKVPool(CFG, 8, 16, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for key in POOL_KEYS:
        leaf = getattr(pool, key)
        if leaf.dtype == torch.uint8:
            leaf.copy_(torch.randint(0, 256, leaf.shape, generator=gen))
        else:
            leaf.copy_(2.0 ** torch.randint(-4, 5, leaf.shape, generator=gen))
    return pool


def test_export_import_roundtrip_bitwise():
    """Exported pages land bitwise in another pool at other page ids; the
    payload is a copy (freeing the source pages leaves it intact); the
    destination pages hold refcount 1, the source ones are untouched."""
    src = _filled_pool(3)
    dst = PagedKVPool(CFG, 8, 16, device="cpu")
    pages = src.alloc(3)
    payload = src.export_pages(pages)
    got = dst.alloc(4)
    target = [got[2], got[0], got[3]]
    dst.import_pages(payload, target)
    for key in POOL_KEYS:
        assert torch.equal(getattr(dst, key)[:, target],
                           getattr(src, key)[:, pages]), key
    assert all(dst.refcount(pg) == 1 for pg in got)
    assert all(src.refcount(pg) == 1 for pg in pages)
    snap = {k: v.clone() for k, v in payload.items()}
    src.free(pages)
    for key in POOL_KEYS:
        getattr(src, key).zero_()
        assert torch.equal(payload[key], snap[key])
    assert src.used_pages == 0


def test_import_rejects_a_payload_of_another_geometry():
    src = _filled_pool(4)
    payload = src.export_pages(src.alloc(2))
    with pytest.raises(ValueError, match="do not fit"):
        PagedKVPool(CFG, 8, 8, device="cpu").import_pages(payload, [1, 2])
    with pytest.raises(ValueError, match="do not fit"):
        PagedKVPool(CFG, 8, 16, device="cpu").import_pages(payload, [1])


@pytest.mark.parametrize("group", [None, 8])
def test_handoff_bytes_model(group):
    """The payload's size is exactly the per-page posit8 model: 2 (K+V)
    x layers x page x kv heads x (codes + 2-byte scales)."""
    pool = PagedKVPool(CFG, 8, 16, group, device="cpu")
    payload = pool.export_pages(pool.alloc(3))
    nbytes = sum(v.numel() * v.element_size() for v in payload.values())
    assert nbytes == 3 * page_handoff_bytes(CFG, 16, group)


def test_channel_depth_and_counters():
    ch = PageHandoffChannel(depth=1)
    pool = PagedKVPool(CFG, 8, 16, device="cpu")
    payload = pool.export_pages(pool.alloc(2))

    class _Req:          # the channel reads only the rid
        rid = 0

    ch.push(_Req(), payload)
    assert ch.full and len(ch) == 1
    with pytest.raises(AssertionError):
        ch.push(_Req(), payload)
    assert ch.handoffs == 1 and ch.handoff_pages == 2
    assert ch.handoff_bytes == 2 * page_handoff_bytes(CFG, 16)
    ch.pop()
    assert not ch.full and len(ch) == 0
    with pytest.raises(ValueError, match="depth"):
        PageHandoffChannel(depth=0)


# ---------------------------------------------------------------------------
# temperature-0 parity inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_steps", [1, 4])
def test_disagg_matches_continuous_and_static(params, k_steps):
    """Ample pools: disagg == continuous == per-request static generate,
    every request crosses once at the page-byte model, both pools drain,
    and the decode worker's page table stays epoch-cached."""
    reqs = _reqs(11, [(3, 6), (19, 8), (8, 4), (10, 12), (5, 9)])
    kw = dict(prefill_chunk_tokens=16, decode_steps=k_steps)
    disagg, eng = _disagg(CFG, params, reqs, **kw)
    inter, _ = _continuous(CFG, params, reqs, **kw)
    static = ServeEngine(CFG, params, max_len=48, quantized_kv=True,
                         device="cpu")
    for got_d, got_i, (p, g) in zip(disagg, inter, reqs):
        np.testing.assert_array_equal(got_d, got_i)
        np.testing.assert_array_equal(got_d,
                                      static.generate(p[None], steps=g)[0])
    assert eng.prefill.scheduler.preemption_count == 0
    assert eng.decode_bounces == 0
    assert eng.handoffs == len(reqs)
    assert eng.handoff_bytes == eng.handoff_pages * page_handoff_bytes(CFG,
                                                                       16)
    assert eng.prefill.pool.used_pages == 0
    assert eng.decode.pool.used_pages == 0
    assert eng.page_table_uploads < eng.decode_dispatches
    assert eng.last_decode_step_s > 0


def _prefix_reqs():
    rng = np.random.default_rng(12)
    pre = rng.integers(0, CFG.vocab, (16,)).astype(np.int32)
    return [(np.concatenate([pre, rng.integers(0, CFG.vocab, (n,))])
             .astype(np.int32), g) for n, g in ((3, 6), (5, 8), (2, 7),
                                                (9, 5))]


def _drive_staggered(eng, reqs):
    """The first request alone for three steps (its preamble pages get
    published), then the rest."""
    rids = [eng.submit(*reqs[0])]
    for _ in range(3):
        eng.step()
    rids += [eng.submit(p, g) for p, g in reqs[1:]]
    out = eng.run()
    return [np.asarray(out[r]) for r in rids]


@pytest.mark.parametrize("k_steps", [1, 4])
def test_disagg_prefix_cache_matches_continuous(params, k_steps):
    """Shared-preamble requests hit the PREFILL side's prefix index as
    they hit the interleaved engine's; tokens equal (pages context,
    float32)."""
    reqs = _prefix_reqs()
    kw = dict(page_size=16, max_batch=4, max_len=48,
              prefill_chunk_tokens=16, prefix_cache=True,
              decode_steps=k_steps)
    eng_i = ContinuousEngine(F32, params, n_pages=40, device="cpu", **kw)
    inter = _drive_staggered(eng_i, reqs)
    eng_d = DisaggEngine(F32, params, prefill_pages=40, decode_pages=40,
                         prefill_device="cpu", decode_device="cpu", **kw)
    disagg = _drive_staggered(eng_d, reqs)
    assert eng_d.prefill.scheduler.prefix.hits == \
        eng_i.scheduler.prefix.hits > 0
    for a, b in zip(inter, disagg):
        np.testing.assert_array_equal(a, b)


def test_disagg_instant_done_retires_prefill_side(params):
    """A budget-1 request finishes at prefill completion and never
    crosses the channel."""
    (p, _), = _reqs(13, [(7, 1)])
    out, eng = _disagg(CFG, params, [(p, 1)])
    static = ServeEngine(CFG, params, max_len=48, quantized_kv=True,
                         device="cpu")
    np.testing.assert_array_equal(out[0], static.generate(p[None], 1)[0])
    assert eng.handoffs == 0 and eng.decode_dispatches == 0
    assert list(eng.prefill.scheduler.finished) == [0]


def test_disagg_channel_backpressure_depth1(params):
    """A depth-1 channel parks completed prefills holding their pages;
    outputs do not change and every request crosses exactly once."""
    reqs = _reqs(14, [(4, 6), (6, 8), (9, 5), (5, 7)])
    base, _ = _disagg(CFG, params, reqs, decode_steps=2)
    tight, eng = _disagg(CFG, params, reqs, decode_steps=2, channel_depth=1)
    for a, b in zip(base, tight):
        np.testing.assert_array_equal(a, b)
    assert eng.handoffs == len(reqs)


def test_disagg_decode_pool_pressure_bounces(params):
    """A starved decode pool bounces requests back across the split: the
    run is deterministic, both pools drain, and requests never bounced
    match the ample-pool interleaved stream."""
    reqs = _reqs(15, [(10, 20), (12, 18), (9, 22), (11, 16)])
    kw = dict(page_size=8, max_batch=4, max_len=40)
    ample, _ = _continuous(CFG, params, reqs, n_pages=32, decode_steps=1,
                           **kw)
    kw_d = dict(prefill_pages=32, decode_pages=7, decode_steps=4, **kw)
    starved, eng = _disagg(CFG, params, reqs, **kw_d)
    starved2, _ = _disagg(CFG, params, reqs, **kw_d)
    assert eng.decode_bounces > 0
    for a, b in zip(starved, starved2):
        np.testing.assert_array_equal(a, b)
    fin = eng.finished
    for out_a, out_s, rid in zip(ample, starved, sorted(fin)):
        if fin[rid].preemptions == 0:
            np.testing.assert_array_equal(out_a, out_s)
    sched = eng.prefill.scheduler
    assert sched.preemption_count >= eng.decode_bounces
    assert sched.wasted_prefill_tokens > 0
    assert eng.prefill.pool.used_pages == 0
    assert eng.decode.pool.used_pages == 0


def test_disagg_submit_rejects_decode_overflow(params):
    """The no-livelock guard: a request whose total footprint exceeds the
    decode pool is rejected at submit."""
    eng = DisaggEngine(CFG, params, prefill_pages=40, decode_pages=2,
                       page_size=16, max_batch=4, max_len=48,
                       prefill_device="cpu", decode_device="cpu")
    with pytest.raises(ValueError, match="decode pool"):
        eng.submit(_reqs(16, [(20, 20)])[0][0], 20)


def _assert_registry_zero(obj, label):
    for c in type(obj)._COUNTERS:
        assert getattr(obj, c) == 0, f"{label}.{c} survived reset"
        assert obj._obs_counters[c].value == 0, f"{label}.{c} registry"


def test_disagg_counter_registry_reset(params):
    eng = DisaggEngine(CFG, params, prefill_pages=40, decode_pages=40,
                       page_size=16, max_batch=4, max_len=48,
                       prefill_chunk_tokens=16, prefix_cache=True,
                       prefill_device="cpu", decode_device="cpu")
    eng.submit(*_reqs(17, [(5, 3)])[0])
    eng.run()
    assert eng.handoffs > 0 and eng.decode_dispatches > 0
    assert eng.metrics.value("channel/handoffs") == eng.handoffs
    assert eng.metrics.value("decode/decode_dispatches") == \
        eng.decode_dispatches
    assert eng.metrics.value("prefill/prefill_tokens_computed") == \
        eng.prefill_tokens_computed
    eng.reset_counters()
    _assert_registry_zero(eng, "disagg")
    _assert_registry_zero(eng.prefill, "prefill-worker")
    _assert_registry_zero(eng.decode, "decode-worker")
    _assert_registry_zero(eng.prefill.scheduler, "admitter")
    _assert_registry_zero(eng.prefill.scheduler.prefix, "prefix")
    _assert_registry_zero(eng.decode.runner, "runner")
    _assert_registry_zero(eng.channel, "channel")
    assert eng.decode.runner.retired_log == []


# ---------------------------------------------------------------------------
# against JAX's DisaggEngine on one trace
# ---------------------------------------------------------------------------

# six requests, three of them behind a shared one-page preamble (prefix
# hits), on a decode pool small enough that they bounce
JAX_TRACE = dict(prefill_pages=24, decode_pages=7, page_size=16,
                 max_batch=4, max_len=64, prefill_chunk_tokens=16,
                 prefix_cache=True, decode_steps=4)
LOG_KINDS = ("ADMIT", "PREFILL_COMPLETE", "HANDOFF", "BOUNCE", "PREEMPT",
             "RETIRE")


def _jax_trace_reqs():
    rng = np.random.default_rng(18)
    pre = rng.integers(0, CFG.vocab, (16,)).astype(np.int32)
    reqs = []
    for i, (n, g) in enumerate(((4, 20), (9, 24), (7, 18), (12, 20),
                                (2, 10), (5, 8))):
        prompt = rng.integers(0, CFG.vocab, (n,)).astype(np.int32)
        if i % 2 == 0:
            prompt = np.concatenate([pre, prompt])
        reqs.append((prompt, g))
    return reqs


def _log(rec):
    """The lifecycle log: (kind, rid, pages) of every event that moves a
    request between the admitter, the channel and the decode side."""
    return [(e["kind"], e["rid"], e["args"].get("pages"))
            for e in rec.events() if e["kind"] in LOG_KINDS]


@pytest.fixture(scope="module")
def jax_run(jparams):
    rec = JaxRecorder()
    eng = JaxDisagg(dataclasses.replace(JCFG, dtype="float32"), jparams,
                    trace=rec, **JAX_TRACE)
    out = _drive(eng, _jax_trace_reqs())
    return out, _log(rec), eng


def test_disagg_tokens_and_logs_equal_jax(params, jax_run):
    want, want_log, jeng = jax_run
    rec = TraceRecorder()
    eng = DisaggEngine(F32, params, prefill_device="cpu",
                       decode_device="cpu", trace=rec, **JAX_TRACE)
    got = _drive(eng, _jax_trace_reqs())
    assert jeng.decode_bounces > 0 and jeng.prefill.scheduler.prefix.hits > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert _log(rec) == want_log
    assert (eng.handoffs, eng.handoff_pages, eng.handoff_bytes,
            eng.decode_bounces) == (jeng.handoffs, jeng.handoff_pages,
                                    jeng.handoff_bytes, jeng.decode_bounces)
    assert eng.prefill.scheduler.preempted_log == \
        jeng.prefill.scheduler.preempted_log
    assert eng.decode.runner.retired_log == jeng.decode.runner.retired_log


def test_disagg_k1_equals_jax_tokens(params, jax_run):
    """The pages context is K-invariant: the port at K=1 gives the JAX
    run's (K=4) tokens for every request neither run bounced."""
    want, _, jeng = jax_run
    eng = DisaggEngine(F32, params, prefill_device="cpu",
                       decode_device="cpu", **{**JAX_TRACE,
                                               "decode_steps": 1})
    got = _drive(eng, _jax_trace_reqs())
    for rid, (g, w) in enumerate(zip(got, want)):
        if eng.finished[rid].preemptions == 0 and \
                jeng.finished[rid].preemptions == 0:
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_disagg(monkeypatch, capsys):
    """The reference CLI's example flags (``--disagg --batch 8 --n-pages
    48 --prefill-chunk 16 --decode-steps 4``) serve every request; the
    handoff line's bytes are its pages x ``page_handoff_bytes``."""
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen2-0.5b", "--reduced", "--disagg", "--device",
        "cpu", "--batch", "8", "--n-pages", "48", "--prefill-chunk", "16",
        "--decode-steps", "4", "--steps", "8"])
    serve.main()
    out = capsys.readouterr().out
    assert "served 16 requests" in out
    m = re.search(r"disagg: (\d+) handoffs / (\d+) pages / (\d+) posit8 "
                  r"bytes over the channel \(depth 2\), (\d+) decode-side "
                  r"bounces", out)
    assert m is not None, out
    handoffs, pages, nbytes, _ = map(int, m.groups())
    assert handoffs == 16
    assert nbytes == pages * page_handoff_bytes(CFG, 16)
