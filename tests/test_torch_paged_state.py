"""Paged-STATE serving of the PyTorch port: the rwkv6 (ssm) and jamba
(hybrid) families under the port's continuous and disaggregated engines.

First every case of ``tests/test_paged_state.py`` on the port: at
temperature 0 the continuous and disaggregated engines give per-request
static ``ServeEngine.generate`` tokens (``quantized_kv=True,
quantized_state=True``, the static oracle of the slab plane) at K = 1
and 4, with chunked prefill, preemption snapshot/resume, slab-gated
admission and the disaggregated page + slab handoff (also through a
bounce), and ``state_slab_bytes`` is the size of an ``export_state``
payload.  Then the port against the JAX package on the same configs,
capacity factor and prompts: tokens equal to JAX's ``ContinuousEngine``
and ``DisaggEngine`` and the lifecycle logs equal event for event (in
float32, where no near-tie splits the two), posit8 state codes bitwise
equal after prefill, and the families' rejections with the reference's
messages.  JAX's parameters cross as numpy."""

import dataclasses
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import jax_to_numpy, one_torch_thread  # noqa: E402,F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.obs import TraceRecorder as JaxRecorder  # noqa: E402
from repro.serve import ContinuousEngine as JaxContinuous  # noqa: E402
from repro.serve import DisaggEngine as JaxDisagg  # noqa: E402
from repro.serve import PagedKVPool as JaxPool  # noqa: E402
from repro.serve import ServeEngine as JaxServe  # noqa: E402
from repro.serve.engine import build_prefill_chunk_step as jax_chunk_step  # noqa: E402
from repro.serve.scheduler import Scheduler as JaxScheduler  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.obs import TraceRecorder  # noqa: E402
from repro_torch.serve.disagg import DisaggEngine  # noqa: E402
from repro_torch.serve.engine import (ContinuousEngine, ServeEngine,  # noqa: E402
                                      build_prefill_chunk_step)
from repro_torch.serve.paged_kv import PagedKVPool, state_slab_bytes  # noqa: E402
from repro_torch.serve.scheduler import RUNNING, Scheduler  # noqa: E402

# the reduced hybrid takes a generous MoE capacity for exact static
# parity (no pair dropped in any batch layout), as the reference's test
RWKV = get_config("rwkv6-1.6b").reduced()
JAMBA = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                            capacity_factor=8.0)
JRWKV = jax_get_config("rwkv6-1.6b").reduced()
JJAMBA = dataclasses.replace(jax_get_config("jamba-v0.1-52b").reduced(),
                             capacity_factor=8.0)

# prompt lengths keep the reference's scan chunking exact:
# nchunks = max(s // ssm_chunk, 1) must divide s (ssm_chunk = 8)
PROMPTS = [np.arange(1, 13, dtype=np.int32),
           np.arange(3, 11, dtype=np.int32),
           np.arange(5, 11, dtype=np.int32)]
GENS = [6, 5, 7]
SIZES = {"rwkv": dict(max_len=48, page_size=16),
         "hybrid": dict(max_len=64, page_size=64)}


@pytest.fixture(scope="module")
def jparams():
    return {"rwkv": jT.lm_init(jax.random.PRNGKey(0), JRWKV),
            "hybrid": jT.lm_init(jax.random.PRNGKey(0), JJAMBA)}


@pytest.fixture(scope="module")
def tparams(jparams):
    return {k: params_from_numpy(jax_to_numpy(v), device="cpu")
            for k, v in jparams.items()}


def _cfg(family, f32=False):
    cfg = RWKV if family == "rwkv" else JAMBA
    return dataclasses.replace(cfg, dtype="float32") if f32 else cfg


def _jcfg(family, f32=False):
    cfg = JRWKV if family == "rwkv" else JJAMBA
    return dataclasses.replace(cfg, dtype="float32") if f32 else cfg


@pytest.fixture(scope="module")
def oracles(tparams):
    """Per-request static tokens of the port (bf16 configs)."""
    out = {}
    for family in ("rwkv", "hybrid"):
        st = ServeEngine(_cfg(family), tparams[family],
                         max_len=SIZES[family]["max_len"], quantized_kv=True,
                         quantized_state=True, device="cpu")
        out[family] = [st.generate(p[None], g)[0]
                       for p, g in zip(PROMPTS, GENS)]
    return out


def _check(outs, rids, want):
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(outs[rid], w)


def _continuous(family, params, **kw):
    kw = {"n_pages": 8, "max_batch": 4, **SIZES[family], **kw}
    return ContinuousEngine(_cfg(family), params, device="cpu", **kw)


def _disagg(family, params, **kw):
    kw = {"prefill_pages": 8, "decode_pages": 8, "max_batch": 4,
          **SIZES[family], **kw}
    return DisaggEngine(_cfg(family), params, prefill_device="cpu",
                        decode_device="cpu", **kw)


# ---------------------------------------------------------------------------
# the cases of tests/test_paged_state.py, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_continuous_matches_static_stateful(tparams, oracles, family, k):
    eng = _continuous(family, tparams[family], decode_steps=k)
    assert eng.pool.has_state
    rids = [eng.submit(p, g) for p, g in zip(PROMPTS, GENS)]
    _check(eng.run(), rids, oracles[family])
    # constant footprint: one slab per live request, never more
    assert eng.pool.slab_alloc_peak <= len(PROMPTS)
    assert eng.pool.used_slabs == 0


def test_continuous_chunked_prefill_stateful(tparams):
    """Unpadded chunks carrying the state across chunk boundaries give
    the monolithic prefill's tokens."""
    prompts = [np.arange(1, 33, dtype=np.int32),
               np.arange(2, 22, dtype=np.int32)]
    eng = _continuous("rwkv", tparams["rwkv"], decode_steps=2,
                      prefill_chunk_tokens=16)
    st = ServeEngine(RWKV, tparams["rwkv"], max_len=48, quantized_kv=True,
                     quantized_state=True, device="cpu")
    rids = [eng.submit(p, 6) for p in prompts]
    outs = eng.run()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(outs[rid], st.generate(p[None], 6)[0])


@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_continuous_preempt_resume_stateful_exact(tparams, oracles, family):
    """Preempting a RUNNING stateful request snapshots its slab (and its
    pages); resume imports it bitwise and decoding goes on exactly -- no
    re-prefill, nothing charged to wasted_prefill_tokens."""
    eng = _continuous(family, tparams[family], decode_steps=1)
    rids = [eng.submit(p, g) for p, g in zip(PROMPTS, GENS)]
    victim = None
    for _ in range(50):
        eng.step()
        victim = next(
            (r for r in eng.scheduler.running if r.status == RUNNING
             and len(r.generated) >= 2 and not r.done), None)
        if victim is not None:
            break
    assert victim is not None
    eng.scheduler.preempt(victim)
    assert victim.resume is not None and "state" in victim.resume
    assert ("kv" in victim.resume) == (family == "hybrid")
    assert eng.scheduler.wasted_prefill_tokens == 0
    _check(eng.run(), rids, oracles[family])
    assert eng.scheduler.preemption_count == 1
    assert victim.preemptions == 1


def test_continuous_slab_gated_admission(tparams, oracles):
    """n_state_slabs=1 serializes admission to one live request at a time
    while every request still finishes with exact outputs."""
    eng = _continuous("rwkv", tparams["rwkv"], decode_steps=1,
                      n_state_slabs=1)
    rids = [eng.submit(p, g) for p, g in zip(PROMPTS, GENS)]
    peak_running = 0
    while eng.scheduler.has_work:
        eng.step()
        peak_running = max(peak_running, len(eng.scheduler.running))
        assert eng.pool.used_slabs <= 1
    assert peak_running == 1
    assert eng.pool.slab_alloc_peak == 1
    outs = {rid: req.output for rid, req in eng.scheduler.finished.items()}
    _check(outs, rids, oracles["rwkv"])


@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_disagg_matches_static_stateful(tparams, oracles, family):
    """The nested {state [+ kv]} payload crosses the channel bitwise."""
    eng = _disagg(family, tparams[family], decode_steps=4)
    rids = [eng.submit(p, g) for p, g in zip(PROMPTS, GENS)]
    _check(eng.run(), rids, oracles[family])
    assert eng.handoffs == len(PROMPTS)
    assert eng.handoff_bytes >= len(PROMPTS) * state_slab_bytes(_cfg(family))
    assert eng.prefill.pool.used_slabs == 0      # released after export
    assert eng.decode.pool.used_slabs == 0       # freed at retirement


def test_disagg_bounce_resume_stateful_exact(tparams, oracles):
    """A decode-side bounce of a stateful request snapshots its slab; the
    admitter resumes it and hands it off again: outputs stay exact."""
    eng = _disagg("rwkv", tparams["rwkv"], decode_steps=1)
    rids = [eng.submit(p, g) for p, g in zip(PROMPTS, GENS)]
    bounced = False
    steps = 0
    while eng.has_work:
        eng.step()
        steps += 1
        if not bounced:
            run = [r for r in eng.decode.runner.running
                   if r.status == RUNNING and not r.done]
            if run:
                eng.decode.runner.bounce(run[-1])
                bounced = True
        assert steps < 500
    assert bounced and eng.decode.runner.bounce_count == 1
    outs = {rid: req.output for rid, req in eng.finished.items()}
    _check(outs, rids, oracles["rwkv"])


def test_state_slab_bytes_model():
    """Per-kind closed form: no slab plane for a pure-attention config; a
    stateful pool's modeled bytes per step charge one slab read + write
    per live request on top of its live KV pages."""
    dense = get_config("qwen2-0.5b").reduced()
    assert state_slab_bytes(dense) == 0
    sb = state_slab_bytes(RWKV)
    assert sb > 0
    pool = PagedKVPool(RWKV, 0, 16, n_slabs=2, device="cpu")
    assert pool.modeled_bytes_per_step([5]) == pytest.approx(2.0 * sb)
    assert pool.modeled_bytes_per_step([5, 9]) == pytest.approx(4.0 * sb)
    hyb = PagedKVPool(JAMBA, 4, 64, n_slabs=2, device="cpu")
    hsb = state_slab_bytes(JAMBA)
    kv_only = hyb.modeled_bytes_per_step([5]) - 2.0 * hsb
    assert hsb > 0 and kv_only > 0


@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_state_slab_bytes_is_the_export_size(family, group):
    """``state_slab_bytes`` == the bytes of an ``export_state`` payload,
    and equals the reference's closed form."""
    cfg = _cfg(family)
    pool = PagedKVPool(cfg, 2, 16, kv_group=group, n_slabs=3, device="cpu")
    sl = pool.alloc_slab()
    payload = pool.export_state(sl)
    nbytes = sum(v.numel() * v.element_size() for sub in [payload]
                 for v in _leaves(sub))
    from repro.serve import state_slab_bytes as jax_slab_bytes
    assert state_slab_bytes(cfg, group) == nbytes == \
        jax_slab_bytes(_jcfg(family), group)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

LOG_KINDS = ("ADMIT", "RESUME", "PREFILL_COMPLETE", "HANDOFF", "BOUNCE",
             "PREEMPT", "RETIRE")
# continuous: rwkv gated to two slabs; the hybrid on few enough 16-slot
# pages that a RUNNING request is preempted (snapshot) and resumes
JAX_CONT = {"rwkv": dict(n_pages=8, page_size=16, max_batch=4, max_len=48,
                         decode_steps=2, n_state_slabs=2),
            "hybrid": dict(n_pages=3, page_size=16, max_batch=4, max_len=64,
                           decode_steps=1, prefill_chunk_tokens=16)}
# disagg: the hybrid's decode pool is small enough that it bounces
JAX_DISAGG = {"rwkv": dict(prefill_pages=8, decode_pages=8, page_size=16,
                           max_batch=4, max_len=48, decode_steps=4),
              "hybrid": dict(prefill_pages=8, decode_pages=3, page_size=16,
                             max_batch=4, max_len=64, decode_steps=2,
                             prefill_chunk_tokens=16)}


def _log(rec):
    return [(e["kind"], e["rid"], e["args"].get("pages"))
            for e in rec.events() if e["kind"] in LOG_KINDS]


# longer generations than GENS, so that the hybrid outgrows its pages
TRACE_GENS = [10, 8, 12]


def _drive(eng):
    rids = [eng.submit(p, g) for p, g in zip(PROMPTS, TRACE_GENS)]
    out = eng.run()
    return [np.asarray(out[r]) for r in rids]


@pytest.fixture(scope="module")
def jax_runs(jparams):
    """Each JAX engine once, in float32."""
    runs = {}
    for family in ("rwkv", "hybrid"):
        jp = jax.tree.map(lambda t: t.astype(jnp.float32)
                          if t.dtype == jnp.bfloat16 else t, jparams[family])
        for kind, cls, kw in (("cont", JaxContinuous, JAX_CONT),
                              ("disagg", JaxDisagg, JAX_DISAGG)):
            rec = JaxRecorder()
            eng = cls(_jcfg(family, True), jp, trace=rec, **kw[family])
            runs[family, kind] = (_drive(eng), _log(rec), eng)
    return runs


@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_continuous_tokens_and_log_equal_jax(tparams, jax_runs, family):
    want, want_log, jeng = jax_runs[family, "cont"]
    rec = TraceRecorder()
    eng = ContinuousEngine(_cfg(family, True), tparams[family], trace=rec,
                           device="cpu", **JAX_CONT[family])
    got = _drive(eng)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert _log(rec) == want_log
    if family == "hybrid":       # the trace preempts a running request
        assert jeng.scheduler.preemption_count > 0
        assert any(k == "RESUME" for k, _, _ in want_log)
    else:                        # and gates admission on two slabs
        assert jeng.pool.slab_alloc_peak == 2
    assert eng.scheduler.preempted_log == jeng.scheduler.preempted_log
    assert eng.scheduler.wasted_prefill_tokens == \
        jeng.scheduler.wasted_prefill_tokens


@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_disagg_tokens_and_log_equal_jax(tparams, jax_runs, family):
    want, want_log, jeng = jax_runs[family, "disagg"]
    rec = TraceRecorder()
    eng = DisaggEngine(_cfg(family, True), tparams[family], trace=rec,
                       prefill_device="cpu", decode_device="cpu",
                       **JAX_DISAGG[family])
    got = _drive(eng)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert _log(rec) == want_log
    if family == "hybrid":
        assert jeng.decode_bounces > 0
    assert (eng.handoffs, eng.handoff_pages, eng.handoff_bytes,
            eng.decode_bounces) == (jeng.handoffs, jeng.handoff_pages,
                                    jeng.handoff_bytes, jeng.decode_bounces)


def _state_part(cache, family):
    return cache if family == "rwkv" else \
        {k: v for k, v in cache.items() if "k" not in v and "k_codes" not in v}


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, torch.Tensor):
        return {path: (tree.view(torch.int16) if tree.dtype == torch.bfloat16
                       else tree).numpy()}
    x = np.asarray(tree)
    return {path: x.view(np.int16) if x.dtype.name == "bfloat16" else x}


@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_prefilled_state_codes_equal_jax(jparams, tparams, family):
    """The posit8 state after prefill -- the bytes the continuous engine
    writes into a request's slab -- against JAX's, in float32.  The two
    f32 states agree within 1e-5 of each leaf's largest value; the port
    quantizes JAX's f32 state to JAX's codes and scales bitwise; its
    codes of its own state equal JAX's (scales bitwise) except where the
    two f32 values straddle a rounding boundary (one code step apart, at
    most 0.1% of the codes); its slab holds exactly the static engine's
    bytes."""
    from repro.models import zoo as jzoo
    from repro_torch.models import ssm as S
    from repro_torch.models import zoo
    cfg, jcfg = _cfg(family, True), _jcfg(family, True)
    prompt = PROMPTS[0][None]
    _, jraw, _ = jzoo.apply_model(jparams[family],
                                  {"tokens": jnp.asarray(prompt)}, jcfg,
                                  mode="prefill")
    _, traw = zoo.apply_model(tparams[family],
                              {"tokens": torch.from_numpy(prompt)}, cfg)
    jf, tf = _flat(_state_part(jraw, family)), _flat(_state_part(traw, family))
    for k in jf:
        np.testing.assert_allclose(tf[k], jf[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(jf[k]).max(), err_msg=k)
    jq = _flat(jzoo.quantize_cache(jraw, quantize_state=True))
    own = zoo.quantize_cache(traw, quantize_state=True)
    via_jax = _flat(zoo.quantize_cache(
        params_from_numpy(jax_to_numpy(jraw), device="cpu"),
        quantize_state=True))
    tq = _flat(own)
    assert sorted(jq) == sorted(tq) == sorted(via_jax)
    n_codes = n_diff = 0
    for k in jq:
        np.testing.assert_array_equal(via_jax[k], jq[k], err_msg=k)
        if not k.endswith("_codes") or k.rsplit("/", 1)[-1][0] in "kv":
            continue
        np.testing.assert_array_equal(tq[k.replace("_codes", "_scale")],
                                      jq[k.replace("_codes", "_scale")])
        diff = tq[k].astype(int) - jq[k].astype(int)
        n_codes += diff.size
        n_diff += int((diff != 0).sum())
        # the f32 values agree within the band above, so a code apart
        # is a value pair on the two sides of one rounding boundary
        assert np.abs(diff).max() <= 1, k
    assert n_diff <= n_codes // 1000
    # the engine's slab after prefill holds the static engine's bytes
    eng = ContinuousEngine(cfg, tparams[family], n_pages=4, page_size=16,
                           max_batch=2, max_len=64, device="cpu")
    eng.submit(PROMPTS[0], 4)
    eng.scheduler.admit()
    eng._prefill_phase()
    slab = _flat(eng.pool.export_state(eng.scheduler.running[0].slab))
    want = _flat(S.quantize_state(_state_part(traw, family)))
    assert sorted(slab) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(slab[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the families' rejections
# ---------------------------------------------------------------------------

def _msg(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_stateful_rejections_match_reference(tparams, jparams, family):
    cfg, jcfg = _cfg(family), _jcfg(family)
    kw = dict(max_len=64, page_size=16, max_batch=2)
    for extra in (dict(prefill_context="pages"), dict(prefix_cache=True)):
        want = _msg(lambda: JaxContinuous(jcfg, jparams[family], **kw,
                                          **extra))
        assert "recurrent state" in want
        assert _msg(lambda: ContinuousEngine(cfg, tparams[family], **kw,
                                             device="cpu", **extra)) == want
        want = _msg(lambda: JaxDisagg(jcfg, jparams[family], **kw, **extra))
        assert _msg(lambda: DisaggEngine(
            cfg, tparams[family], prefill_device="cpu", decode_device="cpu",
            **kw, **extra)) == want
    assert _msg(lambda: build_prefill_chunk_step(cfg, paged=True)) == \
        _msg(lambda: jax_chunk_step(jcfg, paged=True))
    # a stateful pool with no slab can serve nothing
    want = _msg(lambda: JaxScheduler(JaxPool(jcfg, 4, 16, n_slabs=0),
                                     2).submit(PROMPTS[0], 3))
    assert "n_slabs=0" in want
    assert _msg(lambda: Scheduler(PagedKVPool(cfg, 4, 16, n_slabs=0,
                                              device="cpu"),
                                  2).submit(PROMPTS[0], 3)) == want


def test_unknown_family_rejected_like_reference():
    cfg = dataclasses.replace(RWKV, family="audio")
    want = _msg(lambda: JaxPool.page_kinds(
        dataclasses.replace(JRWKV, family="audio")))
    assert _msg(lambda: PagedKVPool.page_kinds(cfg)) == want
    assert PagedKVPool.page_kinds(get_config("kimi-k2-1t-a32b")) == ("kv",)
    assert PagedKVPool.page_kinds(JAMBA) == ("kv", "state")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode", [("rwkv6-1.6b", "--continuous"),
                                       ("jamba-v0.1-52b", "--disagg"),
                                       ("rwkv6-1.6b", None),
                                       ("jamba-v0.1-52b", None)])
def test_cli_stateful(monkeypatch, capsys, arch, mode):
    """The reference CLI's example flags (``--reduced --policy mixed
    --batch 4 --prompt-len 16``) serve the recurrent and hybrid families:
    static (the ``generated`` line), continuous and disaggregated."""
    from repro_torch.launch import serve
    argv = ["serve", "--arch", arch, "--reduced", "--device", "cpu",
            "--policy", "mixed", "--batch", "4", "--prompt-len", "16",
            "--steps", "6"]
    if mode is not None:
        argv += [mode, "--n-pages", "48", "--prefill-chunk", "16",
                 "--decode-steps", "2"]
    monkeypatch.setattr(sys, "argv", argv)
    serve.main()
    out = capsys.readouterr().out
    if mode is None:
        assert re.search(r"generated \(4, 22\) in [\d.]+s", out), out
    else:
        assert "served 8 requests" in out, out
