"""Shapes the port's attention kernels take beyond qwen2-0.5b's (pages over
128 slots, head widths other than 32/64/128) and the launch plans of the
engine-plane kernels, on the CPU.

- The sub-page rule and the head widths in Python are held to the
  constants of ``csrc/flash_decode.cu`` and to its shared-memory sum.
- ``ContinuousEngine`` at page 256 (256-token chunks) gives JAX's tokens
  and the port's page-128 tokens; the CLI's page choice (the chunk, when
  no ``--page-size`` is given) runs to its end.
- Static ``generate`` at head_dim 256 and 112 (the reduced qwen2 with the
  head widths of gemma-2b and kimi-k2): prefill logits within the serve
  tests' float32 tolerance and greedy tokens equal to JAX's.
- Heads wider than 256 columns: the route choice and the wide route's
  limit held to the ``.cu``; the plain versions at Dh 320 against the
  reference's blocked loops.
- ``dequant_plan`` and ``quire_route`` against ``csrc/dequant.cu`` and
  ``csrc/quire_dot.cu``.
"""

import dataclasses
import math
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
from repro.core.policy import PrecisionPolicy as JaxPolicy  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.serve.engine import ContinuousEngine as JaxContinuous  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import codec as kcodec  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import quire_dot as kquire  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine, ServeEngine  # noqa: E402

JCFG = jax_get_config("qwen2-0.5b").reduced()
TCFG = get_config("qwen2-0.5b").reduced()
LOGIT_TOL = 1e-5      # float32 config: only the sum order differs
SMEM_LIMIT = 232448   # dynamic shared memory a block may use (H100)


def _source(name):
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        return f.read()


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


# ---------------------------------------------------------------------------
# the attention kernels' sub-page rule and widths
# ---------------------------------------------------------------------------

FLASH = _source("flash_decode.cu")


def _smem_bytes(page, kh, gs, dh, nbuf, teams):
    """``smem_bytes`` of csrc/flash_decode.cu, term for term."""
    def a16(x):
        return (x + 15) & ~15
    rows, team_warps = _const(FLASH, "ROWS"), _const(FLASH, "TEAM") // 32
    ldp = (fd.MAX_SUB if dh <= 128 else fd.MAX_SUB_WIDE) + 8
    team = (3 * rows * (dh + 8) * 2 + 3 * rows * ldp * 2
            + (2 * team_warps * rows + 16) * 4)
    stage = 2 * page * dh + 2 * a16(page * kh * gs * 2)
    return (_const(FLASH, "LUT_BYTES") + nbuf * stage
            + 2 * a16(page) * (dh + 8) * 2 + teams * team)


def _prefill_teams(width):
    m = re.search(r"TEAMS = DH >= (\d+) \? 1 : 2;", FLASH)
    return 1 if width >= int(m.group(1)) else 2


def test_widths_and_sub_page_caps_match_the_cuda_source():
    assert _const(FLASH, "MAXP") == fd.MAX_SUB
    assert _const(FLASH, "MAXP_WIDE") == fd.MAX_SUB_WIDE
    body = re.search(r"constexpr int width_of\(int Dh\) \{\s*return ([^;]*);",
                     FLASH).group(1)
    assert tuple(sorted({int(x) for x in re.findall(r"\d+", body)})) \
        == fd.KERNEL_WIDTHS
    cap = re.search(r"max_sub\(int DH\) \{ return DH <= (\d+) \? MAXP : "
                    r"MAXP_WIDE; \}", FLASH)
    assert int(cap.group(1)) == 128
    # every width is instantiated for full and other sub-pages and for a
    # narrower head, and both entry points dispatch through that list
    for w in fd.KERNEL_WIDTHS:
        for flags in ("true, false", "false, false", "false, true"):
            assert f"LAUNCH({w}, {flags})" in FLASH
    assert FLASH.count("XRNPE_DISPATCH(XRNPE_") == 2


@pytest.mark.parametrize("kh,gs", [(1, 1), (1, 8), (2, 1), (2, 2), (8, 8)])
def test_sub_page_cap_is_what_shared_memory_holds(kh, gs):
    """The prefill (two stage buffers) at the widest width takes 64-slot
    sub-pages and not 128 (gemma-2b: Kh = 1; group 32: Gs = 8); the
    widths up to 128 take 128-slot sub-pages at qwen2-0.5b's Kh = 2."""
    w = 256
    assert _smem_bytes(fd.MAX_SUB_WIDE, kh, gs, w, 2, _prefill_teams(w)) \
        <= SMEM_LIMIT
    assert _smem_bytes(fd.MAX_SUB, kh, gs, w, 2, _prefill_teams(w)) \
        > SMEM_LIMIT
    if kh <= 2:
        for w in (32, 64, 128):
            assert _smem_bytes(fd.MAX_SUB, kh, gs, w, 2,
                               _prefill_teams(w)) <= SMEM_LIMIT


@pytest.mark.parametrize("page,dh,sub", [
    (128, 64, 128), (256, 64, 128), (512, 128, 128), (131, 64, 1),
    (100, 64, 100), (384, 32, 128), (192, 64, 96), (1, 64, 1), (7, 40, 7),
    (128, 256, 64), (256, 256, 64), (100, 200, 50), (128, 112, 128),
    (96, 129, 48)])
def test_sub_page_is_the_largest_divisor_that_fits(page, dh, sub):
    got = fd.sub_page(page, dh)
    assert got == sub
    cap = fd.MAX_SUB if fd.kernel_width(dh) <= 128 else fd.MAX_SUB_WIDE
    assert page % got == 0 and got <= cap
    assert not any(page % d == 0 for d in range(got + 1, cap + 1))


def test_prefill_smem_model_matches_the_cuda_source():
    """The Python model that sizes sub-pages is ``smem_bytes`` of the .cu
    (this file's own term-for-term copy) over pages, heads and groups."""
    assert (fd.LUT_BYTES, fd.ROWS, fd.TEAM_WARPS) == (
        _const(FLASH, "LUT_BYTES"), _const(FLASH, "ROWS"),
        _const(FLASH, "TEAM") // 32)
    assert fd.SMEM_LIMIT == SMEM_LIMIT
    for sub in (1, 7, 64, 128):
        for kh, gs in ((1, 1), (2, 8), (8, 1), (8, 16), (16, 32)):
            for w in fd.KERNEL_WIDTHS:
                assert fd.prefill_smem_bytes(sub, kh, gs, w) == _smem_bytes(
                    sub, kh, gs, w, 2, _prefill_teams(w))


@pytest.mark.parametrize("page,dh,kh,gs,sub", [
    (128, 128, 8, 1, 128), (128, 128, 8, 16, 64), (128, 64, 8, 8, 128),
    (256, 128, 8, 16, 64), (128, 256, 8, 32, 32), (96, 128, 16, 16, 48)])
def test_sub_page_fits_the_scales_of_every_head(page, dh, kh, gs, sub):
    """Many kv heads with small scale groups (jamba-v0.1's Kh = 8 at
    Dh = 128 with group 8: 16 scales a slot) stage more scale bytes than
    a 128-slot sub-page leaves room for: the page walks as the largest
    divisor whose prefill block fits."""
    got = fd.sub_page(page, dh, kh, gs)
    assert got == sub and page % got == 0
    w = fd.kernel_width(dh)
    assert fd.prefill_smem_bytes(got, kh, gs, w) <= fd.SMEM_LIMIT
    cap = fd.MAX_SUB if w <= 128 else fd.MAX_SUB_WIDE
    assert not any(page % d == 0 and fd.prefill_smem_bytes(d, kh, gs, w)
                   <= fd.SMEM_LIMIT for d in range(got + 1, cap + 1))


@pytest.mark.parametrize("dh,width", [(1, 32), (32, 32), (40, 64), (48, 64),
                                      (64, 64), (112, 128), (128, 128),
                                      (129, 256), (256, 256)])
def test_kernel_width(dh, width):
    assert fd.kernel_width(dh) == width


# ---------------------------------------------------------------------------
# the wide route: heads of more than 256 columns
# ---------------------------------------------------------------------------

def test_wide_route_and_limit_match_the_cuda_source():
    """Above 256 columns both entry points take the wide route; its limit
    is the Python one, and q and O of that many columns fit the default
    48 KB of shared memory (``wide_smem_bytes``, term for term)."""
    assert _const(FLASH, "WIDE_MAX_DH") == fd.WIDE_MAX_DH >= 1024
    slots = 2 * _const(FLASH, "WIDE_THREADS") // 32
    assert "WIDE_SLOTS = 2 * WIDE_WARPS;" in FLASH
    assert (256 + 2 * fd.WIDE_MAX_DH + slots) * 4 <= 48 * 1024
    assert "return (256 + 2 * Dh + WIDE_SLOTS) * 4;" in FLASH
    assert FLASH.count("if (Dh > 256)\n    return launch_wide(") == 2
    assert "Dh > 256 || page <= max_sub(width_of(Dh))" in FLASH


@pytest.mark.parametrize("dh,wide", [(1, False), (64, False), (256, False),
                                     (257, True), (300, True), (512, True),
                                     (4096, True)])
def test_route_choice(dh, wide):
    assert fd.wide_route(dh) == wide
    if wide:   # the wide route walks slots: no sub-pages
        assert fd.sub_page(256, dh) == 256 and fd.sub_page(131, dh) == 131
    fd._check_kernel_shape("decode", dh, 128)


def test_wide_route_limit_is_stated():
    with pytest.raises(ValueError, match=f"Dh in 1..{fd.WIDE_MAX_DH}"):
        fd._check_kernel_shape("paged_flash_prefill", fd.WIDE_MAX_DH + 1, 128)


def _wide_pool(rng, n, page, kh, dh, group):
    """A random quantized pool as (jax operands, torch operands)."""
    jpool, tpool = [], []
    for s in (3.0, 1.0):
        x = (rng.normal(size=(n, page, kh, dh)) * s).astype(np.float32)
        jc, js = jA.quantize_kv(jnp.asarray(x), group)
        jpool += [jc, js]
        tpool += list(tA.quantize_kv(torch.from_numpy(x), group))
    return jpool, tpool


@pytest.mark.parametrize("case,group", [("decode", None), ("decode", 32),
                                        ("prefill", None), ("prefill", 32)])
def test_wide_head_plain_matches_reference_blocked_loops(case, group):
    """Dh 320 (the wide route on the card): the plain versions against the
    reference's blocked XLA loops, which its engines run by default."""
    b, page, npp, kh, g, dh = 2, 16, 3, 2, 2, 320
    rng = np.random.default_rng(11)
    jpool, tpool = _wide_pool(rng, b * npp + 1, page, kh, dh, group)
    pt = rng.permutation(np.arange(1, b * npp + 1)).reshape(b, npp) \
        .astype(np.int32)
    jcache = dict(zip(("k_codes", "k_scale", "v_codes", "v_scale"), jpool))
    if case == "decode":
        q = rng.normal(size=(b, kh, g, dh)).astype(np.float32)
        pos = np.asarray([20, 47], np.int32)
        want = jA.paged_decode_blocked(jnp.asarray(q), jcache,
                                       jnp.asarray(pt), jnp.asarray(pos),
                                       30.0)
        got = fd.paged_flash_decode(torch.from_numpy(q), *tpool,
                                    torch.from_numpy(pt),
                                    torch.from_numpy(pos), 30.0)
    else:
        q = rng.normal(size=(b, 16, kh, g, dh)).astype(np.float32)
        pos = np.asarray([0, 16], np.int32)
        want = jA.paged_prefill_blocked(jnp.asarray(q), jcache,
                                        jnp.asarray(pt), jnp.asarray(pos),
                                        30.0)
        got = fd.paged_flash_prefill(torch.from_numpy(q), *tpool,
                                     torch.from_numpy(pt),
                                     torch.from_numpy(pos), 30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# continuous serving at page 256
# ---------------------------------------------------------------------------

PAGE256 = dict(max_batch=4, max_len=512, prefill_chunk_tokens=256,
               prefill_context="pages")


def _page256_traffic():
    """Four requests from numpy seed 16, two of them longer than a
    256-slot page."""
    rng = np.random.default_rng(16)
    return [(rng.integers(0, JCFG.vocab, n).astype(np.int32), new)
            for n, new in ((300, 8), (40, 12), (200, 6), (270, 10))]


@pytest.fixture(scope="module")
def f32_params():
    jp = jT.lm_init(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax_to_numpy(jp), device="cpu")


def _serve(engine_cls, params, page, n_pages, **extra):
    eng = engine_cls(_f32(JCFG if engine_cls is JaxContinuous else TCFG),
                     params, n_pages=n_pages, page_size=page,
                     **{**PAGE256, **extra})
    reqs = _page256_traffic()
    rids = [eng.submit(p, n) for p, n in reqs]
    out = eng.run()
    return [np.asarray(out[r]) for r in rids], eng


def test_continuous_page_256_equals_jax_and_page_128(f32_params):
    """float32 pages context (the port's pages-context tests run in
    float32: bf16 near-ties split port vs JAX); pools of the same bytes,
    large enough that nothing is preempted."""
    want, _ = _serve(JaxContinuous, f32_params[0], 256, 9)
    got, eng = _serve(ContinuousEngine, f32_params[1], 256, 9,
                      device="cpu")
    small, eng128 = _serve(ContinuousEngine, f32_params[1], 128, 18,
                           device="cpu")
    assert eng.page_size == 256 and eng128.page_size == 128
    assert eng.scheduler.preemption_count == 0
    assert eng128.scheduler.preemption_count == 0
    for g, w, s in zip(got, want, small):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)


def test_continuous_cli_takes_the_chunk_as_its_page(monkeypatch, capsys):
    """``--prefill-chunk 256`` without ``--page-size`` serves on 256-slot
    pages (the reference CLI's choice) and runs to its end."""
    from repro_torch.launch import serve
    built = []
    real = serve.ContinuousEngine

    def spy(*args, **kw):
        eng = real(*args, **kw)
        built.append(eng)
        return eng

    monkeypatch.setattr(serve, "ContinuousEngine", spy)
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--reduced", "--continuous", "--batch",
        "2", "--prompt-len", "12", "--steps", "4", "--n-pages", "6",
        "--prefill-chunk", "256"])
    serve.main()
    assert "served 4 requests" in capsys.readouterr().out
    assert [e.page_size for e in built] == [256]


# ---------------------------------------------------------------------------
# static generate at head_dim 256 and 112
# ---------------------------------------------------------------------------

PROMPT = np.random.default_rng(7).integers(0, JCFG.vocab, (2, 12)) \
    .astype(np.int32)


@pytest.mark.parametrize("head_dim", [256, 112])
def test_generate_at_head_dim_equals_jax(head_dim):
    jcfg = dataclasses.replace(JCFG, head_dim=head_dim)
    tcfg = dataclasses.replace(TCFG, head_dim=head_dim)
    jparams = jT.lm_init(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_numpy(jax_to_numpy(jparams), device="cpu")
    want, _, _ = jzoo.apply_model(jparams, {"tokens": jnp.asarray(PROMPT)},
                                  _f32(jcfg), mode="prefill")
    got, _ = zoo.apply_model(
        tparams, {"tokens": torch.from_numpy(PROMPT).long()}, _f32(tcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    jeng = JaxEngine(jcfg, jparams, max_len=32, quantized_kv=True,
                     policy=JaxPolicy.paper_mixed())
    teng = ServeEngine(tcfg, tparams, max_len=32, quantized_kv=True,
                       policy=PrecisionPolicy.paper_mixed(), device="cpu")
    np.testing.assert_array_equal(teng.generate(PROMPT, 8),
                                  np.asarray(jeng.generate(
                                      jnp.asarray(PROMPT), 8)))


# ---------------------------------------------------------------------------
# engine-plane launch plans
# ---------------------------------------------------------------------------

DEQUANT = _source("dequant.cu")
QUIRE = _source("quire_dot.cu")


def _routes(src):
    enum = re.search(r"enum Route \{([^}]*)\}", src).group(1)
    return {m.group(1).lower(): int(m.group(2))
            for m in re.finditer(r"ROUTE_(\w+) = (\d+)", enum)}


def test_dequant_plan_constants_match_the_cuda_source():
    assert _routes(DEQUANT) == kcodec.ROUTES
    assert _const(DEQUANT, "STRIP_WARPS") == kcodec.STRIP_WARPS
    assert _const(DEQUANT, "STRIP_VECS") == kcodec.STRIP_VECS
    assert _const(DEQUANT, "WORD_THREADS") == kcodec.WORD_THREADS
    assert "STRIP_THREADS = 32 * STRIP_WARPS" in DEQUANT


@pytest.mark.parametrize("k,n,np_,bits,aligned,route,grid", [
    # the bench's posit8 1024 x 1024: 64 vectors a row, 2 strips
    (1024, 1024, 1024, 8, True, "strip", (2, 128)),
    # qwen2-0.5b's FP4 FFN slice: 152 vectors, 5 strips of 106 bands
    (896, 4864, 4864, 4, True, "strip", (5, 106)),
    (4864, 896, 896, 4, True, "strip", (1, 528)),
    (1024, 1024, 1024, 16, True, "strip", (4, 128)),
    (8, 290, 296, 8, True, "word", (3, 1)),         # 74 words: not x4
    (1024, 1024, 1024, 8, False, "word", (1024, 1)),
    (3, 20, 32, 4, True, "strip", (1, 1)),
])
def test_dequant_plan(k, n, np_, bits, aligned, route, grid):
    plan = kcodec.dequant_plan(k, n, np_, bits, aligned, sms=132)
    assert (plan.route, plan.grid) == (route, grid)
    if route == "strip":
        per = 32 // bits
        vecs = math.ceil(n / (4 * per))
        assert (plan.grid[0] - 1) * kcodec.STRIP_VECS < vecs \
            <= plan.grid[0] * kcodec.STRIP_VECS
        assert plan.grid[1] <= math.ceil(k / kcodec.STRIP_WARPS)
        assert plan.threads == 32 * kcodec.STRIP_WARPS


def test_quire_route_constants_match_the_cuda_source():
    assert _routes(QUIRE) == kquire.ROUTES
    assert _const(QUIRE, "ROW_THREADS") == _const(QUIRE, "SCALAR_THREADS")
    # a row's int32 partial of 4 * ROW_UNROLL products stays exact
    assert 4 * _const(QUIRE, "ROW_UNROLL") * 2 ** 24 < 2 ** 31


@pytest.mark.parametrize("k,aligned,route", [
    (1024, True, "row"),          # the bench's row
    (4096, True, "row"),
    (4100, True, "row"),
    (514, True, "scalar"),        # K % 4 != 0: rows not whole int4s
    (1024, False, "scalar"),
])
def test_quire_route(k, aligned, route):
    assert kquire.quire_route(k, aligned) == route
