"""Paged posit8 KV plane of the PyTorch port against the JAX package:
the paged decode and chunk-prefill attention (the kernel wrappers' plain
versions on the CPU) against the Pallas kernels in interpret mode, the
naive oracles and the reference's blocked XLA loops; the reference's
bitwise invariants inside the port; and the pool's bookkeeping and byte
models against ``repro.serve.paged_kv``."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.flash_decode import (paged_flash_decode_pallas,
                                        paged_flash_prefill_pallas)
from repro.models import attention as jA
from repro.serve import paged_kv as jpk
from repro_torch.configs import get_config
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_decode import (_check_kernel_shape,
                                              default_kv_block,
                                              flash_decode_plain,
                                              paged_flash_decode,
                                              paged_flash_decode_plain,
                                              paged_flash_prefill,
                                              paged_flash_prefill_plain)
from repro_torch.models import attention as tA
from repro_torch.serve import paged_kv as tpk

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import one_torch_thread  # noqa: E402,F401

# as tests/test_paged_kv.py: f32 online softmax in another order
RTOL = ATOL = 1e-5

JCFG = jax_get_config("qwen2-0.5b").reduced()
TCFG = get_config("qwen2-0.5b").reduced()
B, PAGE, NPP, KH, G, DH = 3, 16, 4, 2, 2, 32


def _setup(seed, group=None):
    """A random quantized pool (page 0 parking) with disjoint page-table
    rows, as (jax operands, torch operands)."""
    rng = np.random.default_rng(seed)
    n = B * NPP + 1
    kv = [(rng.normal(size=(n, PAGE, KH, DH)) * s).astype(np.float32)
          for s in (3.0, 1.0)]
    jpool, tpool = [], []
    for x in kv:
        jc, js = jA.quantize_kv(jnp.asarray(x), group)
        jpool += [np.asarray(jc), np.asarray(js)]
        tpool += list(tA.quantize_kv(torch.from_numpy(x), group))
    pt = rng.permutation(np.arange(1, n))[: B * NPP].reshape(B, NPP) \
        .astype(np.int32)
    return (jpool, jnp.asarray(pt)), (tpool, torch.from_numpy(pt))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("positions,softcap,group", [
    ([0, 17, 63], 0.0, None), ([63, 1, 40], 20.0, 8)])
def test_paged_decode_vs_pallas_interpret_and_oracle(positions, softcap,
                                                     group):
    (jpool, jpt), (tpool, tpt) = _setup(1, group)
    q = np.random.default_rng(2).normal(size=(B, KH, G, DH)) \
        .astype(np.float32)
    pos = np.asarray(positions, np.int32)
    got = paged_flash_decode(torch.from_numpy(q), *tpool, tpt,
                             torch.from_numpy(pos), softcap).numpy()
    kernel = paged_flash_decode_pallas(jnp.asarray(q), *jpool, jpt,
                                       jnp.asarray(pos), softcap=softcap,
                                       interpret=True)
    oracle = jref.paged_flash_decode_ref(jnp.asarray(q), *jpool, jpt,
                                         jnp.asarray(pos), softcap)
    np.testing.assert_allclose(got, _np(kernel), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _np(oracle), rtol=RTOL, atol=ATOL)
    naive = tref.paged_flash_decode_ref(torch.from_numpy(q), *tpool, tpt,
                                        torch.from_numpy(pos), softcap)
    np.testing.assert_allclose(naive.numpy(), _np(oracle), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("start,softcap,group", [
    ([0, 16, 32], 0.0, None), ([32, 0, 48], 20.0, 8)])
def test_paged_prefill_vs_pallas_interpret_and_oracle(start, softcap, group):
    (jpool, jpt), (tpool, tpt) = _setup(3, group)
    c = 16
    q = np.random.default_rng(4).normal(size=(B, c, KH, G, DH)) \
        .astype(np.float32)
    st = np.asarray(start, np.int32)
    got = paged_flash_prefill(torch.from_numpy(q), *tpool, tpt,
                              torch.from_numpy(st), softcap).numpy()
    kernel = paged_flash_prefill_pallas(jnp.asarray(q), *jpool, jpt,
                                        jnp.asarray(st), softcap=softcap,
                                        interpret=True)
    oracle = jref.paged_prefill_ref(jnp.asarray(q), *jpool, jpt,
                                    jnp.asarray(st), softcap)
    np.testing.assert_allclose(got, _np(kernel), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _np(oracle), rtol=RTOL, atol=ATOL)
    naive = tref.paged_prefill_ref(torch.from_numpy(q), *tpool, tpt,
                                   torch.from_numpy(st), softcap)
    np.testing.assert_allclose(naive.numpy(), _np(oracle), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["decode", "prefill"])
def test_plain_matches_reference_blocked_loops(case):
    """The plain versions against the reference's XLA loops
    (``paged_decode_blocked`` / ``paged_prefill_blocked``), which the JAX
    engine runs by default; the wrapper on a CPU tensor counts no
    launch and returns the plain version's result."""
    (jpool, jpt), (tpool, tpt) = _setup(5, None)
    rng = np.random.default_rng(6)
    jcache = dict(zip(("k_codes", "k_scale", "v_codes", "v_scale"),
                      map(jnp.asarray, jpool)))
    if case == "decode":
        q = rng.normal(size=(B, KH, G, DH)).astype(np.float32)
        pos = np.asarray([9, 63, 30], np.int32)
        want = jA.paged_decode_blocked(jnp.asarray(q), jcache, jpt,
                                       jnp.asarray(pos), 30.0)
        fn, plain = paged_flash_decode, paged_flash_decode_plain
    else:
        q = rng.normal(size=(B, 32, KH, G, DH)).astype(np.float32)
        pos = np.asarray([0, 32, 16], np.int32)
        want = jA.paged_prefill_blocked(jnp.asarray(q), jcache, jpt,
                                        jnp.asarray(pos), 30.0)
        fn, plain = paged_flash_prefill, paged_flash_prefill_plain
    args = (torch.from_numpy(pos), 30.0)
    got = plain(torch.from_numpy(q), *tpool, tpt, *args)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    before = fn.launches
    assert torch.equal(fn(torch.from_numpy(q), *tpool, tpt, *args), got)
    assert fn.launches == before


def test_paged_plain_equals_contiguous_plain_bitwise():
    """A contiguous cache scattered into shuffled pages decodes BITWISE
    like the contiguous blocked decode when page == blk (one block
    partition, one accumulation order)."""
    rng = np.random.default_rng(7)
    t = PAGE * NPP
    kc, ks = tA.quantize_kv(torch.from_numpy(
        rng.normal(size=(B, t, KH, DH)).astype(np.float32)))
    vc, vs = tA.quantize_kv(torch.from_numpy(
        rng.normal(size=(B, t, KH, DH)).astype(np.float32)))
    pt = torch.from_numpy(rng.permutation(np.arange(1, B * NPP + 1))
                          .reshape(B, NPP).astype(np.int32))
    pool = []
    for x in (kc, ks, vc, vs):
        buf = torch.zeros((B * NPP + 1, PAGE) + x.shape[2:], dtype=x.dtype)
        buf[pt.reshape(-1).long()] = x.reshape(B * NPP, PAGE, *x.shape[2:])
        pool.append(buf)
    q = torch.from_numpy(rng.normal(size=(B, KH, G, DH)).astype(np.float32))
    for p in (0, 15, 16, 40, 63):
        paged = paged_flash_decode_plain(
            q, *pool, pt, torch.full((B,), p, dtype=torch.int32), 20.0)
        contig = flash_decode_plain(q, kc, ks, vc, vs, p, softcap=20.0,
                                    blk=PAGE)
        assert torch.equal(paged, contig), p
    # ragged positions: each row equals its own contiguous decode
    pos = torch.tensor([3, 63, 33], dtype=torch.int32)
    paged = paged_flash_decode_plain(q, *pool, pt, pos)
    for i, p in enumerate(pos.tolist()):
        one = flash_decode_plain(q[i:i + 1], kc[i:i + 1], ks[i:i + 1],
                                 vc[i:i + 1], vs[i:i + 1], p, blk=PAGE)
        assert torch.equal(paged[i:i + 1], one)


def test_prefill_chunk_of_one_equals_decode_bitwise():
    """A C=1 prefill chunk at position p is the decode computation of a
    query at p (the rows go through the same block step)."""
    _, (tpool, tpt) = _setup(8, 8)
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.normal(size=(B, KH, G, DH)).astype(np.float32))
    pos = torch.tensor([5, 33, 60], dtype=torch.int32)
    chunk = paged_flash_prefill_plain(q[:, None], *tpool, tpt, pos, 20.0)
    dec = paged_flash_decode_plain(q, *tpool, tpt, pos, 20.0)
    assert torch.equal(chunk[:, 0], dec)


def test_paged_wrappers_reject_bad_shapes():
    _, (tpool, tpt) = _setup(10)
    q = torch.zeros(B, KH, G, DH)
    pos = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_flash_decode(q, tpool[0], tpool[1], tpool[2][:, :, :1],
                           tpool[3], tpt, pos)
    with pytest.raises(ValueError):
        paged_flash_decode(q, *tpool, tpt[:2], pos)
    with pytest.raises(ValueError):
        paged_flash_prefill(q[:, None], *tpool, tpt, pos[:2])


@pytest.mark.parametrize("dh,page,ok", [
    (32, 8, True), (64, 128, True), (128, 40, True), (64, 24, True),
    (64, 12, True), (64, 1, True), (64, 2, True), (32, 4, True),
    (128, 127, True), (48, 16, True), (64, 136, True), (64, 0, False),
    (256, 128, True), (112, 128, True), (64, 256, True), (64, 131, True),
    (40, 8, True), (264, 8, True), (4096, 300, True), (4097, 8, False),
    (0, 8, False)])
def test_kernel_shape_guard(dh, page, ok):
    """What the CUDA kernels take (Dh in 1..4096: above 256 on the wide
    route; a page of any size: one of more than a sub-page's slots walks
    as sub-pages) is checked in Python before a launch."""
    if ok:
        _check_kernel_shape("decode", dh, page)
    else:
        with pytest.raises(ValueError, match="Dh in"):
            _check_kernel_shape("decode", dh, page)


@pytest.mark.parametrize("max_len", [256, 100, 66, 7, 1024])
def test_kernel_shape_guard_takes_every_default_kv_block(max_len):
    """The static engine's block is ``default_kv_block(max_len)``: the
    kernels take it whatever ``max_len`` is (100 gives 4, 66 gives 2)."""
    _check_kernel_shape("decode", 64, default_kv_block(max_len))


# ---------------------------------------------------------------------------
# pool bookkeeping and byte models
# ---------------------------------------------------------------------------

def _pools(n_pages=16, page=8, group=None):
    return (jpk.PagedKVPool(JCFG, n_pages, page, group),
            tpk.PagedKVPool(TCFG, n_pages, page, group, device="cpu"))


def test_pool_layout_matches_reference():
    jpool, tpool = _pools(group=8)
    for key in tpk.POOL_KEYS:
        want = np.asarray(getattr(jpool, key))
        got = getattr(tpool, key)
        assert tuple(got.shape) == want.shape, key
        assert str(got.dtype).split(".")[-1] == str(want.dtype), key
        assert float(got.float().abs().max()) == float(np.abs(want).max())
    assert tpk.PARKING_PAGE == jpk.PARKING_PAGE == 0
    with pytest.raises(ValueError, match="no page-kind mapping"):
        tpk.PagedKVPool(dataclasses.replace(TCFG, family="audio"), 4, 8,
                        device="cpu")


def test_pool_refcount_churn_matches_reference():
    """The same alloc / incref / decref sequence on both pools hands out
    the same pages and keeps the same refcounts, peak and free list."""
    jpool, tpool = _pools(n_pages=24)
    rng = np.random.default_rng(11)
    ref = {}
    for _ in range(300):
        r = rng.random()
        live = sorted(ref)
        if live and r < 0.3:
            pg = live[rng.integers(0, len(live))]
            for p in (jpool, tpool):
                p.incref([pg])
            ref[pg] += 1
        elif live and r < 0.65:
            pg = live[rng.integers(0, len(live))]
            for p in (jpool, tpool):
                p.free([pg])
            ref[pg] -= 1
            if ref[pg] == 0:
                del ref[pg]
        else:
            n = int(rng.integers(1, 5))
            got = tpool.alloc(n)
            assert got == jpool.alloc(n)
            for pg in got or []:
                ref[pg] = 1
        assert tpool._free == jpool._free
        assert tpool.alloc_peak == jpool.alloc_peak
        assert all(tpool.refcount(pg) == jpool.refcount(pg) == n
                   for pg, n in ref.items())
        assert (tpool.free_pages, tpool.used_pages, tpool.utilization) == \
            (jpool.free_pages, jpool.used_pages, jpool.utilization)
    (pg,) = tpool.alloc(1)
    tpool.free([pg])
    with pytest.raises(AssertionError):
        tpool.free([pg])                         # double free is a bug
    with pytest.raises(AssertionError):
        tpool.incref([pg])


def test_write_chunk_matches_write_prefill_and_reference():
    """Chunk-by-chunk writes equal one whole-prefix write, a padded final
    chunk drops its pad pages, and the pool tensors equal the reference
    pool's after the same writes."""
    rng = np.random.default_rng(12)
    L, kh, dh = TCFG.n_layers, TCFG.n_kv_heads, TCFG.resolved_head_dim
    cache = {}
    for key in tpk.POOL_KEYS:
        cols = 1 if key.endswith("scale") else dh
        x = rng.integers(0, 255, (L, 1, 32, kh, cols))
        cache[key] = x.astype(np.uint8) if cols == dh \
            else (2.0 ** (x % 7 - 3)).astype(np.float32)
    tq = {k: torch.from_numpy(v) if v.dtype == np.uint8
          else torch.from_numpy(v).to(torch.bfloat16)
          for k, v in cache.items()}
    jq = {k: jnp.asarray(v, jnp.uint8 if v.dtype == np.uint8
                         else jnp.bfloat16) for k, v in cache.items()}
    jpool, tpool = _pools()
    whole, chunked = tpool, tpk.PagedKVPool(TCFG, 16, 8, device="cpu")
    pages = whole.alloc(4)
    assert chunked.alloc(4) == pages == jpool.alloc(4)
    whole.write_prefill(tq, pages)
    jpool.write_prefill(jq, pages)
    for start in (0, 16):
        chunked.write_chunk({k: v[:, :, start:start + 16]
                             for k, v in tq.items()}, pages, start)
    for key in tpk.POOL_KEYS:
        assert torch.equal(getattr(whole, key), getattr(chunked, key))
        got = getattr(whole, key)
        want = np.asarray(getattr(jpool, key))
        if key.endswith("scale"):
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want)
    back = whole.gather_request(pages)
    for key in tpk.POOL_KEYS:
        assert torch.equal(back[key], tq[key])
    # a final chunk padded past the allocation writes only owned pages
    pad_pool = tpk.PagedKVPool(TCFG, 16, 8, device="cpu")
    own = pad_pool.alloc(3)
    before = pad_pool.k_codes.clone()
    pad_pool.write_chunk(tq, own, 8)             # 4 page blocks, 2 owned
    assert torch.equal(pad_pool.k_codes[:, own[1:]],
                       tq["k_codes"][:, 0, :16].reshape(L, 2, 8, kh, dh))
    untouched = [p for p in range(17) if p not in own[1:]]
    assert torch.equal(pad_pool.k_codes[:, untouched], before[:, untouched])


@pytest.mark.parametrize("group", [None, 8, 32])
def test_byte_models_equal_reference(group):
    for jc, tc in ((JCFG, TCFG), (jax_get_config("qwen2-0.5b"),
                                  get_config("qwen2-0.5b"))):
        for page in (16, 128):
            assert tpk.page_handoff_bytes(tc, page, group) == \
                jpk.page_handoff_bytes(jc, page, group)
            for positions in ([0], [15, 16, 200], [1023] * 8):
                assert tpk.paged_kv_bytes_per_step(tc, positions, page,
                                                   group) == \
                    jpk.paged_kv_bytes_per_step(jc, positions, page, group)
    # the full-width pool of the chip smoke run: 811,008 B a page
    assert tpk.page_handoff_bytes(get_config("qwen2-0.5b"), 128) == 811008


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def test_paged_kernels_vs_plain_on_card(cuda):
    (_, _), (tpool, tpt) = _setup(13, 8)
    tpool = [x.to(cuda) for x in tpool]
    tpt = tpt.to(cuda)
    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.normal(size=(B, KH, G, DH)).astype(np.float32))
    pos = torch.tensor([0, 40, 63], dtype=torch.int32, device=cuda)
    before = paged_flash_decode.launches
    got = paged_flash_decode(q.to(cuda), *tpool, tpt, pos, 20.0)
    assert paged_flash_decode.launches == before + 1
    want = paged_flash_decode_plain(q.to(cuda), *tpool, tpt, pos, 20.0)
    assert (got - want).abs().max().item() <= 1e-4
    one = paged_flash_prefill(q[:, None].to(cuda), *tpool, tpt, pos, 20.0)
    assert torch.equal(one[:, 0], got)
