"""The RMMEC wrapper's launch plan, checked without a card: which route
each (x dtype, format width, M) takes, chunk boundaries that depend on K
alone, the grids and split-K scratch of qwen2-0.5b's four projection
shapes, the split-K counters shared per device, the streaming route's
strips and its decode tables (every code rebuilt with the kernel's
integer formula), and the plan's constants against
``csrc/rmmec_matmul.cu``."""

import inspect
import os
import re
import sys

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rmmec_matmul as rm

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import one_torch_thread  # noqa: E402,F401

QWEN2_SHAPES = {"q/o": (896, 896), "k/v": (896, 128),
                "gate/up": (896, 4864), "down": (4864, 896)}


@pytest.mark.parametrize("xdtype,bits,m,route", [
    (torch.bfloat16, 8, 1, "split_k"), (torch.bfloat16, 4, 16, "split_k"),
    (torch.bfloat16, 8, 17, "tile64"), (torch.bfloat16, 4, 256, "tile64"),
    (torch.bfloat16, 8, 1024, "tile64"), (torch.float32, 8, 8, "stream"),
    (torch.float32, 4, 1024, "simt"), (torch.bfloat16, 16, 8, "stream"),
    (torch.bfloat16, 16, 1024, "simt")])
def test_route_per_dtype_bits_and_m(xdtype, bits, m, route):
    """The tensor routes take bf16 x with formats of <= 8 bits (the
    reference's bf16 route); f32 x and posit16 take the f32 FMA routes,
    the streaming kernel at M <= 16 and the SIMT kernel above."""
    assert rm.launch_plan(m, 896, 896, xdtype, bits).route == route


def test_tile128_only_where_it_fills_half_the_card():
    assert rm.launch_plan(1024, 896, 4864, torch.bfloat16, 4).route \
        == "tile128"                                   # 8 x 38 = 304 tiles
    assert rm.launch_plan(1024, 896, 896, torch.bfloat16, 8).route \
        == "tile64"                                    # 8 x 7 = 56 < 66
    assert rm.launch_plan(256, 896, 4864, torch.bfloat16, 4).route \
        == "tile128"                                   # 2 x 38 = 76 >= 66
    assert rm.launch_plan(1024, 4864, 896, torch.bfloat16, 4).route \
        == "tile64"                                    # 8 x 7 = 56 < 66
    assert rm.launch_plan(1024, 896, 4864, torch.bfloat16, 4,
                          sms=800).route == "tile64"


@pytest.mark.parametrize("k", [1, 16, 127, 128, 129, 896, 1100, 4864])
def test_chunk_bounds_depend_on_k_only(k):
    bounds = rm.chunk_bounds(k)
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(b[0] == a[1] for a, b in zip(bounds, bounds[1:]))
    assert all(0 < k1 - k0 <= rm.KC and k0 % rm.KC == 0 for k0, k1 in bounds)
    for bits in (4, 8):
        plans = [rm.launch_plan(m, k, 300, torch.bfloat16, bits, sms)
                 for m in (1, 3, 8, 16, 17, 64, 256, 1024)
                 for sms in (132, 16)]
        assert {p.route for p in plans} >= {"split_k", "tile64", "tile128"}
        assert all(p.chunks == bounds for p in plans)


@pytest.mark.parametrize("name", list(QWEN2_SHAPES))
@pytest.mark.parametrize("bits", [4, 8])
def test_qwen2_split_k_grid_and_scratch_at_m8(name, bits):
    """At decode (M=8) every projection of qwen2-0.5b is one split-K launch
    of a block per (64-column N-tile, 128-row chunk)."""
    k, n = QWEN2_SHAPES[name]
    want_grid = {"q/o": (14, 7), "k/v": (2, 7), "gate/up": (76, 7),
                 "down": (14, 38)}[name]
    plan = rm.launch_plan(8, k, n, torch.bfloat16, bits)
    assert plan.route == "split_k" and plan.grid == want_grid
    assert plan.threads == 128
    assert plan.counters == want_grid[0]
    assert plan.scratch_bytes == 4 * want_grid[1] * 8 * want_grid[0] * 64
    assert rm.launch_plan(8, 896, 4864, torch.bfloat16, 4).scratch_bytes \
        == 1_089_536
    assert rm.launch_plan(8, 100, 300, torch.bfloat16, 8).counters == 0


def test_prefill_grids():
    p = rm.launch_plan(1024, 896, 4864, torch.bfloat16, 4)
    assert (p.grid, p.threads, p.scratch_floats) == ((38, 8), 256, 0)
    p = rm.launch_plan(1024, 4864, 896, torch.bfloat16, 4)
    assert (p.grid, p.threads, len(p.chunks)) == ((14, 16), 256, 38)
    p = rm.launch_plan(8, 896, 896, torch.float32, 8)
    assert (p.route, p.grid, p.chunks, p.strip) == ("stream", (56, 1), (), 16)
    p = rm.launch_plan(17, 896, 896, torch.float32, 8)
    assert (p.route, p.grid, p.chunks, p.strip) == ("simt", (14, 1), (), 0)


def test_counters_shared_per_device(monkeypatch):
    """One counter array per device, allocated zeroed at its first use and
    handed to every later call unchanged (the folding blocks reset their
    own), so a call never allocates or clears counters."""
    monkeypatch.setattr(rm, "_COUNTERS", {})
    dev = torch.device("cpu")
    first = rm._counters(dev)
    assert first.dtype == torch.int32 and first.numel() == rm.COUNTER_SLOTS
    assert int(first.abs().sum()) == 0
    for k, n in QWEN2_SHAPES.values():
        plan = rm.launch_plan(8, k, n, torch.bfloat16, 4)
        assert plan.counters <= rm.COUNTER_SLOTS
        assert rm._counters(dev) is first
    assert first.data_ptr() == rm._counters(dev).data_ptr()
    assert list(rm._COUNTERS) == [dev]


def test_plan_constants_match_the_cuda_source():
    with open(os.path.join(_build.CSRC_DIR, "rmmec_matmul.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("KC") == rm.KC
    assert const("SPLIT_M") == rm.SPLIT_K_MAX_M
    assert const("SPLIT_BN") == rm.SPLIT_BN
    assert const("SPLIT_THREADS") == rm.SPLIT_THREADS
    assert const("SIMT_BN") == rm.SIMT_BN
    for name in ("STREAM_THREADS", "WARP_COLS", "WIDE_THREADS",
                 "NARROW_MAX_BN"):
        assert const(name) == getattr(rm, name), name
    assert "(strip & (strip - 1))" in src and "strip < 128 / bits" in src
    assert re.search(r"constexpr int WIDE_BN = WIDE_THREADS / 32 \* "
                     r"WARP_COLS;", src)
    assert rm.WIDE_BN == rm.WIDE_THREADS // 32 * rm.WARP_COLS
    # the streaming route takes M <= SPLIT_M, the SIMT kernel the rest in
    # 64-row tiles
    assert "M > SPLIT_M" in src[src.index("route == ROUTE_STREAM"):]
    assert re.search(r"simt_kernel<F, TX, (\d+), ", src).group(1) \
        == str(rm.SIMT_ROWS)
    assert len(re.findall(r"simt_kernel<F, TX, \d+, ", src)) == 1
    assert const("KC") % 64 == 0          # group 32 and 64 scales in a chunk
    enum = re.search(r"enum Route \{([^}]*)\}", src).group(1)
    routes = {m.group(1).lower(): int(m.group(2)) for m in
              re.finditer(r"ROUTE_(\w+) = (\d+)", enum)}
    assert routes == rm.ROUTES
    for route in ("tile64", "tile128"):
        bm, bn, threads = rm.TILES[route]
        tile = re.search(rf"using {route.capitalize()} = "
                         rf"Tile<(\d+), (\d+), (\d+), (\d+)>;", src)
        wm, wn = int(tile.group(3)), int(tile.group(4))
        assert (int(tile.group(1)), int(tile.group(2)), 32 * wm * wn) \
            == (bm, bn, threads)
        assert f"ROUTE_{route.upper()}" in src


@pytest.mark.parametrize("name", ["fp4", "posit4_1", "fxp4", "posit8_0",
                                  "fp8_e4m3", "fp8_e5m2", "fxp8"])
def test_decode_table_holds_every_code_as_bf16(name):
    """The tensor route's table: each code's value exactly, as bf16 bits
    (4-bit formats: a byte's two codes, the low nibble in the low half)."""
    from repro_torch.core import codec, formats
    spec = formats.FORMATS[name]
    table = rm.decode_table(spec, "cpu")
    assert table.shape == (256,) and table.dtype == torch.int32
    assert rm.decode_table(spec, "cpu") is table            # made once
    want = codec.decode(spec, torch.arange(1 << spec.bits))

    def value(half):
        return (half << 16).to(torch.int32).view(torch.float32)

    lo, hi = table & 0xFFFF, (table >> 16) & 0xFFFF
    if spec.bits == 8:
        assert torch.equal(value(lo), want) and not hi.any()
    else:
        i = torch.arange(256)
        assert torch.equal(value(lo), want[i & 15])
        assert torch.equal(value(hi), want[i >> 4])


READOUTS = {"command-r-plus-104b": (256000, rm.WIDE_BN),
            "qwen2-vl-7b": (152064, rm.WIDE_BN),
            "deepseek-67b": (102400, rm.WIDE_BN),
            "rwkv6 / jamba": (65536, rm.WIDE_BN), "musicgen-medium": (2048, 8)}


@pytest.mark.parametrize("name", list(READOUTS))
def test_stream_strip_of_the_readouts(name):
    """The grid follows N: the 65536-256000-column read-outs take warp
    strips of 32 columns, 8 to a block (256-1000 blocks on 132 SMs);
    musicgen's 2048 columns take block strips of one 16-byte piece of
    codes (256 blocks); every M of the route launches the same grid."""
    n, want = READOUTS[name]
    assert rm.stream_strip(n, 16) == want
    grid = -(-n // want)
    assert grid >= rm.H100_SMS if want == rm.WIDE_BN else grid >= 256
    for m in (1, 2, 4, 8, 16):
        p = rm.launch_plan(m, 4096, n, torch.bfloat16, 16)
        assert (p.route, p.grid, p.threads, p.strip) == \
            ("stream", (grid, 1), rm.STREAM_THREADS, want)
        assert (p.scratch_floats, p.counters, p.chunks) == (0, 0, ())
    assert rm.launch_plan(17, 4096, n, torch.bfloat16, 16).route == "simt"


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("n", [1, 8, 100, 300, 896, 4864, 33792, 65536,
                               10 ** 6])
def test_stream_strip_shape(bits, n):
    """A strip is ``WIDE_BN`` (warp strips) exactly where that gives a
    block per SM, else a power of two of whole 16-byte pieces of codes up
    to ``NARROW_MAX_BN`` (block strips); fewer SMs never narrow it, and
    the C entry point takes exactly these."""
    bn = rm.stream_strip(n, bits)
    assert (bn == rm.WIDE_BN) == (-(-n // rm.WIDE_BN) >= rm.H100_SMS)
    if bn != rm.WIDE_BN:
        assert 128 // bits <= bn <= rm.NARROW_MAX_BN and bn & (bn - 1) == 0
        assert bn == 128 // bits or -(-n // bn) >= rm.STREAM_NARROW \
            * rm.H100_SMS or bn == rm.NARROW_MAX_BN
    assert rm.stream_strip(n, bits, sms=16) >= bn


def _f32_bits(v):
    return v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("name", ["fp4", "posit4_1", "fxp4", "posit8_0",
                                  "fp8_e4m3", "fp8_e5m2", "fxp8",
                                  "posit16_1"])
def test_stream_table_rebuilds_every_code(name):
    """The streaming route's table, read as ``stream_kernel`` reads it:
    every code of the format rebuilt with the kernel's integer formula
    equals ``codec.decode`` bit for bit.  8 bits: the entry of the code;
    4 bits: byte b's entry holds codes b & 15 and b >> 4; posit16: the
    code's high byte picks (base, mul) and the value bits are (base + sx *
    mul) mod 2**32, sx the sign-extended code, for all 65536 codes but
    those whose entry holds mul 0 (zero, NaR, regime runs of 7 or more:
    1024 codes), which take the full decode."""
    from repro_torch.core import codec, formats
    spec = formats.FORMATS[name]
    table = rm.stream_table(spec, "cpu")
    assert table.dtype == torch.int32
    assert rm.stream_table(spec, "cpu") is table            # made once
    codes = torch.arange(1 << spec.bits)
    want = _f32_bits(codec.decode(spec, codes))
    t = table.to(torch.int64) & 0xFFFFFFFF
    if spec.bits == 8:
        assert table.shape == (256,)
        assert torch.equal(t[codes], want)
        return
    if spec.bits == 4:
        assert table.shape == (256, 2)
        b = torch.arange(256)
        assert torch.equal(t[b, 0], want[b & 15])
        assert torch.equal(t[b, 1], want[b >> 4])
        return
    assert table.shape == (256, 2)
    sx = torch.where(codes >= 1 << 15, codes - (1 << 16), codes)
    e = t[codes >> 8]
    full = e[:, 1] == 0
    u = (sx * e[:, 1] + e[:, 0]) & 0xFFFFFFFF
    assert torch.equal(torch.where(full, want, u), want)
    assert torch.equal(full, torch.isin(codes >> 8,
                                        torch.tensor([0, 127, 128, 255])))
    assert int(full.sum()) == 1024
    # the full decode takes |value| <= 2**-12 or >= 2**12 (zero, NaR) only
    mag = codec.decode(spec, codes).abs()
    assert bool(((mag <= 2.0 ** -12) | (mag >= 2.0 ** 12))[full].all())
    assert bool(((mag >= 2.0 ** -12) & (mag <= 2.0 ** 12))[~full].all())


def test_stream_route_counts_its_launches():
    """``stream_route`` names the calls the streaming kernel takes; the
    wrapper counts them beside ``rmmec_matmul.launches`` (on the card)."""
    assert rm.stream_route(16, torch.float32, 4)
    assert rm.stream_route(1, torch.bfloat16, 16)
    assert not rm.stream_route(17, torch.bfloat16, 16)
    assert not rm.stream_route(8, torch.bfloat16, 8)
    assert isinstance(rm.stream_route.launches, int)


def test_ablation_copies_patch_the_committed_source():
    """Every copy ``python -m repro_torch.benchmarks.rmmec_ablation``
    builds finds the text it replaces in ``csrc/rmmec_matmul.cu`` (a
    rename in the kernel would otherwise only fail on the card)."""
    from repro_torch.benchmarks import rmmec_ablation as ab
    sources = ab._sources()
    assert list(sources) == list(ab.VARIANTS)
    assert all(text != sources["committed"]
               for name, text in sources.items() if name != "committed")
    assert set(ab.STREAM_VARIANTS) | set(ab.TENSOR_VARIANTS) \
        | {"simt_8_rows"} == set(ab.VARIANTS)


def test_probe_is_built_by_the_ablation_only():
    """The wgmma-vs-mma.sync probe lives in the ablation's own source,
    which includes the committed .cu: the shipped library neither builds
    nor binds it, and the ablation binds its nine arguments."""
    from repro_torch.benchmarks import rmmec_ablation as ab
    with open(os.path.join(_build.CSRC_DIR, "rmmec_matmul.cu")) as f:
        shipped = f.read()
    assert "probe_kernel" not in shipped
    assert "rmmec_wgmma_probe" not in rm._ARGTYPES
    with open(ab.PROBE_CU) as f:
        probe = f.read()
    assert '#include "rmmec_matmul.cu"' in probe
    sig = re.search(r'extern "C" int rmmec_wgmma_probe\(([^)]*)\)', probe)
    assert len(sig.group(1).split(",")) \
        == len(ab.PROBE_ARGTYPES["rmmec_wgmma_probe"]) == 9


# ---------------------------------------------------------------------------
# the wgmma route (bf16 x, <= 8-bit codes, M > 16, operands TMA can address)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xdtype,bits,m,k,n,aligned,route", [
    (torch.bfloat16, 8, 1024, 896, 896, True, "wgmma"),
    (torch.bfloat16, 4, 1024, 896, 4864, True, "wgmma"),
    (torch.bfloat16, 4, 1024, 4864, 896, True, "wgmma"),
    (torch.bfloat16, 8, 4096, 896, 896, True, "tile128"),
    (torch.bfloat16, 8, 256, 12288, 12288, True, "wgmma"),
    (torch.bfloat16, 8, 1024, 896, 128, True, "tile64"),
    (torch.bfloat16, 8, 256, 896, 896, True, "tile64"),
    (torch.bfloat16, 4, 256, 896, 4864, True, "tile128"),
    (torch.bfloat16, 8, 1024, 2048, 2048, True, "tile128"),
    (torch.bfloat16, 4, 1024, 896, 4864, False, "tile128"),
    (torch.bfloat16, 8, 1024, 896, 896, False, "tile64"),
    (torch.bfloat16, 8, 16, 896, 896, True, "split_k"),
    (torch.bfloat16, 4, 1, 4864, 896, True, "split_k"),
    (torch.float32, 8, 1024, 896, 896, True, "simt"),
    (torch.float32, 4, 8, 896, 896, True, "stream"),
    (torch.bfloat16, 16, 1024, 896, 896, True, "simt"),
    (torch.bfloat16, 16, 8, 896, 896, True, "stream")])
def test_route_per_dtype_bits_m_and_alignment(xdtype, bits, m, k, n, aligned,
                                              route):
    """wgmma takes bf16 x with codes of <= 8 bits above 16 rows where TMA
    can address the operands and its grid ends first (wgmma_faster); the
    64- and 128-row tiles keep every other such call; M <= 16 and the f32
    routes do not look at alignment."""
    plan = rm.launch_plan(m, k, n, xdtype, bits, aligned=aligned)
    assert plan.route == route
    assert rm.wgmma_route(m, n, xdtype, bits, aligned) == \
        (route == "wgmma")


def _grid_costs(m, n, sms):
    """Each route's waves for an (m, n) output on ``sms`` SMs, counted
    block by block, times WAVE_COST: (wgmma, the tile route the plan takes
    otherwise, that route)."""
    def blocks(bm, bn):
        return len([(r, c) for r in range(0, m, bm) for c in range(0, n, bn)])

    def waves(count, per_sm):
        w = 0
        while count > 0:
            count -= per_sm * sms
            w += 1
        return w
    wgmma = waves(blocks(128, 64), 1)
    if 2 * blocks(128, 128) >= sms:
        return wgmma, rm.WAVE_COST["tile128"] * waves(blocks(128, 128), 1), \
            "tile128"
    t64 = blocks(64, 64)
    if t64 <= sms:     # one 64 x 64 block an SM: it ends before a wgmma tile
        return wgmma, None, "tile64"
    return wgmma, rm.WAVE_COST["tile64"] * waves(t64, 2), "tile64"


@pytest.mark.parametrize("sms", [132, 114, 78])
def test_wgmma_faster_compares_the_grids_waves(sms):
    """wgmma_faster is the wave count of the persistent 128 x 64 grid
    against the tile route's waves times the cost of its wave, over a
    grid of M and N on cards of different SM counts; the plan takes the
    tile route it would take without wgmma wherever wgmma is not faster."""
    for m in list(range(17, 300, 37)) + [512, 768, 1024, 1536, 2048, 4096]:
        for n in (64, 128, 300, 896, 2048, 4864, 12288, 33792):
            wg, tile, route = _grid_costs(m, n, sms)
            want = tile is not None and wg < tile
            assert rm.wgmma_faster(m, n, sms) == want, (m, n, sms)
            plan = rm.launch_plan(m, 896, n, torch.bfloat16, 8, sms,
                                  aligned=True)
            assert plan.route == ("wgmma" if want else route), (m, n)


@pytest.mark.parametrize("m,n,route", [
    (1024, 896, "wgmma"),     # 224 blocks of 64 x 64 (two on some SMs)
                              # vs 112 wgmma tiles: one wave
    (256, 896, "tile64"),     # 56 blocks of 64 x 64: one an SM
    (1024, 128, "tile64"),    # 32 blocks of 64 x 64
    (1024, 4864, "wgmma"),    # 304 tile128 blocks (3 waves x 1.75) vs 608
                              # tiles (5 waves)
    (256, 4864, "tile128"),   # 76 blocks (1 wave) vs 152 tiles (2)
    (1024, 2048, "tile128"),  # 128 blocks (1 wave) vs 256 tiles (2)
    (256, 12288, "wgmma"),    # 192 blocks (2 waves) vs 384 tiles (3)
    (256, 33792, "tile128")]) # 528 blocks (4 waves) vs 1056 tiles (8)
def test_wgmma_faster_by_hand(m, n, route):
    """Hand-counted waves on the H100's 132 SMs."""
    plan = rm.launch_plan(m, 2048, n, torch.bfloat16, 4, aligned=True)
    assert plan.route == route


def test_call_plan_reads_alignment_only_for_the_route():
    """call_plan reads the operands' pointers only for a call the wgmma
    route can take: an M <= 16 (decode) call, f32 x or posit16 never
    asks."""
    src = inspect.getsource(rm.call_plan)
    body = src[src.index("aligned = "):]
    first = body.index("tma_aligned(")
    for check in ("m > SPLIT_K_MAX_M", "x.dtype == torch.bfloat16",
                  "spec.bits <= 8"):
        assert body.index(check) < first


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("stacked", [True, False])
def test_k1100_n300_stay_on_the_tiles(bits, stacked):
    """Phase 2's K = 1100, N = 300 shapes: K is no multiple of 64, and the
    stacked layout's rows of words are no multiple of 16 bytes, so every
    M > 16 call stays on tile64 / tile128."""
    from repro_torch.core import formats
    from repro_torch.kernels.ops import pack_tensor
    spec = formats.FP4 if bits == 4 else formats.POSIT8
    w = torch.zeros((2, 1100, 300) if stacked else (1100, 300))
    t = pack_tensor(spec, w)
    t = t[1] if stacked else t
    assert not rm.tma_aligned(1100, t.words.shape[1], 0, 0)
    for m in (17, 64, 256, 1024):
        assert rm.launch_plan(m, 1100, 300, torch.bfloat16, bits,
                              aligned=False).route in ("tile64", "tile128")
    # K = 1152 in the 2-D layout (N padded to 512): TMA-aligned
    t2 = pack_tensor(spec, torch.zeros(1152, 300))
    assert rm.tma_aligned(1152, t2.words.shape[1], 0, 16)


def test_tma_alignment_rule():
    assert rm.tma_aligned(896, 608, 0, 256)
    assert not rm.tma_aligned(896 + 8, 608, 0, 256)      # K % 64
    assert not rm.tma_aligned(896, 75, 0, 256)           # 300-row stride
    assert not rm.tma_aligned(896, 608, 8, 256)          # x's pointer
    assert not rm.tma_aligned(896, 608, 0, 4)            # the words'


@pytest.mark.parametrize("k,n,m", [
    (896, 896, 1024), (896, 4864, 1024), (4864, 896, 1024),
    (12288, 12288, 256), (12288, 1024, 768), (2048, 2048, 512)])
def test_wgmma_grid(k, n, m):
    """A persistent block an SM (at most) over 128 x 64 tiles; the chunk
    partials are those of every other tensor route."""
    plan = rm.launch_plan(m, k, n, torch.bfloat16, 4, aligned=True)
    tiles = -(-m // 128) * -(-n // 64)
    assert plan.route == "wgmma"
    assert plan.grid == (min(tiles, rm.H100_SMS), 1)
    assert plan.threads == 288 and plan.chunks == rm.chunk_bounds(k)
    assert (plan.scratch_floats, plan.counters) == (0, 0)


def _cu_source():
    with open(os.path.join(_build.CSRC_DIR, "rmmec_matmul.cu")) as f:
        return f.read()


def test_wgmma_constants_match_the_cuda_source():
    src = _cu_source()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    consumers = int(const("WG_CONSUMERS"))
    assert consumers == rm.WG_CONSUMERS
    assert const("WG_BM") == "64 * WG_CONSUMERS"
    assert int(const("WG_BN")) == rm.TILES["wgmma"][1] == 64
    assert const("WG_THREADS") == "128 * WG_CONSUMERS + 32"
    assert rm.TILES["wgmma"] == (64 * consumers, 64, 128 * consumers + 32)
    assert int(const("WG_STAGES")) == rm.WG_STAGES
    assert int(const("KC")) == rm.KC == 128
    assert "route == ROUTE_WGMMA" in src and "ROUTE_WGMMA = 5" in src
    # the C side's alignment rule and grid are the Python plan's
    rule = src[src.index("bool tma_aligned(const Operands& op, int per)"):]
    rule = rule[:rule.index("}")]
    assert "op.K % 64 == 0" in rule and "(op.Np / per) % 4 == 0" in rule
    assert rule.count("& 15) == 0") == 2
    assert "const int grid = std::min(tiles, sm_count());" in src
    # the A and B descriptors: a k16 step moves B by 16 rows of 128 bytes
    # and A by 32 bytes within a 64-column box
    assert ("gmma_desc_sw128(bs + ks * 16 * 128, KC * 128, 1024)"
            in src)
    assert "gmma_desc_sw128(a0 + (ks / 4) * x_box + (ks % 4) * 32, 16, 1024)" \
        in src


def _cu_function(name, src=None):
    """A one-line `return <expr>;` constexpr function of the .cu source
    (or ``src``) as a Python function (C's / on non-negative ints is //)."""
    src = _cu_source() if src is None else src
    m = re.search(rf"constexpr int {name}\(([^)]*)\) \{{\s*return ([^;]+);",
                  src)
    args = [a.split()[-1] for a in m.group(1).split(",")]
    expr = m.group(2).replace("/", "//").replace("\n", " ")
    if "?" in expr:   # BITS == 8 ? a : b
        cond, rest = expr.split("?")
        a, b = rest.split(":")
        expr = f"({a}) if ({cond}) else ({b})"
    return eval(f"lambda {', '.join(args)}: {expr}", {"KC": rm.KC})


def _swizzle128(a):
    """The 128-byte swizzle on a byte offset inside a 1024-byte atom."""
    return a ^ (((a >> 7) & 7) << 4)


def test_b_slot_layout_is_wgmmas_swizzled_n_major_layout():
    """The decoded B slot (wg_b_offset, read from the .cu): every (k, n)
    of a KC x 128 chunk of bf16 weights at its own 2-byte place, filling
    the slot's KC * 256 bytes exactly; each 8 x 8 core matrix (8 rows of K,
    8 columns of N: one 16-byte chunk per row) where the descriptor says:
    atom (K group k // 8, N half n // 64) at (k // 8) * SBO + (n // 64) *
    LBO with SBO = 1024 and LBO = KC * 128 (the values the kernel passes),
    rows 128 bytes apart inside the atom, 16-byte chunks swizzled by 128
    bytes; and a k16 step two atoms on."""
    off = _cu_function("wg_b_offset")
    kc, lbo, sbo = rm.KC, rm.KC * 128, 1024
    seen = set()
    for k in range(kc):
        for n in range(128):
            o = off(k, n)
            assert o % 2 == 0 and 0 <= o < kc * 256
            assert o == (n // 64) * lbo + (k // 8) * sbo \
                + _swizzle128(128 * (k % 8) + 2 * (n % 64))
            seen.add(o)
    assert len(seen) == kc * 128                      # a bijection
    for k0 in range(0, kc, 8):                        # core matrices
        for n0 in range(0, 128, 8):
            rows = [off(k, n0) for k in range(k0, k0 + 8)]
            assert all(off(k, n0 + j) == off(k, n0) + 2 * j
                       for k in range(k0, k0 + 8) for j in range(8))
            base = (k0 // 8) * sbo + (n0 // 64) * lbo
            assert sorted(r - base for r in rows) == [
                128 * i + 16 * (((n0 % 64) // 8) ^ i) for i in range(8)]
    assert off(16, 0) - off(0, 0) == 2 * sbo          # one k16 step


def test_x_tile_layout_is_tmas_128_byte_swizzle():
    """wg_x_offset (the x tile as the ablation's probe writes it and as the
    TMA load of a chunk lays it out): two 64-column boxes of 128-byte rows,
    16-byte chunks swizzled by 128 bytes, a bijection onto the tile."""
    from repro_torch.benchmarks import rmmec_ablation as ab
    with open(ab.PROBE_CU) as f:
        off = _cu_function("wg_x_offset", f.read())
    rows, box = 128, 128 * 128
    seen = {off(r, k, box) for r in range(rows) for k in range(rm.KC)}
    assert len(seen) == rows * rm.KC
    for r in range(rows):
        for k in range(rm.KC):
            assert off(r, k, box) == (k // 64) * box + 1024 * (r // 8) \
                + _swizzle128(128 * (r % 8) + 2 * (k % 64))


@pytest.mark.parametrize("bits", [4, 8])
def test_word_pieces_cover_the_chunk_in_row_groups(bits):
    """wg_piece_row and wg_raw_piece (read from the .cu): the consumer
    threads' pieces of a chunk's words cover its KC rows x 64 columns
    once; eight consecutive threads take one piece column of eight
    consecutive rows, which TMA's swizzle of the words (64-byte rows for
    8-bit codes, 32-byte rows for 4-bit ones) spreads over all 32 banks
    and whose 16-byte stores into the B slot land in eight bank groups."""
    src = _cu_source()
    body = src[src.index("__device__ __forceinline__ int wg_piece_row"):]
    body = body[:body.index("\n}\n")]
    assert "const int s = tid + j * NC;" in body
    assert "return s / (8 * PIECES) * 8 + s % 8;" in body
    assert "const int pc = (threadIdx.x / 8) % PIECES;" in src
    m = re.search(r"constexpr int wg_raw_piece\(int r, int pc\) \{\s*"
                  r"return BITS == 8 \? ([^:]+) : ([^;]+);", src)
    expr = (m.group(1) if bits == 8 else m.group(2)).replace("/", "//")
    piece = eval(f"lambda r, pc: {expr}")
    nc = 128 * rm.WG_CONSUMERS
    pieces = rm.TILES["wgmma"][1] // (32 // bits) // 4
    per_thread = rm.KC * pieces // nc
    assert {piece(r, pc) for r in range(rm.KC) for pc in range(pieces)} \
        == set(range(rm.KC * pieces))

    def row(tid, j):
        s = tid + j * nc
        return s // (8 * pieces) * 8 + s % 8

    cover = {(row(tid, j), (tid // 8) % pieces)
             for tid in range(nc) for j in range(per_thread)}
    assert cover == {(r, pc) for r in range(rm.KC) for pc in range(pieces)}
    off = _cu_function("wg_b_offset")
    for t0 in range(0, nc, 8):
        pc = (t0 // 8) % pieces
        for j in range(per_thread):
            rows = [row(t, j) for t in range(t0, t0 + 8)]
            assert rows == list(range(rows[0], rows[0] + 8))
            assert len({piece(r, pc) * 16 % 128 for r in rows}) == 8
            for i in range(32 // bits // 2):
                n = (pc * (32 // bits // 2) + i) * 8
                assert len({off(r, n) % 128 // 16 for r in rows}) == 8


def test_wgmma_route_counts_its_launches():
    assert isinstance(rm.wgmma_route.launches, int)
    assert "wgmma_route.launches += 1" in open(rm.__file__).read()


@pytest.mark.parametrize("bits", [4, 8])
def test_wgmma_shared_memory_fits_a_block(bits):
    """WgSmem's sum (the x ring, the words' ring, two B slots, the table's
    copies, the mask bytes, the barriers, 1024 bytes of alignment slack),
    rebuilt from the .cu's constants, fits the 232,448 bytes a block may
    have; the .cu asserts the same at compile time."""
    src = _cu_source()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    bm = 64 * rm.WG_CONSUMERS
    bn, stages = const("WG_BN"), const("WG_STAGES")
    ls = 5 if bits == 4 else 4
    assert "static constexpr int LS = BITS == 4 ? 5 : 4;" in src
    x_bytes = 2 * bm * 64 * 2
    raw_bytes = rm.KC * bn * bits // 8
    total = (stages * (x_bytes + raw_bytes) + 2 * rm.KC * 128 + (1024 << ls)
             + const("WG_MASK_BYTES") + 4 * stages * 8 + 1024)
    assert total <= 232448
    assert x_bytes % 1024 == 0 and raw_bytes % 1024 == 0
    assert "BYTES <= 232448" in src
