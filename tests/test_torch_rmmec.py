"""The RMMEC wrapper's launch plan, checked without a card: which route
each (x dtype, format width, M) takes, chunk boundaries that depend on K
alone, the grids and split-K scratch of qwen2-0.5b's four projection
shapes, the split-K counters shared per device, the streaming route's
strips and its decode tables (every code rebuilt with the kernel's
integer formula), and the plan's constants against
``csrc/rmmec_matmul.cu``."""

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
