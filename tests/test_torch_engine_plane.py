"""The engine plane of the PyTorch port against the JAX package: the
decode kernel's plain version (exactly equal to JAX ``ops.dequant``,
which runs ``dequant_pallas`` in interpret mode here), the quire limbs
(bit for bit against ``quire_dot_pallas`` in interpret mode and the
exact oracles), the ``core.quire`` copy, the SIMD-MAC facade
``core.npe`` and the Table II/III bench twins."""

import contextlib
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _hyp import given, settings, st  # noqa: E402
from _torch_bridge import jax_to_numpy, one_torch_thread  # noqa: E402,F401
from repro.core import formats as jfmt  # noqa: E402
from repro.core import npe as jnpe  # noqa: E402
from repro.core import quire as jquire  # noqa: E402
from repro.core.packing import pack as jpack  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.quire_dot import quire_dot_pallas  # noqa: E402
from repro_torch.benchmarks import bench_coprocessor, bench_mac_engine  # noqa: E402
from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.core import npe as tnpe  # noqa: E402
from repro_torch.core import quire as tquire  # noqa: E402
from repro_torch.core.packing import pack as tpack  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.codec import dequant, dequant_plain  # noqa: E402
from repro_torch.kernels.quire_dot import (QUIRE_FRAC_BITS,  # noqa: E402
                                           quire_dot, quire_dot_plain)

PACKABLE = ["fp4", "posit4_1", "posit8_0", "posit16_1", "fp8_e4m3",
            "fp8_e5m2", "fxp4", "fxp8"]
NPE_RTOL = 1e-6   # f32 sums of <= 96 products in another order than XLA's


def _weight(shape, seed):
    """Unit-normal weights: every po2 scale exponent stays within the
    +-12 where the reference's XLA ``exp2`` is exact on the CPU."""
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _bridged(jt):
    """A JAX PackedTensor handed to the port as numpy (words, scales and
    all, so both sides dequantize the same pack)."""
    return params_from_numpy({"t": jax_to_numpy(jt)}, device="cpu")["t"]


# ---------------------------------------------------------------------------
# dequant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PACKABLE)
@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("layout", ["2d", "stacked"])
def test_dequant_exactly_equal_to_jax(name, group, layout):
    spec = jfmt.FORMATS[name]
    if layout == "2d":
        jt = jops.pack_tensor(spec, jnp.asarray(_weight((100, 72), 1)),
                              group_size=group)
    else:
        stacked = jops.pack_tensor(spec, jnp.asarray(_weight((2, 100, 72), 2)),
                                   group_size=group)
        jt = jops.PackedTensor(stacked.words[1], stacked.scales[1],
                               stacked.mask[1], stacked.shape, spec,
                               stacked.group)
    want = np.asarray(jops.dequant(jt, interpret=True))
    tt = _bridged(jt)
    got = tops.dequant(tt)
    assert got.dtype == torch.float32 and got.shape == (100, 72)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tops.unpack_tensor(tt).numpy(), want)
    # the bf16 output: JAX's f32 matrix cast to bf16, bit for bit
    half = tops.dequant(tt, torch.bfloat16)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half.view(torch.int16),
                       torch.tensor(want).to(torch.bfloat16)
                       .view(torch.int16))


def test_dequant_refuses_stacked_and_bad_layouts():
    tt = tops.pack_tensor(tfmt.POSIT8, torch.from_numpy(_weight((2, 64, 40), 3)))
    with pytest.raises(ValueError):
        tops.dequant(tt)
    t1 = tt[1]
    with pytest.raises(ValueError):      # more rows than the words hold
        dequant(t1.words, t1.scales, t1.spec, 65, 40)
    with pytest.raises(ValueError):      # no decoder for a native format
        dequant(t1.words, t1.scales, tfmt.BF16, 64, 40)


def test_dequant_cpu_wrapper_takes_plain_version_and_counts_nothing():
    t = tops.pack_tensor(tfmt.FP4, torch.from_numpy(_weight((96, 40), 4)),
                         group_size=32)
    before = dequant.launches
    got = dequant(t.words, t.scales, t.spec, 96, 40)
    assert dequant.launches == before
    assert torch.equal(got, dequant_plain(t.words, t.scales, t.spec, 96, 40))
    assert torch.equal(got, tops.to_dense(t))


@pytest.mark.parametrize("name", PACKABLE)
def test_dequant_bf16_output_equals_to_dense(name):
    """The bf16 output (the MoE expert slices' route) is the f32 product
    rounded once: equal to the f32 output cast, and to ``to_dense`` of
    the stack in bf16, bit for bit."""
    spec = tfmt.FORMATS[name]
    t = tops.pack_tensor(spec, torch.from_numpy(_weight((2, 96, 40), 6)),
                         group_size=32)
    got = dequant(t[1].words, t[1].scales, spec, 96, 40, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (96, 40)
    assert torch.equal(got.view(torch.int16),
                       dequant_plain(t[1].words, t[1].scales, spec, 96, 40)
                       .to(torch.bfloat16).view(torch.int16))
    if spec.bits <= 8:        # decodes exactly in bf16: one rounding either way
        assert torch.equal(got, tops.to_dense(t, torch.bfloat16)[1])
    with pytest.raises(TypeError):
        dequant(t[1].words, t[1].scales, spec, 96, 40, torch.float16)


def test_pack_tensor_blocks_equal_jax():
    """The co-processor's array tilings: padding and mask granularity."""
    w = _weight((300, 200), 5)
    for blocks in ((8, 512, 128), (16, 512, 128)):
        for name in ("fp4", "posit8_0", "posit16_1"):
            jt = jops.pack_tensor(jfmt.FORMATS[name], jnp.asarray(w),
                                  blocks=blocks)
            tt = tops.pack_tensor(tfmt.FORMATS[name], torch.from_numpy(w),
                                  blocks=blocks)
            np.testing.assert_array_equal(
                tt.words.numpy(), np.asarray(jt.words).view(np.int32))
            np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))
            np.testing.assert_array_equal(tt.scales.numpy(),
                                          np.asarray(jt.scales))


# ---------------------------------------------------------------------------
# quire
# ---------------------------------------------------------------------------

def _pallas_limbs(a, b):
    """quire_dot_pallas in interpret mode, padded as JAX ops.quire_dot pads."""
    bsz, k = a.shape
    bp, kp = -(-bsz // 8) * 8, -(-k // 512) * 512
    pad = ((0, bp - bsz), (0, kp - k))
    hi, lo = quire_dot_pallas(jnp.asarray(np.pad(a, pad), jnp.int32),
                              jnp.asarray(np.pad(b, pad), jnp.int32),
                              bb=8, bk=512, interpret=True)
    return np.asarray(hi)[:bsz], np.asarray(lo)[:bsz]


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 20), st.integers(1, 900), st.integers(0, 2**31 - 1))
def test_quire_limbs_bit_for_bit(b, k, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(b, k)).astype(np.int32)
    bb = rng.integers(0, 256, size=(b, k)).astype(np.int32)
    a[0, 0] = 128                                   # NaR decodes to 0
    hi, lo = quire_dot(torch.from_numpy(a), torch.from_numpy(bb))
    want_hi, want_lo = _pallas_limbs(a, bb)
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    assert int(lo.min()) >= 0 and int(lo.max()) < 2 ** QUIRE_FRAC_BITS
    # the limbs hold the float64 row sum exactly
    exact = hi[:, 0].double() + lo[:, 0].double() * 2.0 ** -QUIRE_FRAC_BITS
    np.testing.assert_array_equal(
        exact.numpy(), tref.quire_dot_ref(torch.from_numpy(a),
                                          torch.from_numpy(bb)).numpy())
    np.testing.assert_array_equal(
        tref.quire_dot_ref(torch.from_numpy(a), torch.from_numpy(bb)).numpy(),
        jref.quire_dot_ref(a, bb))


def test_quire_limbs_fixed_cases():
    """1.5 * 1.5 twice = 4.5: hi 4, lo 2^21; a negative sum floors."""
    c15 = int(tfmt.encode_table(tfmt.POSIT8, torch.tensor([1.5]))[0])
    cm = int(tfmt.encode_table(tfmt.POSIT8, torch.tensor([-1.5]))[0])
    a = np.array([[c15, c15], [cm, c15]], np.int32)
    b = np.array([[c15, c15], [c15, 0]], np.int32)
    hi, lo = quire_dot(torch.from_numpy(a), torch.from_numpy(b))
    assert hi[:, 0].tolist() == [4, -3] and lo[:, 0].tolist() == [2097152, 3145728]
    want_hi, want_lo = _pallas_limbs(a, b)
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    np.testing.assert_array_equal(lo.numpy(), want_lo)


def test_quire_cancellation_against_exact_oracles():
    """64*64 + 512 * (1/64)^2 + (-64)*(-64) with a == b: an f32 running
    sum loses the tiny terms next to 8192, the quire does not
    (``tests/test_kernels.py``'s case)."""
    big, one, neg = (int(c) for c in tfmt.encode_table(
        tfmt.POSIT8, torch.tensor([64.0, 1.0 / 64, -64.0])))
    a = np.array([[big] + [one] * 512 + [neg]], np.int32)
    got = float(tops.quire_dot(torch.from_numpy(a), torch.from_numpy(a))[0])
    want = tquire.quire_dot_exact(tfmt.POSIT8, a[0], a[0])
    assert want == jquire.quire_dot_exact(jfmt.POSIT8, a[0], a[0]) \
        == 8192 + 512 / 4096
    assert got == want
    assert got == float(jops.quire_dot(jnp.asarray(a), jnp.asarray(a),
                                       interpret=True)[0])
    hi, lo = quire_dot_plain(torch.from_numpy(a), torch.from_numpy(a))
    want_hi, want_lo = _pallas_limbs(a, a)
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    np.testing.assert_array_equal(lo.numpy(), want_lo)


def test_quire_dot_ops_matches_jax():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, size=(11, 700))
    b = rng.integers(0, 256, size=(11, 700))
    got = tops.quire_dot(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jops.quire_dot(jnp.asarray(a), jnp.asarray(b),
                                     interpret=True))
    assert got.dtype == torch.float32 and got.shape == (11,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quire_cpu_wrapper_counts_nothing_and_checks_inputs():
    a = torch.zeros((3, 5), dtype=torch.int32)
    before = quire_dot.launches
    quire_dot(a, a)
    assert quire_dot.launches == before
    with pytest.raises(ValueError):
        quire_dot(a, a[:, :4])
    with pytest.raises(TypeError):
        quire_dot(a.long(), a.long())


# ---------------------------------------------------------------------------
# core.quire copy, simd_lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fp4", "posit4_1", "fxp4", "posit8_0",
                                  "fp8_e4m3", "fp8_e5m2", "fxp8"])
def test_quire_copy_equals_reference(name):
    tspec, jspec = tfmt.FORMATS[name], jfmt.FORMATS[name]
    rng = np.random.default_rng(7)
    a = rng.integers(0, tspec.ncodes, 64)
    b = rng.integers(0, tspec.ncodes, 64)
    assert tquire._min_lsb(tspec) == jquire._min_lsb(jspec)
    p = tquire._min_lsb(tspec)
    for c in range(tspec.ncodes):
        assert tquire.value_as_fixed(tspec, c, p) == \
            jquire.value_as_fixed(jspec, c, p)
    assert tquire.quire_dot_exact(tspec, a, b) == \
        jquire.quire_dot_exact(jspec, a, b)
    am = rng.integers(0, tspec.ncodes, (3, 5))
    bm = rng.integers(0, tspec.ncodes, (5, 4))
    np.testing.assert_array_equal(tquire.quire_matmul_exact(tspec, am, bm),
                                  jquire.quire_matmul_exact(jspec, am, bm))


def test_simd_lanes_equal_reference():
    for name, spec in tfmt.FORMATS.items():
        assert tfmt.simd_lanes(spec) == jfmt.simd_lanes(jfmt.FORMATS[name])


# ---------------------------------------------------------------------------
# core.npe
# ---------------------------------------------------------------------------

def _packed_streams(spec_bits, a_codes, b_codes):
    jw = [np.asarray(jpack(jnp.asarray(c)[None], spec_bits)[0])
          for c in (a_codes, b_codes)]
    tw = [tpack(torch.from_numpy(c)[None], spec_bits)[0]
          for c in (a_codes, b_codes)]
    for j, t in zip(jw, tw):
        np.testing.assert_array_equal(t.numpy(), j.view(np.int32))
    return jw, tw


@pytest.mark.parametrize("prec_sel", [0, 1, 2, 3])
def test_simd_dot_packed_equals_jax(prec_sel):
    spec = tnpe.PREC_SEL[prec_sel]
    assert spec.name == jnpe.PREC_SEL[prec_sel].name
    rng = np.random.default_rng(prec_sel)
    k = 96
    a = rng.integers(0, spec.ncodes, k)
    b = rng.integers(0, spec.ncodes, k)
    a[a == tfmt.nar_code(spec)] = 0
    b[b == tfmt.nar_code(spec)] = 0
    a[:10] = 0                                  # some gated MACs
    (jaw, jbw), (taw, tbw) = _packed_streams(spec.bits, a, b)
    jout, jstats = jnpe.simd_dot_packed(jnp.asarray(jaw), jnp.asarray(jbw),
                                        k, prec_sel)
    tout, tstats = tnpe.simd_dot_packed(taw, tbw, k, prec_sel)
    assert tout.dtype == torch.float32 and tout.shape == ()
    assert vars(tstats) == vars(jstats)
    assert tstats.macs_gated >= 10
    np.testing.assert_allclose(float(tout), float(jout), rtol=NPE_RTOL)
    tab = np.where(np.isnan(tfmt.code_values(spec)), 0.0,
                   tfmt.code_values(spec)).astype(np.float64)
    want = float(np.sum(tab[a] * tab[b]))
    assert abs(float(tout) - want) < 1e-3 * max(abs(want), 1.0)


def test_power_gating_stats_equal_jax():
    rng = np.random.default_rng(0)
    k = 512
    a = rng.integers(1, 256, k)
    a[a == 128] = 1                   # no NaR
    a[: k // 2] = 0                   # half the stream is zero
    b = rng.integers(1, 128, k)
    (jaw, jbw), (taw, tbw) = _packed_streams(8, a, b)
    _, jstats = jnpe.simd_dot_packed(jnp.asarray(jaw), jnp.asarray(jbw), k, 2)
    _, tstats = tnpe.simd_dot_packed(taw, tbw, k, 2)
    assert vars(tstats) == vars(jstats)
    assert tstats.macs_gated >= k // 2
    assert 0.4 < tstats.gating_fraction < 0.7
    assert tstats.ai_gain_vs_fp32 == pytest.approx(4.0, rel=0.1)
    assert tstats.gating_fraction == jstats.gating_fraction
    assert tstats.ai_gain_vs_fp32 == jstats.ai_gain_vs_fp32


# ---------------------------------------------------------------------------
# bench twins
# ---------------------------------------------------------------------------

def _jax_pack_shape(name, k, n, **kw):
    return jax.eval_shape(
        lambda w: jops.pack_tensor(jfmt.FORMATS[name], w, **kw),
        jax.ShapeDtypeStruct((k, n), jnp.float32))


def _mac_engine_fields(k, n):
    """Derived fields of bench_mac_engine's packed rows, from JAX's pack."""
    out = {}
    for group in bench_mac_engine.GROUPS:
        for spec in bench_mac_engine.SPECS:
            t = _jax_pack_shape(spec.name, k, n, group_size=group)
            pbytes = t.words.size * 4 + t.scales.size * 4
            gtag = "" if group is None else f"_g{group}"
            out[f"mac_engine/packed_{spec.name}{gtag}"] = (
                f"bytes_w={pbytes};AI_gain_vs_fp32={k * n * 4 / pbytes:.2f};"
                f"simd_lanes_16b={jfmt.simd_lanes(jfmt.FORMATS[spec.name])}")
    return out


def _coprocessor_fields(k, n):
    """packed_bytes and mode of bench_coprocessor's rows, from JAX's pack."""
    out = {}
    for arr, blocks in bench_coprocessor.ARRAYS:
        for spec in bench_coprocessor.SPECS:
            t = _jax_pack_shape(spec.name, k, n, blocks=blocks)
            out[f"coprocessor/array{arr}_{spec.name}"] = (
                f"packed_bytes={t.words.size * 4};mode=prec_sel_"
                f"{jfmt.simd_lanes(jfmt.FORMATS[spec.name])}lane")
    return out


def test_bench_fields_at_full_size_equal_jax_pack():
    k, n = bench_mac_engine.K, bench_mac_engine.N
    want = _mac_engine_fields(k, n)
    w = torch.zeros((k, n))
    for group in bench_mac_engine.GROUPS:
        for spec in bench_mac_engine.SPECS:
            t = tops.pack_tensor(spec, w, group_size=group)
            gtag = "" if group is None else f"_g{group}"
            assert bench_mac_engine.packed_fields(t, spec) == \
                want[f"mac_engine/packed_{spec.name}{gtag}"]
    k, n = bench_coprocessor.K, bench_coprocessor.N
    want = _coprocessor_fields(k, n)
    w = torch.zeros((k, n))
    for arr, blocks in bench_coprocessor.ARRAYS:
        for spec in bench_coprocessor.SPECS:
            t = tops.pack_tensor(spec, w, blocks=blocks)
            field = bench_coprocessor.packed_fields(t, spec, 1.0)
            assert field.split(";", 1)[1] == \
                want[f"coprocessor/array{arr}_{spec.name}"]


def _rows(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return [ln.split(",", 2) for ln in buf.getvalue().splitlines()]


def test_bench_mac_engine_runs_on_cpu(monkeypatch):
    m, k, n = 8, 256, 128
    for attr, v in (("M", m), ("K", k), ("N", n)):
        monkeypatch.setattr(bench_mac_engine, attr, v)
    rows = _rows(bench_mac_engine.run, "cpu")
    want = _mac_engine_fields(k, n)
    names = [r[0] for r in rows]
    assert names == (["mac_engine/fp32_dense"] + list(want)
                     + ["mac_engine/quire_dot_posit8"])
    assert rows[0][2] == f"bytes_w={k * n * 4};AI={2 * m * k * n / (k * n * 4 + m * k * 4):.2f}"
    for name, us, derived in rows[1:-1]:
        assert float(us) > 0 and derived == want[name]
    assert rows[-1][2] == "exact=1;limbs=int32x2"


def test_bench_coprocessor_runs_on_cpu(monkeypatch):
    k, n = 512, 256
    for attr, v in (("M", 8), ("K", k), ("N", n)):
        monkeypatch.setattr(bench_coprocessor, attr, v)
    rows = _rows(bench_coprocessor.run, "cpu")
    want = _coprocessor_fields(k, n)
    assert [r[0] for r in rows] == list(want)
    for name, us, derived in rows:
        gops, rest = derived.split(";", 1)
        assert gops.startswith("gops=") and float(gops[5:]) >= 0  # timed
        assert rest == want[name] and float(us) > 0


def test_bench_run_cli(monkeypatch, capsys):
    monkeypatch.setattr(bench_run, "BENCHES",
                        {"mac_engine": lambda device: print(f"ran,{device}")})
    bench_run.main(["--only", "mac_engine", "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == \
        ["name,us_per_call,derived", "ran,cpu"]


def test_check_packed_refuses_a_wrong_product(monkeypatch):
    from repro_torch.benchmarks.common import check_packed
    t = tops.pack_tensor(tfmt.POSIT8, torch.from_numpy(_weight((64, 40), 8)))
    x = torch.randn(4, 64)
    check_packed("ok", x, t)
    # a product that ignores the weight's scales must be caught
    doubled = tops.PackedTensor(t.words, t.scales * 2, t.mask, t.shape, t.spec)
    orig = tops.packed_matmul
    monkeypatch.setattr(tops, "packed_matmul", lambda x_, t_: orig(x_, t))
    with pytest.raises(AssertionError):
        check_packed("bad", x, doubled)


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", PACKABLE)
@pytest.mark.parametrize("group", [None, 32])
def test_dequant_kernel_bitwise_on_card(cuda, name, group):
    spec = tfmt.FORMATS[name]
    t = tops.pack_tensor(spec, torch.from_numpy(_weight((2, 896, 4864), 9))
                         .to(cuda), group_size=group)[1]
    before = dequant.launches
    got = tops.dequant(t)
    assert dequant.launches == before + 1
    assert torch.equal(got, dequant_plain(t.words, t.scales, spec, 896, 4864))


@pytest.mark.parametrize("name", PACKABLE)
@pytest.mark.parametrize("group", [None, 32])
def test_dequant_kernel_bf16_bitwise_on_card(cuda, name, group):
    spec = tfmt.FORMATS[name]
    t = tops.pack_tensor(spec, torch.from_numpy(_weight((2, 896, 4864), 9))
                         .to(cuda), group_size=group)[1]
    got = tops.dequant(t, torch.bfloat16)
    want = dequant_plain(t.words, t.scales, spec, 896, 4864, torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_quire_kernel_bitwise_on_card(cuda):
    rng = np.random.default_rng(10)
    a = torch.from_numpy(rng.integers(0, 256, (64, 1024))).int().to(cuda)
    b = torch.from_numpy(rng.integers(0, 256, (64, 1024))).int().to(cuda)
    before = quire_dot.launches
    hi, lo = quire_dot(a, b)
    assert quire_dot.launches == before + 1
    want = quire_dot_plain(a, b)
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
