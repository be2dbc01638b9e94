"""Format plane of the PyTorch port against the JAX package: every code of
every format decodes to the same value, random floats (with RNE ties,
saturation, zero, NaN and tiny values) encode to the same codes, words
pack bit for bit, po2 scales are equal, and the precision policy
resolves the same format and group for every parameter path.  All
comparisons are exact."""

import sys
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import jax_to_numpy, one_torch_thread  # noqa: E402,F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import codec as jcodec  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import codec as tcodec  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.core import packing as tpacking  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402

CODE_FORMATS = ["fp4", "posit4_1", "posit8_0", "posit16_1", "fp8_e4m3",
                "fp8_e5m2", "fxp4", "fxp8"]


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _specs(name):
    return jfmt.FORMATS[name], tfmt.FORMATS[name]


def _encode_inputs(name: str, n_random: int, max_bounds: int) -> np.ndarray:
    """Random values across the format's range, rounding boundaries
    (exact ties; at most ``max_bounds`` of them, evenly spread), +-
    saturation, zero, NaN, infinities and tiny (subnormal) values."""
    _, ts = _specs(name)
    _, _, bnds = tfmt._encode_tables(ts)
    bnds = bnds[:: -(-len(bnds) // max_bounds)]
    vmax = float(np.nanmax(np.abs(tfmt.code_values(ts))))
    rng = np.random.default_rng(len(name))
    x = np.concatenate([
        rng.normal(size=n_random) * vmax / 3,
        rng.normal(size=n_random) * 2.0 ** rng.integers(-20, 20, n_random),
        bnds.astype(np.float32), -bnds.astype(np.float32),
        [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e-30, -1e-30, 1e-45,
         vmax, -vmax, 2 * vmax, -2 * vmax, 1e30, -1e30],
    ]).astype(np.float32)
    return x


@pytest.mark.parametrize("name", CODE_FORMATS)
def test_decode_every_code(name):
    js, ts = _specs(name)
    codes = np.arange(js.ncodes, dtype=np.int32)
    want = _bits(jcodec.decode(js, jnp.asarray(codes)))
    # the codec's table path (<= 64K elements) and the branch-free path
    got_table = _bits(tcodec.decode(ts, torch.from_numpy(codes)).numpy())
    got_bits = _bits(tfmt.decode_bits(ts, torch.from_numpy(codes)).numpy())
    np.testing.assert_array_equal(got_table, want)
    np.testing.assert_array_equal(got_bits,
                                  _bits(jfmt.decode_bits(js, jnp.asarray(codes))))
    np.testing.assert_array_equal(got_bits, want)


@pytest.mark.parametrize("name", CODE_FORMATS)
@pytest.mark.parametrize("size", ["table", "branch_free"])
def test_encode_matches_reference(name, size):
    """Both codec paths, each against the reference's same-size codec
    call: below 64K elements the table path, above it the branch-free
    one."""
    js, ts = _specs(name)
    x = _encode_inputs(name, 2000 if size == "table" else 40000,
                       20000 if size == "table" else 1 << 17)
    assert (x.size <= 1 << 16) == (size == "table")
    want = np.asarray(jcodec.encode(js, jnp.asarray(x)))
    got = tcodec.encode(ts, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("k", [37, 64])
def test_pack_unpack_bit_for_bit(bits, k):
    rng = np.random.default_rng(bits + k)
    codes = rng.integers(0, 1 << bits, (3, 5, k)).astype(np.int32)
    want = np.asarray(jpacking.pack(jnp.asarray(codes), bits)).view(np.int32)
    got = tpacking.pack(torch.from_numpy(codes), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpacking.unpack(got, bits, k).numpy(), codes)


@pytest.mark.parametrize("name", ["fp4", "posit8_0", "posit16_1", "fxp8"])
@pytest.mark.parametrize("method", ["auto", "absmax_po2", "posit_rms",
                                    "absmax"])
@pytest.mark.parametrize("group", [None, 32])
def test_scales_exactly_equal(name, method, group):
    """The reference's XLA ``exp2`` on the CPU is exact only for integer
    exponents within about +-12 (the port's is exact everywhere), so the
    weights keep every po2 exponent inside that range: posit16's absmax
    maps onto maxpos = 2^28, hence the 2^24 factor."""
    js, ts = _specs(name)
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(2, 100, 24)) * rng.uniform(0.01, 3, (1, 1, 24))
         ).astype(np.float32)
    if name == "posit16_1" and method in ("absmax", "absmax_po2"):
        w = w * np.float32(2.0 ** 24)
    want = np.asarray(jquant.group_scales(js, jnp.asarray(w), group, method))
    got = tquant.group_scales(ts, torch.from_numpy(w), group, method)
    np.testing.assert_array_equal(got.numpy(), want)
    want_t = np.asarray(jquant.format_scale(js, jnp.asarray(w), method))
    got_t = tquant.format_scale(ts, torch.from_numpy(w), method)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(
        tquant.expand_group_scales(got, group, 100).numpy(),
        np.asarray(jquant.expand_group_scales(jnp.asarray(want), group, 100)))


@pytest.mark.parametrize("policy", ["paper_mixed", "paper_mixed_g32",
                                    "posit8_0"])
def test_policy_agrees_on_bridged_tree(policy):
    cfg = jax_get_config("qwen2-0.5b").reduced()
    params = jT.lm_init(jax.random.PRNGKey(0), cfg)
    tree = params_from_numpy(jax_to_numpy(params), device="cpu")
    if policy.startswith("paper_mixed"):
        jp, tp = jpolicy.PrecisionPolicy.paper_mixed(), \
            tpolicy.PrecisionPolicy.paper_mixed()
        if policy.endswith("g32"):
            jp.group_size = tp.group_size = 32
    else:
        jp = jpolicy.PrecisionPolicy.uniform(policy)
        tp = tpolicy.PrecisionPolicy.uniform(policy)
    jpaths = [p for p, _ in jpolicy.flatten_with_paths(params)]
    tpaths = [p for p, _ in tpolicy.flatten_with_paths(tree)]
    assert tpaths == jpaths
    for path in tpaths:
        assert tp.format_for(path).name == jp.format_for(path).name, path
        assert tp.group_for(path) == jp.group_for(path), path
    assert {p: s.name for p, s in tp.resolve(tree).items()} == \
        {p: s.name for p, s in jp.resolve(params).items()}
