"""Packed-weight data plane of the PyTorch port against the JAX package:
``pack_tensor`` words, scales and masks are exactly equal on 2-D and
stacked weights; ``to_dense`` is exactly equal; the port's
``packed_matmul`` (its plain version on the CPU) agrees with the JAX
oracle path and with the Pallas kernel in interpret mode."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import jax_to_numpy, one_torch_thread  # noqa: E402,F401
from repro.core import formats as jfmt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.rmmec_matmul import (rmmec_matmul,  # noqa: E402
                                              rmmec_matmul_plain)

# f32 sums over K in another order than XLA's
RTOL = ATOL = 1e-5

FORMATS = ["fp4", "posit4_1", "posit8_0", "posit16_1", "fp8_e4m3", "fxp8"]


def _weight(shape, seed, zero_rows=0):
    """Unit-normal weights: every po2 scale exponent stays within the
    +-12 where the reference's XLA ``exp2`` is exact on the CPU."""
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if zero_rows:
        w[..., :zero_rows, :] = 0.0
    return w


def _pack_both(name, w, group):
    jt = jops.pack_tensor(jfmt.FORMATS[name], jnp.asarray(w), group_size=group)
    tt = tops.pack_tensor(tfmt.FORMATS[name], torch.from_numpy(w),
                          group_size=group)
    return jt, tt


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("shape", [(100, 72), (3, 100, 72)])
def test_pack_tensor_exactly_equal(name, group, shape):
    jt, tt = _pack_both(name, _weight(shape, 1), group)
    np.testing.assert_array_equal(tt.words.numpy(),
                                  np.asarray(jt.words).view(np.int32))
    np.testing.assert_array_equal(tt.scales.numpy(), np.asarray(jt.scales))
    np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))
    assert (tt.shape, tt.group, tt.version) == \
        (tuple(jt.shape), jt.group, jt.version)
    np.testing.assert_array_equal(tops.to_dense(tt).numpy(),
                                  np.asarray(jops.to_dense(jt)))


def test_bridge_carries_packed_tensors():
    jt, tt = _pack_both("posit8_0", _weight((2, 64, 40), 2), 32)
    bt = params_from_numpy({"w": jax_to_numpy(jt)}, device="cpu")["w"]
    for f in ("words", "scales", "mask"):
        assert torch.equal(getattr(bt, f), getattr(tt, f)), f
    assert (bt.shape, bt.spec, bt.group) == (tt.shape, tt.spec, tt.group)


@pytest.mark.parametrize("name", ["fp4", "posit8_0", "posit16_1"])
@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_packed_matmul_stacked_vs_oracle(name, group, xdtype):
    """The stacked-slice layout of the serving plane (K=100 padded only to
    the group, N=72 to the word) against JAX's oracle path."""
    jt, tt = _pack_both(name, _weight((2, 100, 72), 3), group)
    x = np.random.default_rng(4).normal(size=(2, 5, 100)).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, xdtype))
    tx = torch.from_numpy(x).to(getattr(torch, xdtype))
    for layer in range(2):
        jl = jops.PackedTensor(jt.words[layer], jt.scales[layer],
                               jt.mask[layer], jt.shape, jt.spec, jt.group)
        want = np.asarray(jops.packed_matmul(jx, jl, use_ref=True))
        got = tops.packed_matmul(tx, tt[layer])
        assert got.dtype == torch.float32 and got.shape == (2, 5, 72)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["fp4", "posit8_0", "posit16_1"])
@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_packed_matmul_2d_vs_pallas_interpret(name, group, xdtype):
    """The 2-D kernel-padded layout, with a gated-off (all-zero) mask
    block, against the Pallas kernel in interpret mode and the oracle."""
    w = _weight((1100, 300), 5, zero_rows=1024)
    jt, tt = _pack_both(name, w, group)
    assert int(tt.mask.min()) == 0 and int(tt.mask.max()) == 1
    x = np.random.default_rng(6).normal(size=(3, 1100)).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, xdtype))
    tx = torch.from_numpy(x).to(getattr(torch, xdtype))
    got = tops.packed_matmul(tx, tt).numpy()
    kernel = np.asarray(jops.packed_matmul(jx, jt, interpret=True))
    oracle = np.asarray(jops.packed_matmul(jx, jt, use_ref=True))
    np.testing.assert_allclose(got, kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    _, tt = _pack_both("posit8_0", _weight((64, 40), 7), None)
    x = torch.randn(4, 64)
    before = rmmec_matmul.launches
    got = rmmec_matmul(x, tt.words, tt.scales, tt.mask, tt.spec, 40)
    assert rmmec_matmul.launches == before
    assert torch.equal(got, rmmec_matmul_plain(x, tt.words, tt.scales,
                                               tt.spec, 40))
    with pytest.raises(ValueError):
        rmmec_matmul(x[:, :32].repeat(1, 20), tt.words, tt.scales, tt.mask,
                     tt.spec, 40)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["fp4", "posit8_0", "posit16_1"])
@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("stacked", [True, False])
def test_kernel_vs_plain_on_card(cuda, name, group, stacked):
    w = torch.from_numpy(_weight((2, 896, 4864) if stacked else (896, 4864),
                                 8, zero_rows=0 if stacked else 512))
    t = tops.pack_tensor(tfmt.FORMATS[name], w.to(cuda), group_size=group)
    t = t[1] if stacked else t
    for m in (8, 1024):
        x = torch.randn(m, 896, device=cuda).to(torch.bfloat16)
        before = rmmec_matmul.launches
        got = rmmec_matmul(x, t.words, t.scales, t.mask, t.spec, 4864)
        assert rmmec_matmul.launches == before + 1
        want = rmmec_matmul_plain(x, t.words, t.scales, t.spec, 4864)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= \
            1e-4 * want.abs().max().item()


@pytest.mark.parametrize("name", ["fp4", "posit8_0", "posit16_1"])
@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("xdtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k", [1100, 896])
def test_kernel_rows_bitwise_on_card(cuda, name, group, xdtype, k):
    """A row's output is bitwise the same whatever M is (split-K, 64- and
    128-row tiles, the wgmma route, the streaming and SIMT kernels) and
    whatever the other rows hold, at a K that is not a multiple of the
    128-row chunk (1100) and at a TMA-aligned one whose M = 1024 calls take
    the wgmma route (896, qwen2-0.5b's width; 512 gated rows)."""
    w = torch.from_numpy(_weight((k, 4864), 9, zero_rows=512))
    t = tops.pack_tensor(tfmt.FORMATS[name], w.to(cuda), group_size=group)
    x = torch.randn(1024, k, device=cuda).to(getattr(torch, xdtype))

    def run(xx):
        return rmmec_matmul(xx.contiguous(), t.words, t.scales, t.mask,
                            t.spec, 4864)

    full = run(x)
    for m in (256, 17, 16, 8, 1):
        assert torch.equal(run(x[:m]), full[:m]), m
    other = torch.randn(1024, k, device=cuda).to(x.dtype)
    other[5] = x[5]
    other[700] = x[700]
    mixed = run(other)
    assert torch.equal(mixed[5], full[5]) and torch.equal(mixed[700],
                                                          full[700])
    assert torch.equal(run(other[:8])[5], full[5])
