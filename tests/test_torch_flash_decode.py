"""Posit8 KV plane of the PyTorch port against the JAX package:
``quantize_kv`` codes and scales are exactly equal, and the port's decode
attention (the flash-decode wrapper's plain version on the CPU) agrees
with the Pallas kernel in interpret mode, the naive oracle and the
reference's blocked XLA loop."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode_pallas
from repro.models import attention as jA
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.models import attention as tA

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import one_torch_thread  # noqa: E402,F401

# as tests/test_flash_decode.py: f32 online softmax in another order
RTOL = ATOL = 1e-5

B, T, KH, G, DH = 2, 64, 2, 2, 32
PAD = np.array([0, 13], dtype=np.int32)


def _kv(seed, group, dtype=np.float32):
    rng = np.random.default_rng(seed)
    k = (rng.normal(size=(B, T, KH, DH)) * 3).astype(dtype)
    v = rng.normal(size=(B, T, KH, DH)).astype(dtype)
    return k, v


def _quantize_both(x, group):
    jc, js = jA.quantize_kv(jnp.asarray(x), group)
    tc, ts = tA.quantize_kv(torch.from_numpy(x), group)
    return (np.asarray(jc), np.asarray(js)), (tc, ts)


@pytest.mark.parametrize("group", [None, 8])
@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_quantize_kv_exactly_equal(group, src):
    k, _ = _kv(0, group)
    if src == "bfloat16":
        jk = jnp.asarray(k, jnp.bfloat16)
        jc, js = jA.quantize_kv(jk, group)
        tc, ts = tA.quantize_kv(torch.from_numpy(k).to(torch.bfloat16), group)
    else:
        (jc, js), (tc, ts) = _quantize_both(k, group)
    assert tc.dtype == torch.uint8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))


@pytest.mark.parametrize("pos", [0, 5, 31, 63])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
@pytest.mark.parametrize("group", [None, 8])
@pytest.mark.parametrize("padded", [False, True])
def test_decode_vs_pallas_interpret_and_oracle(pos, softcap, group, padded):
    k, v = _kv(1, group)
    (jkc, jks), (tkc, tks) = _quantize_both(k, group)
    (jvc, jvs), (tvc, tvs) = _quantize_both(v, group)
    q = np.random.default_rng(2).normal(size=(B, KH, G, DH)).astype(np.float32)
    pad = np.minimum(PAD, pos) if padded else None
    jpad = None if pad is None else jnp.asarray(pad)
    tpad = None if pad is None else torch.from_numpy(pad)
    got = flash_decode(torch.from_numpy(q), tkc, tks, tvc, tvs, pos,
                       pad=tpad, softcap=softcap, blk=16).numpy()
    kernel = np.asarray(flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(jkc), jnp.asarray(jks), jnp.asarray(jvc),
        jnp.asarray(jvs), jnp.int32(pos), pad=jpad, blk=16, softcap=softcap,
        interpret=True))
    oracle = np.asarray(jref.flash_decode_ref(
        jnp.asarray(q), jkc, jks, jvc, jvs, pos, softcap, jpad))
    np.testing.assert_allclose(got, kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    naive = tref.flash_decode_ref(torch.from_numpy(q), tkc, tks, tvc, tvs,
                                  pos, softcap, tpad).numpy()
    np.testing.assert_allclose(naive, oracle, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pos", [7, 40])
def test_plain_matches_reference_blocked_loop(pos):
    """The wrapper's CPU path is the twin of the reference's XLA loop
    (``decode_quantized_blocks``) at the default block size."""
    k, v = _kv(3, None)
    (jkc, jks), (tkc, tks) = _quantize_both(k, None)
    (jvc, jvs), (tvc, tvs) = _quantize_both(v, None)
    q = np.random.default_rng(4).normal(size=(B, KH, G, DH)).astype(np.float32)
    want = np.asarray(jA.decode_quantized_blocks(
        jnp.asarray(q), {"k_codes": jkc, "k_scale": jks, "v_codes": jvc,
                         "v_scale": jvs}, jnp.int32(pos), softcap=30.0,
        pad=jnp.asarray(PAD)))
    cache = {"k_codes": tkc, "k_scale": tks, "v_codes": tvc, "v_scale": tvs}
    got = tA.decode_quantized_blocks(torch.from_numpy(q), cache, pos,
                                     softcap=30.0, pad=torch.from_numpy(PAD))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    before = flash_decode.launches
    wrapped = flash_decode(torch.from_numpy(q), tkc, tks, tvc, tvs, pos,
                           pad=torch.from_numpy(PAD), softcap=30.0)
    assert flash_decode.launches == before
    assert torch.equal(wrapped, got)


def test_wrapper_rejects_bad_shapes():
    k, _ = _kv(5, None)
    _, (tkc, tks) = _quantize_both(k, None)
    q = torch.zeros(B, KH, G, DH)
    with pytest.raises(ValueError):
        flash_decode(q, tkc, tks, tkc[:, :, :1], tks, 3)
    with pytest.raises(ValueError):
        flash_decode(q, tkc, tks, tkc, tks, T)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("pos", [0, 100, 255])
@pytest.mark.parametrize("group", [None, 32])
def test_kernel_vs_plain_on_card(cuda, pos, group):
    gen = torch.Generator(cuda).manual_seed(pos)
    kv = torch.randn((2, 8, 256, 2, 64), generator=gen, device=cuda)
    kc, ks = tA.quantize_kv(kv[0], group)
    vc, vs = tA.quantize_kv(kv[1], group)
    q = torch.randn((8, 2, 7, 64), generator=gen, device=cuda)
    pad = torch.tensor([0, 3, 17, 64, 0, 1, 130, 5], dtype=torch.int32,
                       device=cuda).clamp(max=pos)
    before = flash_decode.launches
    got = flash_decode(q, kc, ks, vc, vs, pos, pad=pad, softcap=20.0)
    assert flash_decode.launches == before + 1
    want = flash_decode_plain(q, kc, ks, vc, vs, pos, pad, 20.0)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
