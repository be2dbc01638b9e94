"""The five architectures the port took last against the JAX package, on
the CPU: the dense gemma-2b (GeGLU, MQA at Dh 256 in full, tied read-out),
deepseek-67b and command-r-plus-104b, the audio musicgen-medium
(``frame_embeds`` in, no ``embed``, a code embedded through the
transposed ``lm_head``) and the vision qwen2-vl-7b (``patch_embeds``
spliced in front, M-RoPE).

Here: ``mrope`` and the (3, B, S) M-RoPE positions against the
reference's; prefill logits of each reduced float32 config; four decode
steps on a bf16 cache; the tree's keys and shapes; layer-by-layer packing
at init.  The posit8 decode is in ``test_torch_frontends_decode.py``,
losses and gradients in ``test_torch_frontends_train.py``, gemma-2b's
engines in ``test_torch_gemma_serve.py`` and the engines' refusals in
``test_torch_refusals.py`` (shared pieces: ``_torch_frontends.py``)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _torch_frontends as F  # noqa: E402
from _torch_bridge import jax_to_numpy, one_torch_thread  # noqa: E402,F401
from repro.models import layers as jL  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import zoo  # noqa: E402


@pytest.mark.parametrize("dh,sections", [(32, None), (128, None),
                                         (32, (8, 4, 4)), (64, (2, 10, 20))])
def test_mrope_matches_reference(dh, sections):
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 9, 3, dh)).astype(np.float32)
    pos3 = rng.integers(0, 300, (3, 2, 9)).astype(np.int32)
    want = jL.mrope(jnp.asarray(x), jnp.asarray(pos3), 1e4, sections)
    got = L.mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e4,
                  sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # three equal streams rotate exactly as 1-D RoPE at any sections
    same = torch.from_numpy(pos3[:1]).expand(3, 2, 9)
    np.testing.assert_array_equal(
        L.mrope(torch.from_numpy(x), same, 1e4, sections).numpy(),
        L.rope(torch.from_numpy(x), same[0], 1e4).numpy())


@pytest.mark.parametrize("s,n_patches", [(12, 8), (300, 256), (5, 0),
                                         (20, 9)])
def test_mrope_positions_match_reference(s, n_patches):
    cfg = get_config("qwen2-vl-7b")
    want = np.asarray(jT._mrope_positions(cfg, 3, s, n_patches))
    got = T._mrope_positions(cfg, 3, s, n_patches)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", F.NEW_ARCHS)
def test_prefill_logits_match_reference(arch):
    jcfg, cfg = F.cfgs(arch)
    jp = F.params(arch)
    b = F.batch(cfg)
    want, _, _ = jzoo.apply_model(jp, F.jbatch(b), jcfg, mode="prefill")
    got, cache = zoo.apply_model(F.tree(jp), F.tbatch(b), cfg)
    assert got.shape == (F.B, F.S, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F.LOGIT_TOL, atol=F.LOGIT_TOL)
    assert sorted(cache) == ["k", "v"]
    last, _ = zoo.apply_model(F.tree(jp), F.tbatch(b), cfg, last_only=True)
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1:],
                               rtol=F.LOGIT_TOL, atol=F.LOGIT_TOL)


@pytest.mark.parametrize("arch", F.NEW_ARCHS)
def test_decode_steps_bf16_cache_match_reference(arch):
    F.check_decode(arch, packed=False, quantized=False)


def _shapes(t, path=""):
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(_shapes(v, f"{path}/{k}" if path else k))
        return out
    return {path: tuple(np.shape(t))}


def test_lm_init_shapes_match_reference():
    """The port's tree has the reference's keys and shapes for every new
    config: no ``embed`` and an ``lm_head`` for audio, no ``lm_head``
    for gemma's tied read-out."""
    for arch in F.NEW_ARCHS:
        _, cfg = F.cfgs(arch)
        want = _shapes(jax_to_numpy(F.params(arch)))
        got = _shapes(zoo.init_model(cfg, torch.Generator().manual_seed(0)))
        assert got == want, arch
        tops = {p.split("/")[0] for p in got}
        assert ("embed" in tops) == (cfg.frontend != "audio"), arch
        assert ("lm_head" in tops) == (not cfg.tie_embeddings
                                       or cfg.frontend == "audio"), arch


def test_layerwise_packed_init_equals_pack_params():
    """``init_model(policy=...)`` packs each layer as it is drawn, and a
    read-out over ``ops.PACK_SLAB`` in column slabs: the same words,
    scales and masks as ``pack_params`` of the whole f32 tree from the
    same seed."""
    from repro_torch.kernels import ops
    pol = PrecisionPolicy.paper_mixed()
    for arch in ("qwen2-vl-7b", "musicgen-medium"):
        cfg = get_config(arch).reduced()
        want = zoo.pack_params(
            zoo.init_model(cfg, torch.Generator().manual_seed(4)), pol)
        slab = ops.PACK_SLAB
        ops.PACK_SLAB = 128 * 128          # lm_head (128, 512): four slabs
        try:
            got = zoo.init_model(cfg, torch.Generator().manual_seed(4),
                                 policy=pol)
        finally:
            ops.PACK_SLAB = slab
        assert isinstance(got["lm_head"]["w"], ops.PackedTensor)
        assert [p for p, _ in F.leaves(got)] == \
            [p for p, _ in F.leaves(want)]
        for (path, a), (_, w) in zip(F.leaves(got), F.leaves(want)):
            np.testing.assert_array_equal(a, w, err_msg=path)
