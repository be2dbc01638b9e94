"""The port's serving slice against the JAX package, on weights made once
by JAX ``lm_init`` and bridged as numpy: prefill logits, posit8 cache
codes and one decode step's logits (float32 config), and
``ServeEngine.generate`` token for token (the default bfloat16 config;
no case needs the float32 config to avoid a near-tie)."""

import dataclasses
import os
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
from repro.models import transformer as jT  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import (params_from_numpy,  # noqa: E402
                                 tensor_from_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

JCFG = jax_get_config("qwen2-0.5b").reduced()
TCFG = get_config("qwen2-0.5b").reduced()
PROMPT = np.random.default_rng(0).integers(0, JCFG.vocab, (2, 12)) \
    .astype(np.int32)
# float32 config: the two packages differ only in f32 sum order
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return jT.lm_init(jax.random.PRNGKey(0), JCFG)


def _tparams(tree):
    """A JAX tree bridged to the port's tensors on the CPU."""
    return params_from_numpy(jax_to_numpy(tree), device="cpu")


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _policies(name):
    if name is None:
        return None, None
    jp, tp = JaxPolicy.paper_mixed(), PrecisionPolicy.paper_mixed()
    if name == "mixed_g32":
        jp.group_size = tp.group_size = 32
    return jp, tp


@pytest.mark.parametrize("policy", [None, "mixed"])
def test_prefill_logits_f32(jax_params, policy):
    jp, tp = _policies(policy)
    jparams = jzoo.pack_params(jax_params, jp) if jp else jax_params
    tparams = _tparams(jparams)
    want, jcache, _ = jzoo.apply_model(jparams, {"tokens": jnp.asarray(PROMPT)},
                                       _f32(JCFG), mode="prefill")
    got, tcache = zoo.apply_model(
        tparams, {"tokens": torch.from_numpy(PROMPT).long()}, _f32(TCFG))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # posit8 cache codes: exactly equal on identical k/v ...
    jq = jzoo.quantize_cache(jcache)
    tq = zoo.quantize_cache(_tparams(jcache))
    for key in ("k_codes", "v_codes"):
        np.testing.assert_array_equal(tq[key].numpy(), np.asarray(jq[key]))
    for key in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(tq[key].view(torch.int16).numpy(),
                                      np.asarray(jq[key]).view(np.int16))
    # ... and on the port's own k/v wherever its bf16 rows equal JAX's
    own = zoo.quantize_cache(tcache)
    for name in ("k", "v"):
        same_row = (tcache[name].view(torch.int16).numpy() ==
                    np.asarray(jcache[name]).view(np.int16)).all(-1)
        assert same_row.mean() > 0.9
        np.testing.assert_array_equal(
            own[f"{name}_codes"].numpy()[same_row],
            np.asarray(jq[f"{name}_codes"])[same_row])


def test_decode_step_logits_f32(jax_params):
    """One decode step on identical posit8 caches (packed mixed weights)."""
    jp, tp = _policies("mixed")
    jparams = jzoo.pack_params(jax_params, jp)
    tparams = _tparams(jparams)
    _, jcache, _ = jzoo.apply_model(jparams, {"tokens": jnp.asarray(PROMPT)},
                                    _f32(JCFG), mode="prefill")
    jcache = JaxEngine(_f32(JCFG), jparams, max_len=32)._pad_cache(
        jzoo.quantize_cache(jcache), 2)
    tcache = _tparams(jcache)
    nxt = np.array([[3], [77]], dtype=np.int32)
    want, jnew = jzoo.decode_model(jparams, jnp.asarray(nxt), _f32(JCFG),
                                   jcache, jnp.int32(12))
    got, tnew = zoo.decode_model(tparams, torch.from_numpy(nxt).long(),
                                 _f32(TCFG), tcache, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for key in ("k_codes", "v_codes"):
        np.testing.assert_array_equal(tnew[key].numpy(), np.asarray(jnew[key]))


GENERATE_CASES = [
    # (policy, ragged lengths, reference decode_impl)
    ("mixed", None, "blocked"), ("mixed", None, "flash"),
    ("mixed", (12, 7), "blocked"), ("mixed", (12, 7), "flash"),
    (None, None, "blocked"), (None, (12, 5), "flash"),
    ("mixed_g32", (12, 9), "blocked"),
]


@pytest.mark.parametrize("policy,lengths,impl", GENERATE_CASES)
def test_generate_tokens_equal_jax(jax_params, policy, lengths, impl):
    jp, tp = _policies(policy)
    jcfg = dataclasses.replace(JCFG, decode_impl=impl)
    jeng = JaxEngine(jcfg, jax_params, max_len=32, quantized_kv=True,
                     policy=jp)
    teng = ServeEngine(TCFG, _tparams(jax_params),
                       max_len=32, quantized_kv=True, policy=tp, device="cpu")
    want = jeng.generate(jnp.asarray(PROMPT), 10,
                         lengths=None if lengths is None
                         else jnp.asarray(lengths))
    got = teng.generate(PROMPT, 10, lengths=lengths)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_generate_bf16_kv_tokens_equal_jax(jax_params):
    jeng = JaxEngine(JCFG, jax_params, max_len=32,
                     policy=JaxPolicy.paper_mixed())
    teng = ServeEngine(TCFG, _tparams(jax_params),
                       max_len=32, policy=PrecisionPolicy.paper_mixed(),
                       device="cpu")
    np.testing.assert_array_equal(teng.generate(PROMPT, 8),
                                  np.asarray(jeng.generate(
                                      jnp.asarray(PROMPT), 8)))


@pytest.mark.parametrize("quantized,group", [(False, None), (True, None),
                                             (True, 8)])
def test_init_cache_layout_matches_jax(quantized, group):
    want = jT.init_cache(JCFG, 2, 16, quantized_kv=quantized, kv_group=group)
    got = zoo.init_cache(TCFG, 2, 16, quantized_kv=quantized, kv_group=group,
                         device="cpu")
    assert sorted(got) == sorted(want)
    for key, x in got.items():
        ref = np.asarray(want[key])
        assert tuple(x.shape) == ref.shape, key
        assert str(x.dtype).split(".")[-1] == str(ref.dtype), key
        assert float(x.float().abs().max()) == float(np.abs(ref).max()), key


def test_sampling_is_seeded(jax_params):
    teng = ServeEngine(TCFG, _tparams(jax_params),
                       max_len=32, quantized_kv=True,
                       policy=PrecisionPolicy.paper_mixed(), device="cpu")
    runs = [teng.generate(PROMPT, 6, temperature=1.0,
                          generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].shape == (2, 18)


def test_engine_cast_readout_once_and_default_device(jax_params):
    tparams = _tparams(jax_params)
    teng = ServeEngine(TCFG, tparams, max_len=32, device="cpu")
    assert teng.params["embed"]["table"].dtype == torch.bfloat16
    assert tparams["embed"]["table"].dtype == torch.float32
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(TCFG, tparams, max_len=32)
    with pytest.raises(RuntimeError):
        zoo.init_model(TCFG)


def test_bridge_defaults_to_the_card():
    tree = {"w": np.ones((2, 3), np.float32),
            "n": np.arange(3, dtype=np.uint32)}
    assert params_from_numpy(tree, device="cpu")["w"].device.type == "cpu"
    if torch.cuda.is_available():
        assert params_from_numpy(tree)["w"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tensor_from_numpy(tree["n"])
