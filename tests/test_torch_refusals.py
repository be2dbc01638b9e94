"""What the port refuses for the frontend and M-RoPE configs, against
what the JAX package refuses on the same calls: the same exception type
and message.

  * ``ContinuousEngine`` and ``DisaggEngine`` take token prompts only:
    an audio or vision config raises before any packing;
  * chunked prefill serves 1-D token streams: ``mrope`` raises;
  * ragged (left-padded) ``generate`` needs default RoPE;
  * static ``ServeEngine.generate`` builds a token batch, so musicgen and
    qwen2-vl fail on the missing ``frame_embeds`` / ``patch_embeds``
    (``KeyError``), as the reference does: the frontends are served
    through ``zoo.apply_model`` / ``zoo.decode_model``."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import _torch_frontends as F  # noqa: E402
from _torch_bridge import one_torch_thread  # noqa: E402,F401
from repro.serve import disagg as jdisagg  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.serve import disagg, engine  # noqa: E402

FRONTENDS = ["musicgen-medium", "qwen2-vl-7b"]


def _raised(fn):
    """(type, message) of what ``fn()`` raises."""
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


def _both(arch, jax_call, port_call):
    jcfg, cfg = F.cfgs(arch)
    jp = F.params(arch)
    want = _raised(lambda: jax_call(jcfg, jp))
    got = _raised(lambda: port_call(cfg, F.tree(jp)))
    assert got == want
    return got


class _NoPacking:
    """A policy that fails the test if an engine packs with it."""
    group_size = None

    def __getattr__(self, name):
        raise AssertionError(f"the engine used the policy ({name})")


@pytest.mark.parametrize("arch", FRONTENDS)
def test_paged_engines_refuse_frontends(arch):
    kw = dict(max_batch=2, max_len=32, policy=_NoPacking())
    exc, msg = _both(
        arch, lambda c, p: jengine.ContinuousEngine(c, p, n_pages=8, **kw),
        lambda c, p: engine.ContinuousEngine(c, p, n_pages=8, device="cpu",
                                             **kw))
    assert exc is ValueError and msg.startswith("ContinuousEngine serves")
    exc, msg = _both(
        arch, lambda c, p: jdisagg.DisaggEngine(c, p, **kw),
        lambda c, p: disagg.DisaggEngine(c, p, prefill_device="cpu",
                                         decode_device="cpu", **kw))
    assert exc is ValueError and msg.startswith("DisaggEngine serves")


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_prefill_refuses_mrope(paged):
    exc, msg = _both(
        "qwen2-vl-7b",
        lambda c, p: jengine.build_prefill_chunk_step(c, paged=paged),
        lambda c, p: engine.build_prefill_chunk_step(c, paged=paged))
    assert exc is ValueError and "rope_kind='mrope'" in msg


def test_ragged_generate_refuses_mrope():
    toks = F.batch(F.cfgs("qwen2-vl-7b")[1])["tokens"]
    exc, msg = _both(
        "qwen2-vl-7b",
        lambda c, p: jengine.ServeEngine(c, p, max_len=32).generate(
            jnp.asarray(toks), 2, lengths=jnp.asarray([F.S, F.S - 3])),
        lambda c, p: engine.ServeEngine(c, p, max_len=32,
                                        device="cpu").generate(
            toks, 2, lengths=[F.S, F.S - 3]))
    assert exc is ValueError and msg.startswith("ragged prompts need")


@pytest.mark.parametrize("arch,key", [("musicgen-medium", "frame_embeds"),
                                      ("qwen2-vl-7b", "patch_embeds")])
@pytest.mark.parametrize("quantized", [False, True])
def test_static_generate_needs_the_frontend_batch(arch, key, quantized):
    toks = np.random.default_rng(0).integers(0, 64, (F.B, F.S))
    exc, msg = _both(
        arch,
        lambda c, p: jengine.ServeEngine(
            c, p, max_len=32, quantized_kv=quantized).generate(
            jnp.asarray(toks, jnp.int32), 2),
        lambda c, p: engine.ServeEngine(
            c, p, max_len=32, quantized_kv=quantized,
            device="cpu").generate(toks, 2))
    assert exc is KeyError and msg == repr(key)
