"""Shared pieces of the port's tests of the five architectures it took
last (``test_torch_frontends*.py``, ``test_torch_refusals.py``): the
reduced float32 config pairs, the JAX parameters made once per process,
each frontend's numpy batch, and the JAX-vs-port decode loop.

Weights are made by JAX ``lm_init`` and bridged as numpy.  In float32 the
two packages differ only in f32 sum order, so logits agree within
``LOGIT_TOL`` and posit8 codes and scales exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_bridge import jax_to_numpy
from repro.configs import get_config as jget
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import transformer as jT
from repro.models import zoo as jzoo
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.kernels.ops import PackedTensor
from repro_torch.models import zoo

NEW_ARCHS = ["gemma-2b", "deepseek-67b", "command-r-plus-104b",
             "musicgen-medium", "qwen2-vl-7b"]
LOGIT_TOL = 1e-5
B, S, STEPS = 2, 12, 4


def cfgs(arch):
    """(JAX, port) reduced configs of ``arch`` in float32."""
    return (dataclasses.replace(jget(arch).reduced(), dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


def tree(x):
    """A JAX tree bridged to the port's tensors on the CPU."""
    return params_from_numpy(jax_to_numpy(x), device="cpu")


def batch(cfg, seed=0, b=B, s=S):
    """The numpy batch of a config's frontend: tokens, plus patch
    embeddings over the first ``n_patches`` (vision); frame embeddings in
    place of tokens (audio).  Embeddings x 0.02, as ``TokenStream``
    draws them."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frame_embeds": (rng.standard_normal((b, s, cfg.d_model))
                                 * 0.02).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = (rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in b.items()}


_PARAMS = {}


def params(arch):
    """JAX ``lm_init`` of the reduced float32 ``arch`` (made once)."""
    if arch not in _PARAMS:
        _PARAMS[arch] = jT.lm_init(jax.random.PRNGKey(0), cfgs(arch)[0])
    return _PARAMS[arch]


def bits(x) -> np.ndarray:
    """Codes as numpy; bf16 values as their 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def leaves(t, path=""):
    """(path, numpy) of every leaf of a port tree, a packed leaf as its
    words, scales and mask, in sorted key order."""
    if isinstance(t, dict):
        for k in sorted(t):
            yield from leaves(t[k], f"{path}/{k}")
    elif isinstance(t, PackedTensor):
        for f in ("words", "scales", "mask"):
            yield f"{path}.{f}", getattr(t, f).numpy()
    else:
        yield path, t.numpy()


def decode_both(arch, packed: bool, quantized: bool):
    """Prefill with JAX, pad its cache (posit8 under ``quantized``) to
    S + STEPS slots, bridge it, then decode STEPS tokens on each side
    from the same cache and the same (JAX greedy) tokens; ``packed``:
    the paper's mixed policy, packed by JAX (and checked equal to the
    port's own packing).  Returns the per-step (port, JAX) logits and the
    final caches of both."""
    jcfg, cfg = cfgs(arch)
    jp = params(arch)
    if packed:
        jp = jzoo.pack_params(jp, JPolicy.paper_mixed())
        mine = zoo.pack_params(tree(params(arch)),
                               PrecisionPolicy.paper_mixed())
        for (path, a), (_, w) in zip(leaves(mine), leaves(tree(jp))):
            np.testing.assert_array_equal(a, w, err_msg=path)
    tp = tree(jp)
    logits, jcache, _ = jzoo.apply_model(jp, jbatch(batch(jcfg)), jcfg,
                                         mode="prefill")
    if quantized:
        jcache = jzoo.quantize_cache(jcache)
    jcache = JaxEngine(jcfg, jp, max_len=S + STEPS)._pad_cache(jcache, B)
    cache = tree(jcache)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out = []
    for i in range(STEPS):
        want, jcache = jzoo.decode_model(jp, tok, jcfg, jcache,
                                         jnp.int32(S + i))
        got, cache = zoo.decode_model(
            tp, torch.from_numpy(np.array(tok)).long(), cfg, cache, S + i)
        out.append((got.numpy(), np.asarray(want)))
        tok = jnp.argmax(want, axis=-1).astype(jnp.int32)
    return out, cache, jcache


def check_decode(arch, packed: bool, quantized: bool):
    """``decode_both`` held to the tolerance: logits of every step within
    ``LOGIT_TOL``; a posit8 cache's codes and scales exactly JAX's; a
    bf16 cache equal wherever a row rounds alike (each side writes its
    own k/v, f32 sums in another order)."""
    steps, cache, jcache = decode_both(arch, packed, quantized)
    for got, want in steps:
        np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    keys = ("k_codes", "v_codes", "k_scale", "v_scale") if quantized \
        else ("k", "v")
    assert sorted(cache) == sorted(keys)
    for key in keys:
        if quantized:
            np.testing.assert_array_equal(bits(cache[key]),
                                          bits(jcache[key]), err_msg=key)
        else:
            same = (bits(cache[key]) == bits(jcache[key])).all(-1)
            assert same.mean() > 0.9, key
