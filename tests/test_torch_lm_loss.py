"""The port's differentiable LM forward against the JAX package, on the
CPU: ``lm_loss`` (loss, ce, MoE aux) and every gradient leaf for the
dense, MoE, recurrent (rwkv6) and hybrid (jamba) families, with and
without the paper's mixed QAT policy; the three remat modes; the
recurrent scans' chunking; the QAT plane against the serving plane.

Float32 reduced configs at seq 64, so attention runs its online softmax
over two KV chunks (``seq_chunk`` 32) and the Mamba / RWKV scans over
eight ``ssm_chunk`` chunks, forward and backward.  Losses within
``REL``; a gradient leaf within ``REL`` of its largest magnitude
(float32 sums in another order).  Exact: remat none == full == dots,
the forward at ``ssm_chunk`` 8 == at 64, ``quantize_params_fake``, and
each packed leaf's ``to_dense`` against the fake-quantized leaf."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import jax_to_numpy, one_torch_thread  # noqa: E402,F401
from repro.configs import get_config as jget  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.data import TokenStream as JStream  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import (PrecisionPolicy,  # noqa: E402
                                     flatten_with_paths)
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.kernels.ops import PackedTensor, to_dense  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.train.loop import grads_of  # noqa: E402

REL = 1e-5
ARCHS = {"dense": "qwen2-0.5b", "moe": "kimi-k2-1t-a32b",
         "ssm": "rwkv6-1.6b", "hybrid": "jamba-v0.1-52b"}


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jget(arch).reduced(), dtype="float32", **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **kw)
    return jcfg, cfg


def _params(jcfg):
    jp = jzoo.init_model(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax_to_numpy(jp), "cpu")


def _batch(cfg, seq=64, batch=4):
    kw = dict(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=1)
    return JStream(**kw).next_batch(), \
        TokenStream(device="cpu", **kw).next_batch()


@pytest.mark.parametrize("qat", [False, True], ids=["fp32", "paper_mixed"])
@pytest.mark.parametrize("family", sorted(ARCHS))
def test_lm_loss_and_grads_match_reference(family, qat):
    jcfg, cfg = _cfgs(ARCHS[family])
    jp, p = _params(jcfg)
    jb, b = _batch(cfg)
    jpol = JPolicy.paper_mixed() if qat else None
    pol = PrecisionPolicy.paper_mixed() if qat else None
    (jl, (jce, jaux)), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jzoo.loss_fn(p, b, jcfg, policy=jpol),
        has_aux=True))(jp, jb)
    g, loss, ce, aux = grads_of(p, b, cfg, pol)
    for got, want in ((loss, jl), (ce, jce), (aux, jaux)):
        assert abs(float(got) - float(want)) <= REL * max(abs(float(want)),
                                                          1e-6)
    if family in ("moe", "hybrid"):
        assert float(aux) > 0
    want = dict(flatten_with_paths(jax_to_numpy(jg)))
    got = flatten_with_paths(g)
    assert [k for k, _ in got] == sorted(want)
    for path, t in got:
        assert torch.isfinite(t).all(), path
        w = want[path]
        err = np.abs(t.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= REL, (path, err)


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_remat_modes_bitwise(family):
    """remat none == full == dots: the same grads bit for bit (MoE:
    float32; the others: the bf16 config under the QAT policy, the
    recurrent scans checkpointed per chunk under full and dots)."""
    arch = ARCHS[family]
    cfg = get_config(arch).reduced()
    if family == "moe":
        cfg = dataclasses.replace(cfg, dtype="float32")
    pol = PrecisionPolicy.paper_mixed() if family != "moe" else None
    p = zoo.init_model(cfg, torch.Generator().manual_seed(0))
    _, b = _batch(cfg, batch=2)
    out = {}
    for remat in ("none", "full", "dots"):
        g, loss, _, _ = grads_of(p, b, dataclasses.replace(cfg, remat=remat),
                                 pol)
        out[remat] = (loss, flatten_with_paths(g))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for (path, a), (_, w) in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, w), (remat, path)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_ssm_chunk_does_not_change_the_forward(family):
    """The scans' chunks only place the checkpoints: the differentiated
    forward at ``ssm_chunk`` 8 (eight checkpointed chunks) equals the one
    at 64 (one chunk) and the one with no remat, bit for bit."""
    _, cfg = _cfgs(ARCHS[family])
    p = zoo.init_model(cfg, torch.Generator().manual_seed(0))
    for _, t in flatten_with_paths(p):
        t.requires_grad_(True)
    _, b = _batch(cfg, batch=2)
    out = [zoo.apply_model(p, b, dataclasses.replace(cfg, **kw),
                           mode="train")[0]
           for kw in (dict(ssm_chunk=8, remat="full"),
                      dict(ssm_chunk=64, remat="full"),
                      dict(ssm_chunk=8, remat="none"))]
    assert out[0].requires_grad
    for o in out[1:]:
        assert torch.equal(o, out[0])


def test_train_mode_builds_no_cache_and_rejects_other_uses():
    _, cfg = _cfgs("qwen2-0.5b")
    p = zoo.init_model(cfg, torch.Generator().manual_seed(0))
    _, b = _batch(cfg, seq=16, batch=2)
    logits, cache, aux = zoo.apply_model(p, b, cfg, mode="train",
                                         with_aux=True)
    assert cache is None and logits.shape == (2, 16, cfg.vocab)
    assert float(aux) == 0.0
    with pytest.raises(ValueError, match="mode='train' only"):
        zoo.apply_model(p, b, cfg, policy=PrecisionPolicy.paper_mixed())
    with pytest.raises(ValueError, match="remat"):
        zoo.loss_fn(p, b, dataclasses.replace(cfg, remat="some"))


@pytest.mark.parametrize("group", [None, 32])
def test_quantize_params_fake_matches_reference(group):
    jcfg, cfg = _cfgs("kimi-k2-1t-a32b")
    jp, p = _params(jcfg)
    jpol = JPolicy.paper_mixed()
    pol = PrecisionPolicy.paper_mixed()
    jpol.group_size = pol.group_size = group
    want = dict(flatten_with_paths(jax_to_numpy(
        jax.jit(lambda p: jzoo.quantize_params_fake(p, jpol))(jp))))
    with torch.no_grad():
        got = flatten_with_paths(zoo.quantize_params_fake(p, pol))
    for path, t in got:
        np.testing.assert_array_equal(t.numpy(), want[path], err_msg=path)
    assert zoo.param_count(p) == jzoo.param_count(jp)
    assert zoo.packed_bytes(p, pol) == jzoo.packed_bytes(jp, jpol)


def test_packed_leaves_equal_fake_quant():
    """With the policy's scale groups set, the serving plane's packed
    leaves decode bitwise to the QAT plane's fake-quantized leaves."""
    cfg = get_config("qwen2-0.5b").reduced()
    p = zoo.init_model(cfg, torch.Generator().manual_seed(0))
    pol = PrecisionPolicy(rules=[("*attn/wq*", "posit16_1"),
                                 ("*attn*", "posit8_0")], default="fp4",
                          group_size=32)
    with torch.no_grad():
        fake = dict(flatten_with_paths(zoo.quantize_params_fake(p, pol)))
        packed = zoo.pack_params(p, pol)
    n = 0
    for path, node in flatten_with_paths(packed, keep_packed=True):
        if isinstance(node, PackedTensor):
            np.testing.assert_array_equal(
                to_dense(node, torch.float32).numpy(), fake[path].numpy(),
                err_msg=path)
            n += 1
    assert n == 7
