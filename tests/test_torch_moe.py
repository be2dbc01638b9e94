"""MoE of the PyTorch port (``repro_torch.models.moe``) against the JAX
package: ``moe_apply`` on reduced arctic-480b (dense residual),
kimi-k2-1t-a32b (a shared expert) and jamba-v0.1-52b (an MoE sub-block of
a hybrid group) in float32 (outputs within 1e-5 relative, aux loss within
1e-6), a capacity of 1.0 that drops pairs (the same (token, expert) pairs
kept), exact router ties (the lower expert wins), the packed expert
stacks (words and scales bitwise), and whole-model prefill logits of the
MoE families.  Parameters are JAX's, handed across as numpy."""

import dataclasses
import math
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
from repro.models import moe as jM  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy  # noqa: E402
from repro_torch.kernels.ops import PackedTensor, dequant, to_dense  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

ARCHS = ["arctic-480b", "kimi-k2-1t-a32b", "jamba-v0.1-52b"]


def _cfgs(name, **kw):
    kw = {"dtype": "float32", **kw}
    return (dataclasses.replace(jax_get_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


def _moe_params(jparams, cfg):
    sub = jparams["groups"]["b1"] if cfg.family == "hybrid" \
        else jparams["layers"]
    return jax.tree.map(lambda t: t[0], sub["moe"])


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in ARCHS:
        jc, tc = _cfgs(name)
        jp = jT.lm_init(jax.random.PRNGKey(0), jc)
        out[name] = (jc, tc, jp, params_from_numpy(jax_to_numpy(jp),
                                                   device="cpu"))
    return out


def _x(seed, cfg, b=2, s=8):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, rtol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * scale)


@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_matches_jax(models, name):
    jc, tc, jp, tp = models[name]
    jm, tm = _moe_params(jp, jc), _moe_params(tp, tc)
    x = _x(1, tc)
    yj, aj = jM.moe_apply(jm, jnp.asarray(x), jc)
    yt, at = M.moe_apply(tm, torch.from_numpy(x), tc)
    _close(yt, yj, 1e-5)
    assert abs(float(at) - float(aj)) <= 1e-6 * max(abs(float(aj)), 1.0)


def _jax_kept(jm, x, cfg):
    """The (token, expert) pairs the reference's dispatch keeps, by its
    own lines (``repro.models.moe.moe_apply``'s ``dispatch``)."""
    e, k = cfg.n_experts, cfg.experts_per_tok
    n = x.shape[0] * x.shape[1]
    xt = jnp.asarray(x).reshape(1, n, -1)
    probs = jax.nn.softmax(jnp.einsum("gnd,de->gne", xt, jm["router"]["w"]),
                           -1)
    _, top_i = jax.lax.top_k(probs, k)
    nk = n * k
    cap = max(int(math.ceil(nk / e * cfg.capacity_factor)), 4)
    flat_e = top_i[0].reshape(nk)
    toks0 = jnp.repeat(jnp.arange(n, dtype=jnp.int32), k)
    order = jnp.argsort(flat_e)
    es, toks = flat_e[order], toks0[order]
    counts = jnp.bincount(es, length=e)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(nk, dtype=jnp.int32) - starts[es].astype(jnp.int32)
    keep = np.asarray(pos < cap)
    return {(int(t), int(ex)) for t, ex, kp in
            zip(np.asarray(toks), np.asarray(es), keep) if kp}, nk


def test_capacity_drops_keep_the_same_pairs(models):
    name = "arctic-480b"
    jc, tc, jp, tp = models[name]
    jc, tc = (dataclasses.replace(c, capacity_factor=1.0) for c in (jc, tc))
    jm, tm = _moe_params(jp, jc), _moe_params(tp, tc)
    x = _x(5, tc, b=2, s=16)
    want, nk = _jax_kept(jm, x, jc)
    xt = torch.from_numpy(x).reshape(1, -1, tc.d_model)
    _, _, top_i = M._route(tm, xt, tc.experts_per_tok)
    cap = M._capacity(nk, tc.n_experts, tc.capacity_factor)
    dst, order = M._dispatch(top_i[0], tc.n_experts, cap)
    es = top_i[0].reshape(-1)[order]
    got = {(int(o) // tc.experts_per_tok, int(ex))
           for o, ex, d in zip(order, es, dst) if int(d) < tc.n_experts * cap}
    assert len(got) < nk, "the case must drop pairs"
    assert got == want
    yj, _ = jM.moe_apply(jm, jnp.asarray(x), jc)
    yt, _ = M.moe_apply(tm, torch.from_numpy(x), tc)
    _close(yt, yj, 1e-5)


@pytest.mark.parametrize("tie", ["all", "pairs"])
def test_router_ties_pick_the_lower_expert(models, tie):
    """Exact ties in the router's probabilities go to the lower expert,
    as ``lax.top_k`` sends them: a zero router (all four tie: experts 0
    and 1 for every token), and a router whose columns 2 and 3 repeat 0
    and 1 (each token's top-2 is one tied pair, lower expert first)."""
    jc, tc, jp, tp = models["arctic-480b"]
    w = np.asarray(_moe_params(jp, jc)["router"]["w"]).copy()
    if tie == "all":
        w[:] = 0.0
    else:
        w[:, 2], w[:, 3] = w[:, 0], w[:, 1]
    x = _x(6, tc)
    xt = x.reshape(1, -1, tc.d_model)
    probs = jax.nn.softmax(jnp.einsum("gnd,de->gne", jnp.asarray(xt),
                                      jnp.asarray(w)), -1)
    _, want = jax.lax.top_k(probs, 2)
    _, _, got = M._route({"router": {"w": torch.from_numpy(w)}},
                         torch.from_numpy(xt), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = got.numpy().reshape(-1, 2)
    if tie == "all":
        assert (got == [0, 1]).all()
    else:
        assert ((got[:, 1] - got[:, 0]) == 2).all()


@pytest.mark.parametrize("group", [None, 32])
def test_pack_params_experts_bitwise(models, group):
    jc, tc, jp, tp = models["jamba-v0.1-52b"]
    jpol, tpol = JaxPolicy.paper_mixed(), PrecisionPolicy.paper_mixed()
    jpol.group_size = tpol.group_size = group

    def moe_block(tree):      # the same paths as in the whole tree
        return {"groups": {"b1": {"moe": tree["groups"]["b1"]["moe"]}}}

    jpk = jzoo.pack_params(moe_block(jp), jpol)
    tpk = zoo.pack_params(moe_block(tp), tpol)
    n = 0
    for leaf in ("gate", "up", "down"):
        jt = jpk["groups"]["b1"]["moe"]["experts"][leaf]
        tt = tpk["groups"]["b1"]["moe"]["experts"][leaf]
        assert isinstance(tt, PackedTensor) and tt.words.dim() == 4
        assert (tt.shape, tt.group, tt.spec.name) == \
            (tuple(jt.shape), jt.group, jt.spec.name)
        np.testing.assert_array_equal(
            tt.words.numpy(), np.asarray(jt.words).view(np.int32))
        np.testing.assert_array_equal(tt.scales.numpy(),
                                      np.asarray(jt.scales))
        np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))
        # one expert slice through the dequant kernel's plain version ==
        # the stack's to_dense in the compute dtype, bitwise
        for dt in (torch.bfloat16, torch.float32):
            whole = to_dense(tt[0], dt)
            for e in range(tc.n_experts):
                assert torch.equal(dequant(tt[0][e], dt), whole[e])
        n += 1
    assert n == 3
    # the router stays dense ("*router*" keeps f32), as in the reference
    assert not isinstance(tpk["groups"]["b1"]["moe"]["router"]["w"],
                          PackedTensor)


@pytest.mark.parametrize("name", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_moe_model_prefill_logits(name):
    """Whole-model prefill of the MoE family in float32 (kimi-k2 at its
    own head width, 112) within 1e-5 of JAX, with the aux loss."""
    kw = {"head_dim": 112} if name.startswith("kimi") else {}
    jc, tc = _cfgs(name, **kw)
    jp = jT.lm_init(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax_to_numpy(jp), device="cpu")
    toks = np.random.default_rng(2).integers(0, tc.vocab, (2, 10))
    want, _, aux_j = jT.lm_apply(jp, {"tokens": jnp.asarray(toks)}, jc,
                                 mode="prefill")
    got, cache, aux_t = T.lm_apply(tp, {"tokens": torch.from_numpy(toks)},
                                   tc, with_aux=True)
    _close(got, want, 1e-5)
    assert abs(float(aux_t) - float(aux_j)) <= 1e-6 * max(float(aux_j), 1.0)
    assert cache["k"].shape == (tc.n_layers, 2, 10, tc.n_kv_heads, 112 if kw
                                else tc.resolved_head_dim)


def test_moe_continuous_pages_context_equals_jax():
    """A pure-MoE model (reduced kimi-k2, float32, capacity 8.0) through
    the continuous engine on the pages context with the prefix cache --
    MoE paging is the KV page kind -- gives JAX's ``ContinuousEngine``
    tokens on the same trace."""
    from repro.serve import ContinuousEngine as JaxContinuous
    from repro_torch.serve.engine import ContinuousEngine
    jc, tc = _cfgs("kimi-k2-1t-a32b", capacity_factor=8.0)
    jp = jT.lm_init(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax_to_numpy(jp), device="cpu")
    rng = np.random.default_rng(4)
    pre = rng.integers(0, tc.vocab, 16)
    reqs = [(np.concatenate([pre, rng.integers(0, tc.vocab, n)]), g)
            for n, g in ((5, 6), (9, 4), (3, 7))]
    kw = dict(n_pages=12, page_size=16, max_batch=4, max_len=48,
              prefill_chunk_tokens=16, prefix_cache=True, decode_steps=2)

    def run(eng):          # the later two arrive once the first is cached
        rids = [eng.submit(reqs[0][0].astype(np.int32), reqs[0][1])]
        for _ in range(3):
            eng.step()
        rids += [eng.submit(p.astype(np.int32), g) for p, g in reqs[1:]]
        out = eng.run()
        return [np.asarray(out[r]) for r in rids], eng

    want, jeng = run(JaxContinuous(jc, jp, **kw))
    got, teng = run(ContinuousEngine(tc, tp, device="cpu", **kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert teng.scheduler.prefix.hits == jeng.scheduler.prefix.hits > 0
