"""Recurrent mixers of the PyTorch port (``repro_torch.models.ssm``)
against the JAX package: Mamba prefill and decode and the RWKV-6 time and
channel mixes on ``rwkv6-1.6b`` / ``jamba-v0.1-52b`` ``.reduced()`` in
float32 (outputs and final states within 1e-5 relative), prefill then
decode against one longer prefill inside the port, and the posit8 state
plane (``quantize_state`` / ``dequantize_state`` / ``requantize_state``)
code for code and scale for scale, including a leaf whose last dim the
group does not divide.  Parameters are JAX's, handed across as numpy."""

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
from repro.models import ssm as jS  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402

RTOL = 1e-5


def _cfgs(name):
    jc = dataclasses.replace(jax_get_config(name).reduced(), dtype="float32")
    tc = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    return jc, tc


@pytest.fixture(scope="module")
def rwkv():
    jc, tc = _cfgs("rwkv6-1.6b")
    jp = jax.tree.map(lambda t: t[0],
                      jT.lm_init(jax.random.PRNGKey(0), jc)["layers"]["rwkv"])
    return jc, tc, jp, params_from_numpy(jax_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def mamba():
    jc, tc = _cfgs("jamba-v0.1-52b")
    jp = jax.tree.map(lambda t: t[0], jT.lm_init(
        jax.random.PRNGKey(0), jc)["groups"]["b0"]["mamba"])
    return jc, tc, jp, params_from_numpy(jax_to_numpy(jp), device="cpu")


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, what):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def _state(tree, rng, scale):
    return {k: _rand(rng, v.shape, scale) for k, v in tree.items()}


def _both(state):
    return ({k: jnp.asarray(v) for k, v in state.items()},
            {k: torch.from_numpy(v) for k, v in state.items()})


def _check_tree(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        _close(got[k], want[k], f"{what}/{k}")


@pytest.mark.parametrize("s", [1, 16])
def test_mamba_apply_matches_jax(mamba, s):
    jc, tc, jp, tp = mamba
    rng = np.random.default_rng(s)
    x = _rand(rng, (2, s, tc.d_model))
    st_j, st_t = _both(_state(jS.mamba_state_init(jc, 2), rng, 0.5))
    yj, nj = jS.mamba_apply(jp, jnp.asarray(x), jc, st_j)
    yt, nt = S.mamba_apply(tp, torch.from_numpy(x), tc, st_t)
    _close(yt, yj, "mamba out")
    _check_tree(nt, nj, "mamba state")
    yj, nj = jS.mamba_decode(jp, jnp.asarray(x[:, :1]), jc, st_j)
    yt, nt = S.mamba_decode(tp, torch.from_numpy(x[:, :1]), tc, st_t)
    _close(yt, yj, "mamba decode out")
    _check_tree(nt, nj, "mamba decode state")


@pytest.mark.parametrize("s", [1, 16])
def test_rwkv_mixes_match_jax(rwkv, s):
    jc, tc, jp, tp = rwkv
    rng = np.random.default_rng(10 + s)
    x = _rand(rng, (2, s, tc.d_model))
    st_j, st_t = _both(_state(jS.rwkv_state_init(jc, 2), rng, 0.5))
    yj, nj = jS.rwkv_time_mix(jp, jnp.asarray(x), jc, st_j)
    yt, nt = S.rwkv_time_mix(tp, torch.from_numpy(x), tc, st_t)
    _close(yt, yj, "time mix out")
    _check_tree(nt, nj, "time mix state")
    yj, nj = jS.rwkv_channel_mix(jp, jnp.asarray(x), jc, nj)
    yt, nt = S.rwkv_channel_mix(tp, torch.from_numpy(x), tc, nt)
    _close(yt, yj, "channel mix out")
    _check_tree(nt, nj, "channel mix state")


def test_softplus_is_logaddexp_everywhere():
    x = np.array([-80.0, -20.5, -1.0, 0.0, 0.5, 19.9, 20.1, 35.0, 90.0],
                 np.float32)
    np.testing.assert_allclose(S.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6)


@pytest.mark.parametrize("family", ["rwkv", "mamba"])
def test_prefill_then_decode_is_a_longer_prefill(rwkv, mamba, family):
    """Within the port: 12 tokens then 4 one-token decode steps give the
    outputs and state of one 16-token prefill."""
    _, tc, _, tp = rwkv if family == "rwkv" else mamba
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_rand(rng, (2, 16, tc.d_model)))

    def run(chunks):
        st = (S.rwkv_state_init(tc, 2) if family == "rwkv"
              else S.mamba_state_init(tc, 2))
        ys = []
        for a, b in chunks:
            if family == "rwkv":
                y, st = S.rwkv_time_mix(tp, x[:, a:b], tc, st)
                y2, st = S.rwkv_channel_mix(tp, x[:, a:b], tc, st)
                y = y + y2
            elif b - a == 1:
                y, st = S.mamba_decode(tp, x[:, a:b], tc, st)
            else:
                y, st = S.mamba_apply(tp, x[:, a:b], tc, st)
            ys.append(y)
        return torch.cat(ys, 1), st

    y1, s1 = run([(0, 16)])
    y2, s2 = run([(0, 12), (12, 13), (13, 14), (14, 15), (15, 16)])
    _close(y2, y1.numpy(), "outputs")
    _check_tree(s2, {k: v.numpy() for k, v in s1.items()}, "state")


def _q_equal(tq, jq, what):
    assert sorted(tq) == sorted(jq), (sorted(tq), sorted(jq))
    for k in jq:
        if isinstance(jq[k], dict):
            _q_equal(tq[k], jq[k], f"{what}/{k}")
            continue
        want = np.asarray(jq[k])
        got = tq[k]
        if k.endswith("_scale"):
            got = got.float().numpy()
            want = want.astype(np.float32)
        else:
            got = got.numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{what}/{k}")


@pytest.mark.parametrize("group", [None, 16])
def test_quantize_state_bitwise(rwkv, mamba, group):
    """Codes and scales equal JAX's exactly for the rwkv and mamba state
    trees (nested, as in a hybrid group); at group 16 the mamba
    ``h`` (last dim 8) degrades to one scale per row, and requantizing
    keeps each leaf's own group."""
    rng = np.random.default_rng(3 if group is None else group)
    tree = {"b0": _state(jS.mamba_state_init(mamba[0], 2), rng, 0.7),
            "tm": _state(jS.rwkv_state_init(rwkv[0], 2), rng, 3.0)}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
             for k, v in tree.items()}
    jq = jS.quantize_state(jtree, group)
    tq = S.quantize_state(ttree, group)
    _q_equal(tq, jq, "quantize")
    assert list(tq["b0"]) == sorted(tq["b0"])
    if group == 16:
        assert tq["b0"]["h_scale"].shape[-1] == 1
    _q_equal(S.dequantize_state(tq),
             jax.tree.map(np.asarray, jS.dequantize_state(jq)), "dequantize")
    # a new state through the old layout
    tree2 = {k: {kk: v * 1.5 + 0.25 for kk, v in sub.items()}
             for k, sub in tree.items()}
    jr = jS.requantize_state(jax.tree.map(jnp.asarray, tree2), jq)
    tr = S.requantize_state({k: {kk: torch.from_numpy(v) for kk, v in
                                 sub.items()} for k, sub in tree2.items()},
                            tq)
    _q_equal(tr, jr, "requantize")
    for k in tq:
        for kk in tq[k]:
            assert tr[k][kk].shape == tq[k][kk].shape
