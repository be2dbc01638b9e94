"""The accuracy plane of the PyTorch port (the paper's Fig. 5-8 and
model-size analogues) against the JAX package, on the CPU.

Same inputs from numpy seeds, JAX trees bridged as numpy.  Exact where
the arithmetic is the same op for op: ``fake_quant`` values and STE
gradients, ``pact_quantize``, ``quantize_tree``, ``model_bytes`` /
``average_bits``, the adaptive assignment, posit8 moment codes after one
step, ``VIOStream`` batches, the model-size rows.  Within ``REL`` of the
largest magnitude of each compared tensor where a sum runs in another
order (float32): sensitivity scores, perception forwards, losses and
gradients, AdamW parameters after five steps."""

import io
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import jax_to_numpy, one_torch_thread  # noqa: E402,F401
from repro.core import formats as jfmt  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.qat import quantize_tree as jquantize_tree  # noqa: E402
from repro.core.sensitivity import assign_layer_adaptive as jassign  # noqa: E402
from repro.core.sensitivity import layer_sensitivity as jsens  # noqa: E402
from repro.data.vio_data import VIOStream as JStream  # noqa: E402
from repro.models import perception as jP  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy  # noqa: E402
from repro_torch.core.qat import quantize_tree  # noqa: E402
from repro_torch.core.sensitivity import (assign_layer_adaptive,  # noqa: E402
                                          layer_sensitivity,
                                          sensitivity_report)
from repro_torch.data.vio_data import VIOStream  # noqa: E402
from repro_torch.models import perception as P  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

REL = 1e-5        # float32 sums in another order
SWEEP = ["fp32", "posit16_1", "posit8_0", "fp8_e4m3", "fp4", "posit4_1"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got.astype(np.float64) - want)) if got.size else 0.0
    tol = rel * max(np.max(np.abs(want)) if want.size else 0.0, 1e-30)
    assert err <= tol, f"{what}: max |diff| {err:.3e} > {tol:.3e}"


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


def _bridge(tree):
    return params_from_numpy(jax_to_numpy(tree), device="cpu")



# ---------------------------------------------------------------------------
# fake_quant and PACT
# ---------------------------------------------------------------------------

def _x(seed, shape=(64, 48)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * rng.uniform(0.1, 3.0, size=shape[-1])
            ).astype(np.float32)


@pytest.mark.parametrize("name", SWEEP)
@pytest.mark.parametrize("group", [None, 32])
def test_fake_quant_bitwise_and_ste_grads(name, group):
    """Values and gradients through the clipped STE equal JAX's bit for
    bit, per tensor and with K-groups of 32."""
    x = _x(1)
    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    spec_j, spec_t = jfmt.format_by_name(name), tfmt.format_by_name(name)
    want = jq.fake_quant(spec_j, jnp.asarray(x), group_size=group)
    want_g = jax.grad(lambda a: jnp.sum(jq.fake_quant(
        spec_j, a, group_size=group) * w))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = tq.fake_quant(spec_t, xt, group_size=group)
    (got_g,) = torch.autograd.grad(torch.sum(got * _t(w)), xt)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))


@pytest.mark.parametrize("name", ["posit8_0", "fp4", "posit4_1"])
def test_fake_quant_clips_the_gradient_outside_the_range(name):
    """An explicit small scale puts part of x outside the representable
    range: the STE passes nothing there, and the scale gets a zero
    gradient, as in the reference."""
    x = _x(3)
    w = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    scale = np.float32(0.05)
    spec_j, spec_t = jfmt.format_by_name(name), tfmt.format_by_name(name)
    want_g = jax.grad(lambda a, s: jnp.sum(jq.fake_quant(spec_j, a, s) * w),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(scale))
    xt = _t(x).requires_grad_(True)
    st = torch.tensor(scale).requires_grad_(True)
    gx, gs = torch.autograd.grad(torch.sum(tq.fake_quant(spec_t, xt, st)
                                           * _t(w)), (xt, st))
    assert (np.asarray(want_g[0]) == 0).any()
    np.testing.assert_array_equal(gx.numpy(), np.asarray(want_g[0]))
    assert float(gs) == float(want_g[1]) == 0.0


@pytest.mark.parametrize("n", [2, 4, 8])
def test_pact_quantize_values_and_grads(n):
    """PACT values bitwise; grads of x and alpha (a sum) within 1e-6."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(32, 40)) * 2).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    alpha = np.float32(1.5)

    def jf(a, al):
        return jnp.sum(jq.pact_quantize(a, al, n) * w)

    want = jq.pact_quantize(jnp.asarray(x), jnp.asarray(alpha), n)
    wx, wa = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(alpha))
    xt = _t(x).requires_grad_(True)
    at = torch.tensor(alpha).requires_grad_(True)
    got = tq.pact_quantize(xt, at, n)
    gx, ga = torch.autograd.grad(torch.sum(got * _t(w)), (xt, at))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    _close(gx, wx, 1e-6, "d/dx")
    _close(ga, wa, 1e-6, "d/dalpha")
    np.testing.assert_array_equal(
        tq.pact(_t(x), torch.tensor(alpha)).numpy(),
        np.asarray(jq.pact(jnp.asarray(x), jnp.asarray(alpha))))


@pytest.mark.parametrize("n", [4, 8])
def test_entropy_uniform_quantize_matches(n):
    x = _x(6)
    want = jq.uniform_quantize(jnp.asarray(x), n, -1.0, 1.0)
    got = tq.uniform_quantize(_t(x), n, -1.0, 1.0)
    _close(got, want, 1e-6, "uniform_quantize")
    _close(tq.entropy_scale(_t(x), n), jq.entropy_scale(jnp.asarray(x), n),
           1e-6, "entropy_scale")
    for group in (None, 16):
        _close(tq.group_scales(tfmt.FP4, _t(x), group, "entropy"),
               jq.group_scales(jfmt.FP4, jnp.asarray(x), group, "entropy"),
               1e-6, f"entropy group {group}")


@pytest.mark.parametrize("name", ["posit8_0", "fp4", "fp8_e4m3"])
def test_fake_quant_stochastic_rounds_to_a_neighbour_unbiased(name):
    """Every output is one of the two grid neighbours of x / scale, and
    the mean of 4096 draws lies within 4 sigma of x (the draws are the
    port's own: JAX's PRNG stream cannot be reproduced)."""
    spec = tfmt.format_by_name(name)
    x = torch.from_numpy(_x(7, (4, 64)))
    scale = tq.format_scale(spec, x, "absmax_po2")
    vals = torch.from_numpy(np.unique(
        tfmt._encode_tables(spec)[0].astype(np.float32)))
    y = x / scale
    hi_i = torch.clamp(torch.searchsorted(vals, y), max=len(vals) - 1)
    lo_i = torch.clamp(hi_i - 1, min=0)
    gen = torch.Generator().manual_seed(0)
    # 4096 independent draws in one call: x repeated, x's own scale
    draws = tq.fake_quant_stochastic(spec, x.expand(4096, *x.shape), gen,
                                     scale)
    q = draws / scale
    neighbour = (q == vals[lo_i]) | (q == vals[hi_i])
    assert bool(neighbour.all())
    gap = (vals[hi_i] - vals[lo_i]) * scale
    p = torch.where(gap > 0, (x - vals[lo_i] * scale) / gap, 0.0)
    sigma = torch.sqrt(p * (1 - p) / 4096) * gap
    assert bool(((draws.mean(0) - x).abs() <= 4 * sigma + 1e-7).all())


# ---------------------------------------------------------------------------
# quantize_tree and the policy's memory model
# ---------------------------------------------------------------------------

def _policies():
    grouped = JPolicy.paper_mixed()
    grouped.group_size = 32
    tgrouped = PrecisionPolicy.paper_mixed()
    tgrouped.group_size = 32
    out = [(JPolicy.paper_mixed(), PrecisionPolicy.paper_mixed()),
           (grouped, tgrouped)]
    out += [(JPolicy.uniform(n), PrecisionPolicy.uniform(n)) for n in SWEEP]
    return out


@pytest.fixture(scope="module")
def jtrees():
    return {"classifier": jP.classifier_init(jax.random.PRNGKey(1), width=8),
            "vio": jP.vio_init(jax.random.PRNGKey(2), feat_dim=64,
                               width=64),
            "gaze": jP.gaze_init(jax.random.PRNGKey(3), width=64)}


@pytest.mark.parametrize("model", ["classifier", "vio", "gaze"])
def test_quantize_tree_equals_jax(jtrees, model):
    jtree = jtrees[model]
    ttree = _bridge(jtree)
    for jpol, tpol in _policies():
        want = dict(_leaves(jquantize_tree(jtree, jpol)))
        got = dict(_leaves(quantize_tree(ttree, tpol)))
        assert got.keys() == want.keys()
        for path in want:
            np.testing.assert_array_equal(got[path].numpy(),
                                          np.asarray(want[path]),
                                          err_msg=f"{jpol.default} {path}")


@pytest.mark.parametrize("feat,width", [(1024, 1024), (64, 48)])
def test_model_bytes_and_average_bits_equal_jax(feat, width):
    """At bench_model_size's widths and a small one, every policy of the
    table (and the grouped paper mixture) gives the reference's bytes and
    bits exactly."""
    jtree = jax.eval_shape(lambda: jP.vio_init(jax.random.PRNGKey(0),
                                               feat_dim=feat, width=width))
    ttree = P.vio_init(torch.Generator().manual_seed(0), feat_dim=feat,
                       width=width)
    for (_, a), (_, b) in zip(_leaves(jtree), _leaves(ttree)):
        assert tuple(a.shape) == tuple(b.shape)
    for jpol, tpol in _policies():
        assert tpol.model_bytes(ttree) == jpol.model_bytes(jtree)
        assert tpol.average_bits(ttree) == jpol.average_bits(jtree)


# ---------------------------------------------------------------------------
# layer sensitivity and the adaptive assignment
# ---------------------------------------------------------------------------

def test_sensitivity_and_adaptive_assignment_equal_jax():
    """Scores within REL; on this seeded case neighbouring scores are
    further apart than that, and the assignment is the reference's."""
    jparams = jP.vio_init(jax.random.PRNGKey(4), feat_dim=64, width=64)
    stream = JStream(batch=32, feat_dim=64)
    batch = {k: jnp.asarray(v) for k, v in stream.next_batch().items()}
    jgrads = jax.grad(lambda p: jP.vio_loss(p, batch)[0])(jparams)
    want = jsens(jparams, jgrads)
    got = layer_sensitivity(_bridge(jparams), _bridge(jgrads))
    assert got.keys() == want.keys() and len(want) == 6
    for path in want:
        assert abs(got[path] - want[path]) <= REL * abs(want[path]), path
    scores = sorted(want.values())
    assert all(b - a > 10 * REL * b for a, b in zip(scores, scores[1:]))
    for target in (6.0, 10.0, 14.0):
        jpol = jassign(jparams, jgrads, target_avg_bits=target)
        tpol = assign_layer_adaptive(_bridge(jparams), _bridge(jgrads),
                                     target_avg_bits=target)
        assert tpol.rules == [tuple(r) for r in jpol.rules]
        assert tpol.default == jpol.default
    assert "ascending" in sensitivity_report(_bridge(jparams),
                                             _bridge(jgrads))


# ---------------------------------------------------------------------------
# the perception models: forwards, losses, grads
# ---------------------------------------------------------------------------

def _vio_batch(feat):
    return JStream(batch=16, feat_dim=feat, seed=3).next_batch()


def _cls_batch(n=16, side=16):
    rng = np.random.default_rng(8)
    return {"images": rng.normal(size=(n, side, side, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, n).astype(np.int32)}


def _compare_loss_and_grads(jloss, tloss, jparams, batch):
    (wl, wm), wg = jax.value_and_grad(jloss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = _bridge(jparams)
    leaves = dict(_leaves(tparams))
    for t in leaves.values():
        t.requires_grad_(True)
    gl, gm = tloss(tparams, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(gl, list(leaves.values()))
    _close(gl, wl, what="loss")
    for k in wm:
        _close(gm[k], wm[k], what=k)
    for (path, g), (wpath, w) in zip(zip(leaves, grads), _leaves(wg)):
        assert path == wpath
        _close(g, w, what=f"grad {path}")


def test_vio_forward_loss_grads_equal_jax():
    jparams = jP.vio_init(jax.random.PRNGKey(5), feat_dim=64, width=48)
    batch = _vio_batch(64)
    want = jP.vio_apply(jparams, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    got = P.vio_apply(_bridge(jparams), {k: _t(v) for k, v in batch.items()})
    _close(got, want, what="vio_apply")
    _compare_loss_and_grads(jP.vio_loss, P.vio_loss, jparams, batch)


def test_gaze_forward_loss_grads_equal_jax():
    jparams = jP.gaze_init(jax.random.PRNGKey(6), feat_dim=32, width=40)
    rng = np.random.default_rng(9)
    batch = {"f": rng.normal(size=(16, 32)).astype(np.float32),
             "y": rng.normal(size=(16, 2)).astype(np.float32)}

    def jloss(p, b):
        mse = jnp.mean(jnp.square(jP.gaze_apply(p, b["f"]) - b["y"]))
        return mse, {"mse": mse}

    def tloss(p, b):
        mse = torch.mean(torch.square(P.gaze_apply(p, b["f"]) - b["y"]))
        return mse, {"mse": mse}

    _close(P.gaze_apply(_bridge(jparams), _t(batch["f"])),
           jP.gaze_apply(jparams, jnp.asarray(batch["f"])), what="gaze")
    _compare_loss_and_grads(jloss, tloss, jparams, batch)


@pytest.mark.parametrize("side", [16, 15])
def test_classifier_forward_loss_grads_equal_jax(side):
    """16 x 16 (the bench's images: SAME at stride 2 pads (0, 1)) and an
    odd side (15: pads (1, 1), then (0, 1))."""
    jparams = jP.classifier_init(jax.random.PRNGKey(7), width=8)
    batch = _cls_batch(side=side)
    _close(P.classifier_apply(_bridge(jparams), _t(batch["images"])),
           jP.classifier_apply(jparams, jnp.asarray(batch["images"])),
           what="classifier_apply")
    _compare_loss_and_grads(jP.classifier_loss, P.classifier_loss, jparams,
                            batch)


def test_same_pad_is_xla_same():
    assert P._same_pad(16, 3, 2) == (0, 1)
    assert P._same_pad(15, 3, 2) == (1, 1)
    assert P._same_pad(8, 3, 1) == (1, 1)


# ---------------------------------------------------------------------------
# AdamW, schedules, data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moments", ["float32", "bfloat16", "posit8"])
def test_adamw_five_steps_equal_jax(moments):
    """Five steps from one init on the same gradients: parameters within
    REL; after step 1 the posit8 moment codes and scales equal JAX's.
    The gradients are O(1), so every block scale is a power of two
    within 2^+-12: XLA's CPU ``exp2`` is inexact beyond that range (a
    reference-side note in ROADMAP), the port's scales are exact."""
    # blockwise scales (last axis a multiple of 256), per-tensor ones and
    # a vector without weight decay
    rng = np.random.default_rng(11)
    shapes = {"a": {"w": (6, 512)}, "b": {"w": (40, 24), "bias": (24,)},
              "c": {"w": (2, 3, 256)}}
    jparams = {k: {n: jnp.asarray(rng.normal(size=sh).astype(np.float32))
                   for n, sh in v.items()} for k, v in shapes.items()}
    tparams = _bridge(jparams)
    cfg_j = jadamw.OptConfig(moment_dtype=moments)
    cfg_t = tadamw.OptConfig(moment_dtype=moments)
    jst, tst = jadamw.adamw_init(jparams, cfg_j), \
        tadamw.adamw_init(tparams, cfg_t)
    rng = np.random.default_rng(10)
    for step in range(5):
        grads = {p: rng.normal(size=np.shape(a)).astype(np.float32)
                 for p, a in _leaves(jparams)}
        jg = _unflatten(jparams, {p: jnp.asarray(g) for p, g in
                                  grads.items()})
        tg = _unflatten(tparams, {p: _t(g) for p, g in grads.items()})
        jparams, jst = jadamw.adamw_update(jparams, jg, jst, 1e-3, cfg_j)
        tparams, tst = tadamw.adamw_update(tparams, tg, tst, 1e-3, cfg_t)
        if step == 0 and moments == "posit8":
            for key in ("m", "v"):
                for (path, got), (_, want) in zip(_leaves(tst[key]),
                                                  _leaves(jst[key])):
                    np.testing.assert_array_equal(got.numpy(),
                                                  np.asarray(want),
                                                  err_msg=f"{key} {path}")
    assert int(tst["count"]) == int(jst["count"]) == 5
    for (path, got), (_, want) in zip(_leaves(tparams), _leaves(jparams)):
        _close(got, want, what=path)


def _unflatten(like, flat, path=""):
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, f"{path}/{k}" if path else k)
                for k, v in like.items()}
    return flat[path]


def test_schedules_equal_jax():
    for step in (0, 3, 10, 50, 99, 100, 150):
        _close(tsched.warmup_cosine(step, 1e-3, 10, 100),
               jsched.warmup_cosine(step, 1e-3, 10, 100), 1e-6,
               f"step {step}")
    assert tsched.constant(7, 3e-4) == jsched.constant(7, 3e-4)


def test_vio_stream_batches_equal_jax():
    a, b = VIOStream(batch=8, feat_dim=32, seed=5), \
        JStream(batch=8, feat_dim=32, seed=5)
    for _ in range(3):
        got, want = a.next_batch(), b.next_batch()
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert a.state_dict() == b.state_dict()


# ---------------------------------------------------------------------------
# the bench twins on the CPU
# ---------------------------------------------------------------------------

def _rows(fn, *args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def test_bench_model_size_rows_equal_the_reference():
    from benchmarks import bench_model_size as jbench
    from repro_torch.benchmarks import bench_model_size
    assert _rows(bench_model_size.run, "cpu") == _rows(jbench.run)


def test_bench_accuracy_runs_end_to_end(monkeypatch):
    """The twin's every row, with the training cut to a few steps."""
    from repro_torch.benchmarks import bench_accuracy
    monkeypatch.setattr(bench_accuracy, "STEPS",
                        {"classify": 3, "vio": 3, "gaze": 3})
    rows = _rows(bench_accuracy.run, "cpu")
    names = [r.split(",")[0] for r in rows]
    mixes = bench_accuracy.SWEEP + ["mxp_paper", "mxp_adaptive"]
    assert names == ([f"accuracy/classify_{p}" for p in mixes]
                     + [f"accuracy/vio_{p}" for p in mixes]
                     + [f"accuracy/group_scale_{p}_{g}"
                        for p in ("fp4", "posit4_1")
                        for g in ("chan", "g128", "g64", "g32")]
                     + [f"accuracy/gaze_{p}" for p in bench_accuracy.SWEEP])
    for r in rows:
        for kv in r.split(",", 2)[2].split(";"):
            assert np.isfinite(float(kv.split("=")[1])), r
