"""LM training of the PyTorch port against the JAX package, on the CPU:
``TokenStream`` batches, posit8 gradient compression, the train step
over five steps, and the port's counterparts of every case of
``tests/test_train.py`` (learning, QAT, 8-bit Adam, error feedback,
microbatching, checkpoint resume, preemption recovery), the train CLI.

Exact where the arithmetic is the same op for op: batches, compression
codes and scales.  Training losses after five steps from one init
(float32 config, float32 sums in another order, float32 moments): within
``STEP_REL``; the same with every paper feature is in
``test_torch_train_paper.py``."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import (both_train_runs, jax_to_numpy,  # noqa: E402,F401
                           one_torch_thread)
from repro.data import TokenStream as JStream  # noqa: E402
from repro.parallel import collectives as jcoll  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.policy import flatten_with_paths  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.optim import OptConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.train.loop import (build_train_step, init_state,  # noqa: E402
                                    train_loop)

CFG = get_config("qwen2-0.5b").reduced()
CFG32 = dataclasses.replace(CFG, dtype="float32")
STEP_REL = 1e-4    # five f32 steps, sums in another order


def _stream(**kw):
    return TokenStream(device="cpu", **kw)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab=512, seq_len=64, global_batch=8),
    dict(vocab=151936, seq_len=33, global_batch=6, seed=7, step=11),
    dict(vocab=512, seq_len=16, global_batch=8, num_shards=4, shard=3),
    dict(vocab=512, seq_len=16, global_batch=4, frontend="audio",
         d_model=24),
    dict(vocab=512, seq_len=16, global_batch=4, frontend="vision",
         d_model=24, n_patches=4),
], ids=["plain", "wide_vocab", "shard", "audio", "vision"])
def test_token_stream_batches_bitwise(kw):
    mine, ref = _stream(**kw), JStream(**kw)
    for _ in range(3):
        got, want = mine.next_batch(), ref.next_batch()
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].numpy().dtype == w.dtype
            np.testing.assert_array_equal(got[k].numpy(), w)
    assert mine.state_dict() == ref.state_dict()


def test_token_stream_rebalance_and_resume():
    base = dict(vocab=512, seq_len=16, global_batch=8, seed=3)
    whole = _stream(**base)
    halves = [whole.rebalance(2, i) for i in range(2)]
    jhalves = [JStream(**base).rebalance(2, i) for i in range(2)]
    for mine, ref in zip(halves, jhalves):
        np.testing.assert_array_equal(mine.next_batch()["tokens"].numpy(),
                                      np.asarray(ref.next_batch()["tokens"]))
    a = _stream(**base)
    for _ in range(5):
        a.next_batch()
    b = _stream(**base)
    b.load_state_dict(a.state_dict())
    assert b.step == 5
    np.testing.assert_array_equal(a.next_batch()["labels"].numpy(),
                                  b.next_batch()["labels"].numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TokenStream(vocab=8, seq_len=4, global_batch=2).next_batch()


# ---------------------------------------------------------------------------
# posit8 gradient compression
# ---------------------------------------------------------------------------

def _grad_tree(seed=0):
    """Gradients whose RMS keeps the po2 scale inside 2^+-12 (XLA's CPU
    exp2 is inexact beyond; the zero leaf's case is below)."""
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.normal(size=(16, 24)).astype(np.float32) * 3e-3},
            "a": rng.normal(size=(40,)).astype(np.float32) * 50.0,
            "c": {"h": rng.normal(size=(8, 8)).astype(np.float32)}}


def _eq_tree(got, want):
    gf, wf = flatten_with_paths(got), flatten_with_paths(jax_to_numpy(want))
    assert [p for p, _ in gf] == [p for p, _ in wf]
    for (p, g), (_, w) in zip(gf, wf):
        assert g.numpy().dtype == np.asarray(w).dtype, p
        np.testing.assert_array_equal(g.numpy(), w, err_msg=p)


def test_compress_tree_codes_and_scales_exact():
    g = _grad_tree()
    res = _grad_tree(1)
    res = {"b": {"w": res["b"]["w"] * 0.1}, "a": res["a"] * 0.01,
           "c": {"h": res["c"]["h"] * 0.1}}
    jg = jax.tree.map(jnp.asarray, g)
    tg = params_from_numpy(g, "cpu")
    for r in (None, res):
        jc, js, jr = jcoll.compress_tree(
            jg, None if r is None else jax.tree.map(jnp.asarray, r))
        tc, ts, tr = collectives.compress_tree(
            tg, None if r is None else params_from_numpy(r, "cpu"))
        _eq_tree(tc, jc)
        _eq_tree(ts, js)
        _eq_tree(tr, jr)
        _eq_tree(collectives.decompress_tree(tc, ts),
                 jcoll.decompress_tree(jc, js))


def test_compress_tree_zero_leaf():
    """A zero gradient: codes 0 and the scale 2^-100 (the RMS floor 1e-30
    rounded to a power of two), exact here; XLA's CPU exp2 gives it
    within 1e-5."""
    z = {"z": np.zeros((3, 5), np.float32)}
    tc, ts, tr = collectives.compress_tree(params_from_numpy(z, "cpu"))
    jc, js, _ = jcoll.compress_tree(jax.tree.map(jnp.asarray, z))
    assert ts["z"].item() == 2.0 ** -100
    assert not tc["z"].any() and not np.asarray(jc["z"]).any()
    assert not tr["z"].any()
    assert abs(float(js["z"]) / 2.0 ** -100 - 1.0) < 1e-5


def test_psum_compressed_world_of_one(tmp_path):
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
        rank=0, world_size=1)
    try:
        g = params_from_numpy(_grad_tree(), "cpu")
        summed, res = collectives.psum_compressed(g)
        want, want_res = collectives.error_feedback_update(g, None)
        for (p, a), (_, b) in zip(flatten_with_paths(summed),
                                  flatten_with_paths(want)):
            assert torch.equal(a, b), p
        for (p, a), (_, b) in zip(flatten_with_paths(res),
                                  flatten_with_paths(want_res)):
            assert torch.equal(a, b), p
    finally:
        dist.destroy_process_group()


def test_grad_compression_error_feedback_converges():
    """Error feedback keeps the compressed-gradient average unbiased: the
    residual stays bounded (counterpart of the reference's case)."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))}
    res = {"w": torch.zeros(128)}
    total = torch.zeros(128)
    for _ in range(50):
        gq, res = collectives.error_feedback_update(g, res)
        total = total + gq["w"]
    err = (total / 50 - g["w"]).abs().max().item()
    assert err < 0.02, err
    assert res["w"].abs().max().item() < 0.5


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-1.6b",
                                  "jamba-v0.1-52b"])
def test_five_steps_match_reference_f32_moments(arch):
    mine, ref, state = both_train_runs(5, arch)
    rel = np.abs(mine - ref) / np.abs(ref)
    assert rel.max() <= STEP_REL, (mine, ref, rel)
    assert int(state.step) == 5


# ---------------------------------------------------------------------------
# counterparts of tests/test_train.py
# ---------------------------------------------------------------------------

def _run(steps=40, **kw):
    run = RunConfig(arch="t", steps=steps, lr=3e-3, warmup_steps=5,
                    checkpoint_every=0, **kw)
    data = _stream(vocab=CFG.vocab, seq_len=64, global_batch=8)
    state = init_state(CFG, run, device="cpu")
    step = build_train_step(CFG, run)
    losses = []
    for _ in range(steps):
        state, m = step(state, data.next_batch())
        losses.append(float(m["loss"]))
    return losses, state


def test_loss_decreases_plain():
    losses, _ = _run()
    assert losses[-1] < losses[0] - 0.5


def test_loss_decreases_with_all_paper_features():
    losses, _ = _run(qat=True, precision_policy="mixed",
                     opt_state_dtype="posit8", grad_compression="posit8",
                     microbatch=2)
    assert losses[-1] < losses[0] - 0.5
    assert np.isfinite(losses).all()


def test_qat_quantizes_forward():
    """With a uniform fp4 policy, effective weights lie on the fp4 grid."""
    from repro_torch.core import formats as F
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.core.qat import quantize_tree
    w0 = torch.from_numpy(
        np.random.default_rng(0).normal(size=(32, 32)).astype(np.float32))
    w = quantize_tree({"blk": {"w": w0}}, PrecisionPolicy.uniform("fp4"))
    w = w["blk"]["w"].numpy()
    scale = float(torch.exp2(torch.ceil(torch.log2(w0.abs().max() / 6.0))))
    grid = F.code_values(F.FP4)
    grid = np.unique(grid[np.isfinite(grid)]) * scale
    dist = np.min(np.abs(w[..., None] - grid[None, None]), -1)
    assert np.max(dist) < 1e-6


def test_adamw_8bit_tracks_fp32():
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(
        rng.normal(size=(64, 64)).astype(np.float32))}
    g = {"w": torch.from_numpy(
        rng.normal(size=(64, 64)).astype(np.float32) * .1)}
    out = {}
    for dt in ("float32", "posit8"):
        cfg = OptConfig(moment_dtype=dt, weight_decay=0.0)
        st = adamw_init(params, cfg)
        p = params
        for _ in range(20):
            p, st = adamw_update(p, g, st, 1e-3, cfg)
        out[dt] = (p["w"] - params["w"]).numpy()
    a, b = out["float32"].ravel(), out["posit8"].ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.95, cos
    assert 0.5 < np.linalg.norm(b) / np.linalg.norm(a) < 2.0


def test_microbatch_equals_full_batch_grads():
    kw = dict(arch="t", steps=1, lr=0.0, warmup_steps=0, grad_clip=0.0,
              checkpoint_every=0)
    run1, run2 = RunConfig(**kw), RunConfig(microbatch=4, **kw)
    batch = _stream(vocab=CFG.vocab, seq_len=32, global_batch=8).next_batch()
    gen = torch.Generator().manual_seed(0)
    s1 = init_state(CFG32, run1, gen)
    s2 = init_state(CFG32, run2, torch.Generator().manual_seed(0))
    _, m1 = build_train_step(CFG32, run1)(s1, batch)
    _, m2 = build_train_step(CFG32, run2)(s2, batch)
    assert abs(float(m1["ce"]) - float(m2["ce"])) < 1e-5
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) \
        < 1e-5 * float(m1["grad_norm"])


def test_microbatch_2_grads_equal_full_batch_grads():
    """The step's microbatch-2 gradient (the halves' grads summed in
    order, then halved) equals the full batch's, leaf by leaf, within
    1e-5 of each leaf's largest magnitude (float32 sums in another
    order)."""
    from repro_torch.train.loop import grads_of
    p = init_state(CFG32, RunConfig(), torch.Generator().manual_seed(0)
                   ).params
    batch = _stream(vocab=CFG.vocab, seq_len=32, global_batch=8).next_batch()
    full, *_ = grads_of(p, batch, CFG32)
    halves = [grads_of(p, {k: v[i * 4:(i + 1) * 4] for k, v in batch.items()},
                       CFG32)[0] for i in range(2)]
    h0, h1 = (dict(flatten_with_paths(h)) for h in halves)
    for path, g in flatten_with_paths(full):
        err = ((h0[path] + h1[path]) / 2 - g).abs().max() / g.abs().max()
        assert err <= 1e-5, (path, float(err))


def test_train_loop_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "ck")
    run = RunConfig(arch="t", steps=20, lr=1e-3, warmup_steps=2,
                    checkpoint_every=10, checkpoint_dir=ck)
    data = _stream(vocab=CFG.vocab, seq_len=32, global_batch=4)
    state, _ = train_loop(CFG, run, data, log_every=100, device="cpu")
    assert int(state.step) == 20
    run2 = dataclasses.replace(run, steps=30)
    data2 = _stream(vocab=CFG.vocab, seq_len=32, global_batch=4)
    state2, _ = train_loop(CFG, run2, data2, log_every=100, device="cpu")
    assert int(state2.step) == 30
    assert data2.step >= 20   # iterator state resumed, not restarted


def test_train_loop_preemption_recovery(tmp_path):
    """A step that raises mid-run is retried from the newest checkpoint."""
    ck = str(tmp_path / "ck")
    run = RunConfig(arch="t", steps=16, lr=1e-3, warmup_steps=2,
                    checkpoint_every=5, checkpoint_dir=ck)
    boom = {"armed": True}

    class FlakyStream(TokenStream):
        def next_batch(self):
            if self.step == 8 and boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("simulated preemption")
            return super().next_batch()

    flaky = FlakyStream(vocab=CFG.vocab, seq_len=32, global_batch=4,
                        device="cpu")
    try:
        state, _ = train_loop(CFG, run, flaky, log_every=100, device="cpu")
    except RuntimeError:
        # raised outside the step; a second call resumes
        state, _ = train_loop(CFG, run, flaky, log_every=100, device="cpu")
    assert int(state.step) == 16


def test_step_failure_inside_the_step_restores(tmp_path):
    """A step that raises inside ``step_fn`` restores the newest
    checkpoint and its data state, then goes on to the end."""
    ck = str(tmp_path / "ck")
    run = RunConfig(arch="t", steps=8, lr=1e-3, warmup_steps=2,
                    checkpoint_every=3, checkpoint_dir=ck)
    seen = []

    def on_step(s, state, metrics):
        seen.append(s)
        if s == 5 and seen.count(5) == 1:
            raise_next["armed"] = True

    raise_next = {"armed": False}

    class FaultyStream(TokenStream):
        def next_batch(self):
            b = super().next_batch()
            if raise_next["armed"]:
                raise_next["armed"] = False
                b["tokens"] = b["tokens"] + CFG.vocab   # the step raises
            return b

    data = FaultyStream(vocab=CFG.vocab, seq_len=16, global_batch=4,
                        device="cpu")
    state, _ = train_loop(CFG, run, data, log_every=100,
                          hooks={"on_step": on_step}, device="cpu")
    assert int(state.step) == 8
    assert seen == [1, 2, 3, 4, 5, 4, 5, 6, 7, 8]
    assert data.step == 8


def test_init_state_draws_on_the_card_by_default():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_state(CFG, RunConfig(steps=1, checkpoint_every=0))


def test_launch_train_cli(tmp_path, capsys):
    from repro_torch.launch import train as cli
    ck = str(tmp_path / "ck")
    args = ["--reduced", "--steps", "4", "--batch", "4", "--seq", "16",
            "--policy", "mixed", "--qat", "--grad-compression", "posit8",
            "--opt-dtype", "posit8", "--microbatch", "2",
            "--checkpoint-dir", ck, "--checkpoint-every", "2",
            "--device", "cpu"]
    cli.main(args)
    out = capsys.readouterr().out
    assert "final loss" in out and "at step 4 on cpu" in out
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000004"]
    cli.main(args[:2] + ["6"] + args[3:])           # resumes at step 4
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "at step 6" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(args[:-2])                     # the card by default
