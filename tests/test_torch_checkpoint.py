"""Checkpoints of the PyTorch port: the counterparts of every case of
``tests/test_checkpoint.py`` (round trip, retention, atomic commit,
corruption detection, async manager, restore onto a device), the async
snapshot and error rules, and cross-loading with the JAX package in
both directions -- bf16 leaves, packed leaves (uint32 words and their
aux) and a whole ``TrainState`` restore bit for bit."""

import dataclasses
import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import jax_to_numpy, one_torch_thread  # noqa: E402,F401
from repro.checkpoint import restore_checkpoint as jrestore  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import RunConfig as JRun  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.policy import flatten_with_paths  # noqa: E402
from repro_torch.kernels.ops import PackedTensor  # noqa: E402
from repro_torch.train.loop import TrainState, init_state  # noqa: E402


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": torch.from_numpy(
        rng.normal(size=(8, 8)).astype(np.float32))},
        "b": torch.arange(5, dtype=torch.int32)}


def _bits(x):
    """Comparable numpy bits of a leaf (a bf16 leaf as uint16, words as
    int32, whichever package holds it)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _same(got, want):
    """Every leaf of two trees (of either package) equal bit for bit, with
    the same paths, dtypes and shapes."""
    gf, wf = flatten_with_paths(got), flatten_with_paths(want)
    assert [p for p, _ in gf] == [p for p, _ in wf]
    for (p, g), (_, w) in zip(gf, wf):
        g, w = _bits(g), _bits(w)
        assert g.dtype == w.dtype and g.shape == w.shape, p
        np.testing.assert_array_equal(g, w, err_msg=p)


# ---------------------------------------------------------------------------
# counterparts of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t, extra={"data": {"step": 3}})
    t2, extra, step = restore_checkpoint(str(tmp_path), t)
    assert step == 3 and extra["data"]["step"] == 3
    assert torch.equal(t2["a"]["w"], t["a"]["w"])
    assert torch.equal(t2["b"], t["b"]) and t2["b"].dtype == torch.int32


def test_retention(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, t, keep=2)
    assert sorted(int(d[5:]) for d in os.listdir(tmp_path)) == [4, 5]
    assert latest_step(str(tmp_path)) == 5


def test_atomic_no_tmp_left(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_interrupted_save_never_wins(tmp_path):
    """A leftover ``step_N.tmp`` (a crash mid-save) is not a checkpoint."""
    save_checkpoint(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert latest_step(str(tmp_path)) == 1
    _, _, step = restore_checkpoint(str(tmp_path), _tree())
    assert step == 1


def test_corruption_detected(tmp_path):
    t = _tree()
    path = save_checkpoint(str(tmp_path), 1, t)
    fn = [f for f in os.listdir(path) if f.endswith(".npy")][0]
    full = os.path.join(path, fn)
    np.save(full, np.load(full)[:2])
    with pytest.raises((IOError, KeyError, ValueError)):
        restore_checkpoint(str(tmp_path), t)


def test_missing_leaf_detected(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    with pytest.raises(KeyError, match="c/x"):
        restore_checkpoint(str(tmp_path), dict(_tree(), c={"x": _tree()["b"]}))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), _tree())


def test_async_manager(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    t = _tree()
    mgr.save(1, t)
    mgr.save(2, t)  # waits for the first
    mgr.wait()
    assert mgr.latest_step() == 2


def test_async_save_snapshots_before_returning(tmp_path, monkeypatch):
    """An in-place update right after ``save`` returns (the next step's
    optimizer) does not reach the checkpoint being written."""
    mod = sys.modules[CheckpointManager.__module__]
    real, gate = mod.save_checkpoint, threading.Event()

    def slow(*a, **k):
        assert gate.wait(timeout=30)
        return real(*a, **k)

    monkeypatch.setattr(mod, "save_checkpoint", slow)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    t = _tree()
    want = t["a"]["w"].clone()
    mgr.save(1, t)
    t["a"]["w"].add_(1.0)
    gate.set()
    mgr.wait()
    got, _, _ = mgr.restore(_tree())
    assert torch.equal(got["a"]["w"], want)


def test_async_error_surfaces_on_wait_and_save(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    mgr = CheckpointManager(str(blocker / "ck"), async_save=True)
    mgr.save(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                          # reported once
    mgr.save(2, _tree())
    with pytest.raises(OSError):
        mgr.save(3, _tree())


def test_restore_onto_device(tmp_path):
    """The template's device decides, unless ``device`` is given (the
    port's stand-in for the reference's elastic restore onto shardings)."""
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    t2, _, _ = restore_checkpoint(str(tmp_path), t, device="cpu")
    assert t2["a"]["w"].device.type == "cpu"
    if torch.cuda.is_available():
        t3, _, _ = restore_checkpoint(str(tmp_path), t, device="cuda")
        assert t3["a"]["w"].device.type == "cuda"
        assert torch.equal(t3["a"]["w"].cpu(), t["a"]["w"])


# ---------------------------------------------------------------------------
# cross-loading with the JAX package
# ---------------------------------------------------------------------------

def _jax_trees():
    """A bf16 tree, a packed serving tree and a TrainState, in JAX."""
    jcfg = jget("qwen2-0.5b").reduced()
    rng = np.random.default_rng(0)
    bf16 = {"x": jnp.asarray(rng.normal(size=(4, 6)), jnp.bfloat16),
            "y": {"n": jnp.arange(3, dtype=jnp.int32),
                  "f": jnp.asarray(rng.normal(size=(5,)), jnp.float32)}}
    params = jzoo.init_model(jax.random.PRNGKey(0), jcfg)
    pol = JPolicy.paper_mixed()
    pol.group_size = 32
    packed = jax.jit(lambda p: jzoo.pack_params(p, pol))(params)
    run = JRun(arch="t", opt_state_dtype="posit8", grad_compression="posit8",
               checkpoint_every=0)
    state = jax.jit(lambda k: jloop.init_state(k, jcfg, run))(
        jax.random.PRNGKey(1))
    state = dataclasses.replace(state, step=jnp.asarray(7, jnp.int32))
    return {"bf16": bf16, "packed": packed, "state": state}


def _port_template(name, jtree):
    """The port's tree of the same structure, with other values."""
    if name == "state":
        run = RunConfig(arch="t", opt_state_dtype="posit8",
                        grad_compression="posit8", checkpoint_every=0)
        return init_state(get_config("qwen2-0.5b").reduced(), run,
                          torch.Generator().manual_seed(5))
    tree = params_from_numpy(jax_to_numpy(jtree), "cpu")
    return _perturbed(tree)


def _perturbed(tree):
    if isinstance(tree, dict):
        return {k: _perturbed(v) for k, v in tree.items()}
    if isinstance(tree, PackedTensor):
        return dataclasses.replace(tree, words=tree.words + 1,
                                   scales=tree.scales * 2, mask=tree.mask,
                                   group=None)
    return torch.zeros_like(tree)


@pytest.fixture(scope="module")
def jax_trees():
    return _jax_trees()


@pytest.mark.parametrize("name", ["bf16", "packed", "state"])
def test_jax_checkpoint_restores_bitwise_in_port(tmp_path, jax_trees, name):
    jtree = jax_trees[name]
    jsave(str(tmp_path), 11, jtree, extra={"data": {"seed": 0, "step": 11}})
    got, extra, step = restore_checkpoint(str(tmp_path),
                                          _port_template(name, jtree))
    assert step == 11 and extra == {"data": {"seed": 0, "step": 11}}
    _same(got, jtree)
    if name == "packed":
        node = got["layers"]["attn"]["wq"]["w"]
        assert isinstance(node, PackedTensor) and node.group == 32
        assert node.words.dtype == torch.int32
        assert node.spec.name == "posit8_0"
    if name == "state":
        assert isinstance(got, TrainState) and int(got.step) == 7


@pytest.mark.parametrize("name", ["bf16", "packed", "state"])
def test_port_checkpoint_restores_bitwise_in_jax(tmp_path, jax_trees, name):
    jtree = jax_trees[name]
    mine = params_from_numpy(jax_to_numpy(jtree), "cpu") \
        if name != "state" else TrainState(*(
            None if getattr(jtree, f.name) is None else params_from_numpy(
                jax_to_numpy(getattr(jtree, f.name)), "cpu")
            for f in dataclasses.fields(jtree)))
    save_checkpoint(str(tmp_path), 12, mine, extra={"data": {"step": 12}})
    with open(tmp_path / "step_00000012" / "manifest.json") as f:
        manifest = json.load(f)
    dtypes = {m["dtype"] for m in manifest["leaves"].values()}
    if name == "bf16":
        assert "bfloat16" in dtypes
    if name == "packed":
        assert "uint32" in dtypes and "int32" not in {
            m["dtype"] for p, m in manifest["leaves"].items()
            if p.endswith("/words")}
        assert manifest["packed"]["layers/attn/wq/w"]["group"] == 32
    template = jax.tree.map(jnp.zeros_like, jtree)
    got, extra, step = jrestore(str(tmp_path), template)
    assert step == 12 and extra["data"]["step"] == 12
    _same(mine, got)
