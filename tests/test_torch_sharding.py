"""The port's multi-device plane against the JAX package, on the CPU
(the counterpart of ``tests/test_sharding.py``).

In process, bitwise as tuples: the port's spec rules equal the
reference's for every parameter leaf of the ten full configs (shapes
from ``jax.eval_shape``) on stand-in meshes (2, 4) ('data', 'model') and
(2, 16, 16) ('pod', 'data', 'model') -- the rules read only a mesh's axis
names and sizes -- and at the reference test's cache and activation
shapes; ``batch_pspec`` and ``split_devices`` too; the port's reduced
parameter trees have JAX's leaf paths and shapes.

In four spawned gloo processes on a (2, 2) mesh (one spawn for the
module): two steps of reduced float32 qwen2, kimi-k2 (MoE), rwkv6 and
jamba, sharded against the port's unsharded step from one state and the
same batches -- plain (f32 moments, no compression): losses within
``LOSS_REL`` and parameters within ``PARAM_REL`` of each leaf's largest
magnitude (the data ranks' gradients are summed in another order); with
QAT, posit8 compression and posit8 moments: losses within ``STEP_REL``.
One update from the same gradients gives bitwise the unsharded
parameters, posit8 moment codes and block scales, residuals and norm.
Each rank's local shards have the sizes their specs say.  A checkpoint
saved from the mesh restores bitwise onto (4, 1) and unsharded, and an
async ``CheckpointManager`` save from the mesh (rank 0 writes) too."""

import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _torch_dist as D  # noqa: E402
from _torch_bridge import one_torch_thread  # noqa: E402,F401
from repro.configs import get_config as jget  # noqa: E402
from repro.core.policy import flatten_with_paths as jflat  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core.policy import flatten_with_paths  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

LOSS_REL = 1e-6
PARAM_REL = 1e-5
STEP_REL = 1e-4

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _jax_shapes(cfg):
    tree = jax.eval_shape(lambda: jzoo.init_model(jax.random.PRNGKey(0),
                                                  cfg))
    return [(p, tuple(v.shape)) for p, v in jflat(tree)]


# ---------------------------------------------------------------------------
# spec rules, in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspec_matches_reference_full_configs(arch, mesh):
    m = _mesh(mesh)
    leaves = _jax_shapes(jget(arch))
    assert leaves
    for path, shape in leaves:
        want = tuple(jsh.param_pspec(m, path, shape))
        assert sh.param_pspec(m, path, shape) == want, (path, shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_trees_have_reference_paths(arch):
    want = _jax_shapes(jget(arch).reduced())
    p = zoo.init_model(get_config(arch).reduced(),
                       torch.Generator().manual_seed(0))
    got = [(path, tuple(t.shape)) for path, t in flatten_with_paths(p)]
    assert got == want
    m = _mesh("2x4")
    tree = sh.param_sharding_tree(m, p)
    for (path, shape), (_, ns) in zip(want, flatten_with_paths(tree)):
        assert isinstance(ns, sh.NamedSharding) and ns.mesh is m
        assert ns.spec == tuple(jsh.param_pspec(m, path, shape)), path


CACHE_CASES = [
    ("k", (24, 8, 512, 2, 64), 8),            # batch on data, Dh on model
    ("k", (4, 1, 1024, 8, 128), 1),           # B=1: seq takes data (SP)
    ("b0/h", (4, 8, 8192, 16), 8),
    ("tm_state", (24, 2, 32, 64, 64), 2),
    ("v_scale", (24, 16, 4096, 2, 2), 16),
    ("conv", (4, 3, 3, 8192), 3),
]
PAGED_CASES = [
    ("page_table", (8, 16)), ("slab_table", (32, 1)), ("positions", (8,)),
    ("k_codes", (24, 64, 128, 2, 64)), ("k_scale", (24, 64, 128, 2, 2)),
    ("b0/h_codes", (4, 8, 8192, 16)), ("tm_state_scale", (24, 5, 32, 64, 2)),
]
LOGICAL_CASES = [
    ((8, 512, 896), ("batch", "seq", "embed")),
    ((8, 512, 14, 64), ("batch", "seq", "heads", "head_dim")),
    ((8, 512, 151936), ("batch", "seq", "vocab")),
    ((1, 4096, 896), ("batch", "seq_sp", "embed")),
    ((64, 32, 4096), ("experts", "capacity", "embed")),
    ((6, 7), ("batch", "ff")),
    ((32, 32), ("batch", "batch_nopod")),
]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_and_logical_specs_match_reference(mesh):
    m = _mesh(mesh)
    for path, shape, batch in CACHE_CASES:
        assert sh.cache_pspec(m, path, shape, batch) == \
            tuple(jsh.cache_pspec(m, path, shape, batch)), (path, shape)
    for path, shape in PAGED_CASES:
        assert sh.paged_cache_pspec(m, path, shape) == \
            tuple(jsh.paged_cache_pspec(m, path, shape)), (path, shape)
    for shape, names in LOGICAL_CASES:
        assert sh.logical_pspec(m, shape, names) == \
            tuple(jsh.logical_pspec(m, shape, names)), (shape, names)
    assert sh.batch_pspec(m) == tuple(jsh.batch_pspec(m))
    for cases, paged in ((CACHE_CASES, False), (PAGED_CASES, True)):
        cache = {f"l{i}": {path: torch.empty(shape, device="meta")}
                 for i, (path, shape, *_) in enumerate(cases)}
        tree = sh.cache_sharding_tree(m, cache, batch=8)
        for i, (path, shape, *_) in enumerate(cases):
            want = jsh.paged_cache_pspec(m, path, shape) if paged else \
                jsh.cache_pspec(m, path, shape, 8)
            assert tree[f"l{i}"][path].spec == tuple(want), (path, shape)


def test_reference_test_cases():
    """The reference test's own expectations on the port's rules."""
    m = _mesh("2x4")
    assert sh.param_pspec(m, "layers/ffn/down/w", (24, 4864, 896)) == \
        (None, "model", "data")
    assert sh.param_pspec(m, "embed/table", (151936, 896))[0] == "model"
    assert sh.param_pspec(m, "layers/ln1/norm_scale", (24, 896)) == \
        (None, None)
    assert sh.param_pspec(m, "layers/moe/experts/up",
                          (61, 384, 7168, 2048))[1] == "model"
    assert sh.param_pspec(m, "layers/attn/wq/w", (24, 897, 898)) == \
        (None, None, None)
    assert sh.cache_pspec(m, "k", (4, 1, 1024, 8, 128), 1)[2] == "data"
    with pytest.raises(ValueError, match="differ in length"):
        sh.logical_pspec(m, (4, 4), ("batch",))


def test_split_devices_matches_reference():
    for n in range(1, 9):
        for frac in (0.1, 0.25, 0.5, 0.75, 0.9):
            devs = list(range(n))
            got = sh.split_devices(devs, frac)
            want = jsh.split_devices(devs, frac)
            assert [list(g) for g in got] == [list(w) for w in want]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no devices"):
            sh.split_devices()


def test_placements_and_plain_tensors():
    from torch.distributed.tensor import Replicate, Shard
    m = _mesh("2x16x16")
    assert sh.placements(m, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.placements(m, (None, None)) == (Replicate(),) * 3
    x = torch.ones(4, 4)
    assert sh.shard(x, "batch", "embed") is x
    assert sh.gather({"a": x})["a"] is x and sh.whole(x) is x
    assert sh.part(x, x) is x
    assert sh.batch_sum(x) is x and sh.batch_ranks() == 1
    with sh.use_mesh(m):
        assert sh.current_mesh() is m and sh.batch_ranks() == 32
    assert sh.current_mesh() is None


def test_host_mesh_clips_and_production_mesh_needs_its_ranks(tmp_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(2, 4, device="cpu")   # clipped to the 1 rank
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
        assert sh.batch_pspec(mesh) == ("data",)
        assert sh.batch_rows(mesh, 6) == slice(0, 6)
        for multi_pod, n in ((False, 256), (True, 512)):
            with pytest.raises(ValueError, match=f"needs {n} ranks"):
                make_production_mesh(multi_pod=multi_pod, device="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the sharded step, four gloo processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    return D.spawn(D.sharding_worker, 4, tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("feat", sorted(D.FEATURES))
@pytest.mark.parametrize("arch", D.STEP_ARCHS)
def test_sharded_step_matches_unsharded(mesh_run, arch, feat):
    r = mesh_run[0]["steps"][arch, feat]       # rank 0 ran both steps
    got, want = np.array(r["losses"]), np.array(r["ref_losses"])
    assert np.isfinite(got).all() and len(want) == 2
    rel = np.abs(got - want) / np.abs(want)
    if feat == "f32":
        assert rel.max() <= LOSS_REL, (got, want)
        assert r["param_rel"] <= PARAM_REL, r["param_rel"]
    else:
        assert rel.max() <= STEP_REL, (got, want)
    for res in mesh_run:          # every rank's loss is the whole batch's
        assert res["steps"][arch, feat]["step"] == 2
        assert res["steps"][arch, feat]["losses"] == r["losses"]


def test_update_from_same_grads_is_bitwise(mesh_run):
    """The compression's RMS scale, the norm and the posit8 moments'
    block scales see whole leaves: one update from the same gradients
    equals the unsharded one bit for bit (qwen2, posit8 moments and
    compression, two updates)."""
    for res in mesh_run:
        assert res["update_diff"] == {"params": [], "opt_state": [],
                                      "residuals": []}
        got, want = res["update_gnorm"]
        assert got == want


def test_local_shards_have_their_spec_sizes(mesh_run):
    n_split = 0
    for res in mesh_run:
        assert res["sizes"]
        for path, (local, want) in res["sizes"].items():
            assert local == want, path
        n_split += sum(1 for p, (local, _) in res["sizes"].items()
                       if p.endswith(("embed/table", "embed/table/codes"))
                       and local[0] == 256)
    # the (512, d) table, its residual and its two moments' codes: vocab
    # on 'model' on every rank
    assert n_split == 4 * 4


def test_shard_redistributes_a_dtensor(mesh_run):
    from torch.distributed.tensor import Shard
    for res in mesh_run:
        local, pl, same = res["shard"]
        assert local == (4, 2) and pl == (Shard(0), Shard(1)) and same


@pytest.mark.parametrize("onto", ["mesh41", "unsharded", "manager"])
def test_elastic_restore(mesh_run, onto):
    for res in mesh_run:
        r = res["restore"]
        assert r["at"] == 2
        assert r[onto] == [], r[onto]
        if onto == "mesh41":
            for path, (local, want) in r["sizes41"].items():
                assert local == want, path
