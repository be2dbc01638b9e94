"""The port's GPipe pipeline against sequential stages computed by JAX
(the counterpart of ``tests/test_pipeline.py``), on the CPU: 4 stage
ranks (S 4, M 4) and a (2, 2) ('stage', 'data') mesh (S 2, M 4) in four
spawned gloo processes, every rank's result within the reference's
``TOL`` of ``stage_fn`` applied in turn to the same numpy arrays; one
stage in a one-process group equals the sequential stage bitwise."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _torch_dist as D  # noqa: E402
from _torch_bridge import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
S, DIM = 4, 16


def _arrays():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(S, DIM, DIM)).astype(np.float32) * 0.3
    b = rng.normal(size=(S, 1, DIM)).astype(np.float32) * 0.1
    x = rng.normal(size=(8, DIM)).astype(np.float32)
    return w, b, x


def _sequential(w, b, x, n):
    y = jnp.asarray(x)
    for s in range(n):
        y = jnp.tanh(y @ jnp.asarray(w[s])) + jnp.asarray(b[s])
    return np.asarray(y)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return D.spawn(D.pipeline_worker, 4, tmp_path_factory.mktemp("pipe"),
                   *_arrays())


@pytest.mark.parametrize("stages", [4, 2])
def test_pipeline_matches_sequential(runs, stages):
    w, b, x = _arrays()
    want = _sequential(w, b, x, stages)
    for res in runs:                          # every stage gets the result
        err = float(np.max(np.abs(res[stages] - want)))
        assert err < TOL, err


def test_one_stage_equals_the_stage(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("stage",))
        w, b, x = _arrays()
        params = {"w": torch.from_numpy(w[:1]), "b": torch.from_numpy(b[:1])}
        got = pipeline_apply(mesh, "stage", D.stage_fn, params,
                             torch.from_numpy(x), 2)
        want = D.stage_fn({"w": params["w"][0], "b": params["b"][0]},
                          torch.from_numpy(x))
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="microbatches"):
            pipeline_apply(mesh, "stage", D.stage_fn, params,
                           torch.from_numpy(x), 3)
    finally:
        dist.destroy_process_group()
