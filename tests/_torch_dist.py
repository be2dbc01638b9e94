"""Spawned workers of the port's multi-device tests
(``test_torch_sharding.py``, ``test_torch_pipeline.py``).

``spawn(target, world, tmp_path, *args)`` starts ``world`` processes
(the ``spawn`` start method), joins them into a gloo process group over
a ``FileStore`` under ``tmp_path`` (no network), runs
``target(rank, world, out_dir, *args)`` in each with one torch thread, and
returns each rank's result (through ``torch.save`` files).  A worker
that raises fails the test with its traceback; a run past ``TIMEOUT``
seconds is terminated and fails it too.  This module imports torch only:
the workers never load jax."""

import dataclasses
import os
import time

import numpy as np
import torch

TIMEOUT = 300.0


def _entry(rank, world, out, target, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        res = target(rank, world, out, *args)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(target, world, tmp_path, *args):
    import torch.multiprocessing as mp
    out = str(tmp_path)
    ctx = mp.spawn(_entry, args=(world, out, target, args), nprocs=world,
                   join=False)
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{target.__name__}: {world} workers ran "
                                   f"past {TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# the sharded train step, checkpoints on meshes
# ---------------------------------------------------------------------------

STEP_ARCHS = ("qwen2-0.5b", "kimi-k2-1t-a32b", "rwkv6-1.6b",
              "jamba-v0.1-52b")
FEATURES = {
    "f32": dict(),
    "paper": dict(qat=True, precision_policy="mixed",
                  grad_compression="posit8", opt_state_dtype="posit8",
                  microbatch=2),
}


def small_cfg(arch):
    """A reduced float32 config; capacity 8.0 so no MoE pair is dropped
    (each rank routes its own rows, so capacity counts its tokens)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               capacity_factor=8.0)


def _run(**kw):
    from repro_torch.configs.base import RunConfig
    return RunConfig(arch="t", steps=2, lr=3e-3, warmup_steps=1,
                     checkpoint_every=0, **kw)


def _flat_whole(tree):
    from repro_torch.core.policy import flatten_with_paths
    from repro_torch.parallel.sharding import whole
    return [(p, whole(t)) for p, t in flatten_with_paths(tree)]


def _rel(got, want):
    """max |got - want| / max |want| over two lists of (path, whole
    leaf)."""
    worst = 0.0
    for (p, g), (q, w) in zip(got, want):
        assert p == q, (p, q)
        scale = max(float(w.float().abs().max()), 1e-30) if w.numel() else 1
        worst = max(worst, float((g.float() - w.float()).abs().max())
                    / scale if w.numel() else 0.0)
    return worst


def _bitwise(got, want):
    """Paths whose leaves differ in any bit (or dtype)."""
    return [p for (p, g), (_, w) in zip(_flat_whole(got), _flat_whole(want))
            if g.dtype != w.dtype or not torch.equal(g, w)]


def _local_sizes(tree, mesh):
    """Per leaf: (this rank's local shape, the shape its spec says)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.core.policy import flatten_with_paths
    from repro_torch.parallel.sharding import param_pspec
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = {}
    for path, t in flatten_with_paths(tree):
        assert isinstance(t, DTensor), path
        spec = param_pspec(mesh, path, t.shape)
        want = []
        for d, e in zip(t.shape, spec + (None,) * (t.dim() - len(spec))):
            names = () if e is None else (e if isinstance(e, tuple) else (e,))
            want.append(d // int(np.prod([sizes[a] for a in names] or [1])))
        out[path] = (tuple(t.to_local().shape), tuple(want))
    return out


def sharding_worker(rank, world, out):
    """On a (2, 2) ('data', 'model') mesh: two steps of each config and
    feature set, sharded against unsharded from one state and the same
    batches; one update from the same gradients, sharded against
    unsharded; local shard shapes; a checkpoint saved from the mesh and
    restored onto (4, 1) and unsharded, and one saved by an async
    ``CheckpointManager``."""
    from repro_torch.checkpoint import (CheckpointManager, restore_checkpoint,
                                        save_checkpoint)
    from repro_torch.core.policy import flatten_with_paths, tree_from_paths
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.parallel.sharding import (NamedSharding,
                                               param_sharding_tree, place,
                                               shard, whole)
    from repro_torch.train.loop import (TrainState, _apply_grads,
                                        build_train_step, init_state)
    mesh = make_host_mesh(2, 2, device="cpu")
    res = {"steps": {}, "sizes": {}}
    x = place(torch.arange(32.).reshape(8, 4),
              NamedSharding(mesh, (None, None)))
    y = shard(x, "batch", "heads")
    res["shard"] = (tuple(y.to_local().shape), tuple(y.placements),
                    bool(torch.equal(y.full_tensor(), x.full_tensor())))
    keep = None
    for arch in STEP_ARCHS:
        cfg = small_cfg(arch)
        for feat, kw in FEATURES.items():
            run = _run(**kw)
            st0 = init_state(cfg, run, torch.Generator().manual_seed(0))
            step_fn, shard_state = build_train_step(cfg, run, mesh=mesh)
            ref_step = build_train_step(cfg, run)
            st, ref = shard_state(st0), st0
            data = TokenStream(vocab=cfg.vocab, seq_len=32, global_batch=8,
                               device="cpu")
            losses, ref_losses = [], []
            for _ in range(2):
                b = data.next_batch()
                st, m = step_fn(st, b)
                losses.append(float(m["loss"]))
                if rank == 0:              # the unsharded step, once
                    ref, rm = ref_step(ref, b)
                    ref_losses.append(float(rm["loss"]))
            got = _flat_whole(st.params)       # every rank gathers
            res["steps"][arch, feat] = {
                "losses": losses, "ref_losses": ref_losses,
                "param_rel": _rel(got, _flat_whole(ref.params))
                if rank == 0 else None, "step": int(st.step)}
            if arch == "qwen2-0.5b" and feat == "paper":
                keep = (cfg, run, st)
                res["sizes"] = {
                    f"{name}/{p}": v for name in ("params", "opt_state",
                                                  "residuals")
                    for p, v in _local_sizes(getattr(st, name), mesh).items()}

    # one update from the same gradients: the whole-leaf reductions
    cfg, run, st = keep
    opt_cfg = OptConfig(weight_decay=run.weight_decay,
                        moment_dtype=run.opt_state_dtype)
    rng = np.random.default_rng(5)
    ref = TrainState(st.step, *(None if t is None else tree_from_paths(
        t, {p: whole(x) for p, x in flatten_with_paths(t)})
        for t in (st.params, st.opt_state, st.residuals)))
    sh = dict(flatten_with_paths(param_sharding_tree(mesh, ref.params)))
    for _ in range(2):
        g = {p: torch.from_numpy(rng.normal(size=tuple(t.shape)).astype(
            np.float32) * 1e-2) for p, t in flatten_with_paths(ref.params)}
        g_sh = {p: place(t, sh[p]) for p, t in g.items()}
        st, gn, _ = _apply_grads(st, g_sh, run, opt_cfg)
        ref, rgn, _ = _apply_grads(ref, g, run, opt_cfg)
    res["update_diff"] = {
        name: _bitwise(getattr(st, name), getattr(ref, name))
        for name in ("params", "opt_state", "residuals")}
    res["update_gnorm"] = (float(gn), float(rgn))

    # elastic restore: saved from (2, 2), restored onto (4, 1), unsharded
    ck = os.path.join(out, "ck")
    save_checkpoint(ck, 2, st)
    mesh41 = make_host_mesh(4, 1, device="cpu")
    tmpl = init_state(cfg, run, torch.Generator().manual_seed(1))
    shardings = TrainState(None, *(param_sharding_tree(mesh41, t) for t in (
        tmpl.params, tmpl.opt_state, tmpl.residuals)))
    on41, _, at = restore_checkpoint(ck, tmpl, shardings=shardings)
    whole_tree, _, _ = restore_checkpoint(ck, tmpl)
    mgr = CheckpointManager(os.path.join(out, "ck_async"), async_save=True)
    mgr.save(2, st, {"rank": rank})
    mgr.wait()                        # rank 0's writer, then every rank
    by_mgr, extra, _ = mgr.restore(tmpl)
    res["restore"] = {
        "at": at, "manager": _bitwise(by_mgr, st) + (
            [] if extra == {"rank": 0} else [f"extra {extra}"]),
        "mesh41": _bitwise(on41, st), "unsharded": _bitwise(whole_tree, st),
        "sizes41": _local_sizes(on41.params, mesh41)}
    return res


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def stage_fn(p, x):
    return torch.tanh(x @ p["w"]) + p["b"]


def pipeline_worker(rank, world, out, w, b, x):
    """``pipeline_apply`` over 4 stage ranks (S 4, M 4) and over a (2, 2)
    ('stage', 'data') mesh (S 2, M 4)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    xt = torch.from_numpy(x)
    out = {}
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
    out[4] = pipeline_apply(mesh, "stage", stage_fn, params, xt, 4).numpy()
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("stage", "data"))
    two = {k: v[:2] for k, v in params.items()}
    out[2] = pipeline_apply(mesh, "stage", stage_fn, two, xt, 4).numpy()
    return out
