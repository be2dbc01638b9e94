"""GPipe-style microbatch pipeline over a mesh axis (the counterpart of
``repro.parallel.pipeline``).

Layers are split into S contiguous stages; stage s lives on the ranks at
coordinate s of the ``axis``; microbatches flow through with the GPipe
schedule (S + M - 1 ticks).  Boundary activations go stage s -> s+1 with
point-to-point sends in the axis' process group, and the last stage's
result reaches every stage by an all-reduce of the one-hot masked
output (the reference's ``psum``).  It runs the forward; the sends are
not differentiated.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["pipeline_apply"]


def _stage_slice(t, stage: int):
    """Stage ``stage``'s slice of a leaf whose leading dim is the stage
    (a DTensor sharded on it holds that slice locally)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t.to_local()[0]
    return t[stage]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@torch.no_grad()
def pipeline_apply(mesh, axis: str, stage_fn: Callable, stage_params,
                   x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """Run ``stage_fn(params_s, x) -> x`` as an ``axis``-way pipeline.

    stage_params: tree whose leaves have leading dim = n_stages (stage
                  s's slice is used on stage s's ranks).
    x:            (batch, ...) global input, the same on every rank;
                  ``n_microbatches`` must divide the batch.
    Returns the final stage's output on every rank, equal to applying
    the stages in turn."""
    import torch.distributed as dist
    names = tuple(mesh.mesh_dim_names)
    dim = names.index(axis)
    n_stages = mesh.size(dim)
    stage = mesh.get_coordinate()[dim]
    if x.shape[0] % n_microbatches:
        raise ValueError(f"{n_microbatches} microbatches do not divide a "
                         f"batch of {x.shape[0]}")
    mb = x.shape[0] // n_microbatches
    params_s = _tree_map(lambda t: _stage_slice(t, stage), stage_params)
    group = mesh.get_group(axis)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)
    buf = x.new_zeros((mb,) + x.shape[1:])
    outs = x.new_zeros((n_microbatches, mb) + x.shape[1:])
    for t in range(n_stages + n_microbatches - 1):
        i = min(t, n_microbatches - 1)
        live_in = x[i * mb:(i + 1) * mb] \
            if stage == 0 and t < n_microbatches else buf
        y = stage_fn(params_s, live_in)
        out_idx = t - (n_stages - 1)
        if stage == n_stages - 1 and out_idx >= 0:
            outs[out_idx] = y
        # shift boundary activations s -> s+1 (a ring; what wraps into
        # stage 0 is ignored: it injects fresh microbatches)
        if n_stages > 1:
            buf = torch.empty_like(y)
            ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                   dist.P2POp(dist.irecv, buf, prv, group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        else:
            buf = y
    out = outs.reshape((n_microbatches * mb,) + x.shape[1:])
    out = out * float(stage == n_stages - 1)
    if n_stages > 1:
        dist.all_reduce(out, group=group)
    return out
