"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) on
``torch.distributed`` device meshes (the counterpart of
``repro.parallel.sharding``).

The name -> axis rules are the reference's, as pure Python: a spec is a
tuple with one entry per tensor dim, each ``None``, a mesh axis name or
a tuple of names (the entries of the reference's ``PartitionSpec``).
They read only a mesh's axis names and sizes, so they take a torch
``DeviceMesh`` or any object with ``axis_names`` and ``devices.shape``
(the tests hand both packages one stand-in).

Axis conventions (single pod mesh ('data','model'), multi-pod
('pod','data','model')):

  batch   -> ('pod','data')   data parallel across pods + within pod
  seq     -> None normally; ('pod','data') for SP long-context decode
  heads/ff/vocab/experts -> 'model'   tensor/expert parallel
  params: in-dim 'data' (FSDP), out-dim 'model'; Megatron pairing
  exceptions shard the *contraction* dim of the second matmul by 'model'.

Any rule whose axis does not evenly divide the tensor dim is dropped for
that tensor -- production meshes must never hard-fail on a model shape.

On a mesh a spec becomes DTensor placements (:func:`placements`).  The
sharded train step keeps activations local: inside :func:`use_mesh` a
plain tensor holds this rank's rows of the batch, weights are gathered
one layer at a time (:func:`gather`), and the few batch-wide reductions
of the model (the loss's token sums, the MoE load-balance statistics)
go through :func:`batch_sum`.  ``shard`` annotations are therefore
no-ops on plain tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import math
from typing import Optional, Sequence

import torch

__all__ = [
    "ACT_RULES", "DATA_AXES", "use_mesh", "current_mesh", "shard",
    "param_pspec", "param_sharding_tree", "logical_pspec", "batch_pspec",
    "cache_pspec", "paged_cache_pspec", "cache_sharding_tree",
    "split_devices", "NamedSharding", "placements", "place", "gather",
    "whole", "part", "batch_sum", "batch_ranks", "batch_rows",
]

# the ambient mesh is process-wide, not thread-local: autograd runs a
# checkpoint's recompute on its own device threads
_ambient = {"mesh": None}

# logical activation axis -> mesh axes (tried in order, dropped if indivisible)
ACT_RULES = {
    "batch": ("pod", "data"),
    "batch_nopod": ("data",),
    "seq_sp": ("pod", "data"),     # sequence parallelism for long context
    "seq": (),
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "capacity": (),
    "state": (),
    None: (),
}

DATA_AXES = ("pod", "data")


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh: ``shard`` annotations and
    :func:`batch_sum` read it."""
    prev = _ambient["mesh"]
    _ambient["mesh"] = mesh
    try:
        yield mesh
    finally:
        _ambient["mesh"] = prev


def current_mesh():
    return _ambient["mesh"]


def _axis_names(mesh):
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def _mesh_axes(mesh) -> dict:
    devices = getattr(mesh, "devices", None)
    shape = devices.shape if devices is not None else tuple(mesh.shape)
    return dict(zip(_axis_names(mesh), shape))


def _one(axes):
    """A list of mesh axes as one spec entry."""
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def _resolve(mesh, dim: int, logical: Optional[str], used: set):
    """Logical name -> the mesh axes that evenly divide ``dim``.  Axes
    already claimed by another dim of the same tensor are skipped (a
    mesh axis may shard at most one dim)."""
    axes = _mesh_axes(mesh)
    out = []
    prod = 1
    for a in ACT_RULES.get(logical, ()):
        if a in axes and a not in used and dim % (prod * axes[a]) == 0:
            out.append(a)
            prod *= axes[a]
    used.update(out)
    return _one(out)


def logical_pspec(mesh, shape: Sequence[int],
                  logical: Sequence[Optional[str]]) -> tuple:
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} and logical names "
                         f"{tuple(logical)} differ in length")
    used: set = set()
    return tuple(_resolve(mesh, d, n, used) for d, n in zip(shape, logical))


def shard(x, *logical: Optional[str]):
    """Constrain an activation's layout by logical names.  A plain tensor
    holds this rank's part already and comes back unchanged; a DTensor
    is redistributed to the spec on its mesh."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(
        mesh, logical_pspec(mesh, x.shape, logical)))


def split_devices(devices=None, prefill_frac: float = 0.5):
    """Split a device list into (prefill, decode) slices for
    disaggregated serving (``serve/disagg.py``); ``None`` is every CUDA
    card.  ``prefill_frac`` of the devices go to the prefill worker (at
    least one each side).  With a SINGLE device both workers share it."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not devices:
        raise RuntimeError("split_devices: no devices (no CUDA card)")
    if len(devices) == 1:
        return devices, devices
    cut = min(max(int(len(devices) * prefill_frac), 1), len(devices) - 1)
    return devices[:cut], devices[cut:]


def batch_pspec(mesh) -> tuple:
    return (_one([a for a in DATA_AXES if a in _axis_names(mesh)]),)


# ---------------------------------------------------------------------------
# Parameter sharding rules (path + shape based)
# ---------------------------------------------------------------------------

# paths whose *contraction* dim is model-sharded (Megatron row-parallel:
# the second matmul of each pair)
_ROW_PARALLEL = ("*wo*", "*down*", "*out_proj*", "*o_proj*", "*w2*")
# paths that are expert-stacked: leading (post-layer-stack) dim is experts
_EXPERT = ("*experts*",)
# paths stacked over layers (leading dim = n_layers)
_LAYER_STACKED = ("layers/*", "*/layers/*", "groups/*", "*/groups/*")
# embedding tables: (vocab, embed); lm_head (embed, vocab) takes the
# default column-parallel rule
_EMBED = ("*embedding*", "*embed/table*")
# 1-D / small params: replicate.  A PackedTensor's '*scales*' and
# '*mask*' land here (every shard's kernel needs the full N stripe of
# scales); its 'words' follow the matrix rules
_REPLICATED_SUFFIX = ("*norm*", "*bias*", "*alpha*", "*scale*", "*dt*",
                      "*decay*", "*a_log*", "*conv*", "*mask*", "*mix_*",
                      "*bonus*", "*count*")


def _match(path: str, pats) -> bool:
    return any(fnmatch.fnmatch(path, p) for p in pats)


def param_pspec(mesh, path: str, shape: Sequence[int]) -> tuple:
    """The spec of one parameter from its path + shape."""
    nd = len(shape)
    if nd == 0:
        return ()
    specs: list = [None] * nd
    dims = list(range(nd))
    if _match(path, _LAYER_STACKED) and nd >= 2:
        dims = dims[1:]  # leading layer-stack dim: never sharded
    if _match(path, _REPLICATED_SUFFIX) or len(dims) <= 1:
        return tuple(specs)
    axes = _mesh_axes(mesh)

    def fit(dim_idx: int, axis: str) -> bool:
        return axis in axes and shape[dim_idx] % axes[axis] == 0 and \
            specs[dim_idx] is None and axis not in specs

    if _match(path, _EXPERT):
        # (E, in, out): EP on experts, FSDP on in-dim
        if fit(dims[0], "model"):
            specs[dims[0]] = "model"
        if len(dims) >= 2 and fit(dims[1], "data"):
            specs[dims[1]] = "data"
        return tuple(specs)
    if _match(path, _EMBED):
        # (vocab, embed): TP on vocab, FSDP on embed
        if fit(dims[0], "model"):
            specs[dims[0]] = "model"
        if len(dims) >= 2 and fit(dims[-1], "data"):
            specs[dims[-1]] = "data"
        return tuple(specs)
    if _match(path, _ROW_PARALLEL):
        # (in, out): contraction dim on 'model', out on 'data'
        if fit(dims[0], "model"):
            specs[dims[0]] = "model"
        if fit(dims[-1], "data"):
            specs[dims[-1]] = "data"
        return tuple(specs)
    # default column-parallel: in-dim FSDP('data'), out-dim TP('model')
    if fit(dims[-1], "model"):
        specs[dims[-1]] = "model"
    if fit(dims[0], "data"):
        specs[dims[0]] = "data"
    return tuple(specs)


class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``); a leaf of
    the trees :func:`param_sharding_tree` and
    :func:`cache_sharding_tree` return."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self):
        return f"NamedSharding({self.spec})"


def _rebuild(node, specs, path=""):
    """``node``'s structure with each leaf the sharding ``specs[path]``; a
    PackedTensor keeps its aux and holds shardings in place of its
    words, scales and mask."""
    if isinstance(node, dict):
        return {k: _rebuild(v, specs, f"{path}/{k}" if path else k)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, specs, f"{path}/{i}" if path else
                                   str(i)) for i, v in enumerate(node))
    if node is None:
        return None
    if hasattr(node, "words") and hasattr(node, "scales"):
        return dataclasses.replace(node, words=specs[f"{path}/words"],
                                   scales=specs[f"{path}/scales"],
                                   mask=specs[f"{path}/mask"])
    return specs[path]


def param_sharding_tree(mesh, params):
    """The tree of :class:`NamedSharding` matching ``params`` (tensors or
    anything with a ``shape``)."""
    from ..core.policy import flatten_with_paths
    specs = {p: NamedSharding(mesh, param_pspec(mesh, p, v.shape))
             for p, v in flatten_with_paths(params)}
    return _rebuild(params, specs)


# ---------------------------------------------------------------------------
# Decode-cache sharding rules
# ---------------------------------------------------------------------------

def _fit_axes(shape: Sequence[int], axes: dict, dim_idx: int, names) -> list:
    """Greedily stack mesh axes onto ``shape[dim_idx]`` while the dim
    stays divisible -- the divisibility rule of the cache planes
    (contiguous and paged)."""
    got = []
    prod = 1
    for a in names:
        if a in axes and shape[dim_idx] % (prod * axes[a]) == 0:
            got.append(a)
            prod *= axes[a]
    return got


def cache_pspec(mesh, path: str, shape: Sequence[int], batch: int) -> tuple:
    """Spec of a KV-cache / SSM-state leaf (stacked over layers on dim
    0).  The batch dim shards on ('pod','data') when divisible; when the
    batch is too small (B=1) the longest remaining dim (the sequence)
    takes the data axes instead."""
    nd = len(shape)
    specs: list = [None] * nd
    axes = _mesh_axes(mesh)
    bdim = next((i for i in range(1, nd) if shape[i] == batch), None)
    data_axes = [a for a in DATA_AXES if a in axes]
    placed_data = False
    if bdim is not None:
        got = _fit_axes(shape, axes, bdim, data_axes)
        if got:
            specs[bdim] = _one(got)
            placed_data = True
    if not placed_data and nd >= 3:
        cand = max(range(1, nd), key=lambda i: shape[i])
        got = _fit_axes(shape, axes, cand, data_axes)
        if got and specs[cand] is None:
            specs[cand] = _one(got)
    # 'model' on the innermost (head/feature) dim that divides
    if "model" in axes:
        for i in reversed(range(1, nd)):
            if specs[i] is None and shape[i] % axes["model"] == 0:
                specs[i] = "model"
                break
    return tuple(specs)


def paged_cache_pspec(mesh, path: str, shape: Sequence[int]) -> tuple:
    """Spec of a PAGED decode-cache leaf.  Pool pages and state slabs
    replicate across the data axes (any request's gather may touch any
    page); 'model' rides the innermost head/feature dim that divides.
    ``page_table`` / ``slab_table`` / ``positions`` shard their request
    dim on the data axes."""
    key = path.rsplit("/", 1)[-1]
    axes = _mesh_axes(mesh)
    nd = len(shape)
    specs: list = [None] * nd
    if key in ("page_table", "slab_table", "positions"):
        specs[0] = _one(_fit_axes(shape, axes, 0,
                                  [x for x in DATA_AXES if x in axes]))
        return tuple(specs)
    if "model" in axes:
        for i in reversed(range(min(3, nd - 1), nd)):
            if shape[i] % axes["model"] == 0:
                specs[i] = "model"
                break
    return tuple(specs)


def cache_sharding_tree(mesh, cache, batch: int):
    from ..core.policy import flatten_with_paths
    flat = flatten_with_paths(cache)
    paged = any(p.rsplit("/", 1)[-1] in ("page_table", "slab_table")
                for p, _ in flat)
    specs = {p: NamedSharding(mesh, paged_cache_pspec(mesh, p, v.shape)
                              if paged else
                              cache_pspec(mesh, p, v.shape, batch))
             for p, v in flat}
    return _rebuild(cache, specs)


# ---------------------------------------------------------------------------
# Specs on torch meshes: DTensor placements
# ---------------------------------------------------------------------------

def placements(mesh, spec: tuple) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where the mesh axis
    shards tensor dim d, else ``Replicate()``.  Axes stacked on one dim
    split it in mesh order, major to minor, as the reference's tuple
    entries do."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for a in _axis_names(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _from_whole(t: torch.Tensor, mesh, pl):
    """The whole tensor ``t`` (the same on every rank) as a DTensor with
    placements ``pl``: each rank keeps a copy of its part (what
    ``distribute_tensor`` keeps, with no communication), so the whole
    tensor is not held alive by a view.  The specs only shard dims their
    axes divide, so every part has the same shape."""
    from torch.distributed.tensor import DTensor, Shard
    coord = mesh.get_coordinate()
    local = t
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    local = t.contiguous() if local is t else \
        local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, pl, run_check=False)


def place(t: torch.Tensor, sharding: NamedSharding):
    """The whole tensor ``t`` (the same on every rank) laid out by
    ``sharding``."""
    return _from_whole(t, sharding.mesh,
                       placements(sharding.mesh, sharding.spec))


def whole(node):
    """A tree's DTensor leaves gathered whole (no autograd); anything
    else as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(node, dict):
        return {k: whole(v) for k, v in node.items()}
    if isinstance(node, DTensor):
        return node.full_tensor()
    return node


def part(node, like):
    """``node`` (whole tensors) laid out as the matching leaves of
    ``like``: a DTensor leaf's rank keeps its part, a plain leaf takes
    the whole tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(node, dict):
        return {k: part(v, like[k]) for k, v in node.items()}
    if isinstance(like, DTensor):
        return _from_whole(node, like.device_mesh, like.placements)
    return node


def gather(node):
    """A tree's DTensor leaves gathered whole for the forward.  In the
    backward each leaf's gradient is summed over the data axes (each
    data rank saw its own rows) and taken as it is along the model axis
    (every model rank computed the same rows), then reduced to the
    leaf's shards.  Plain tensors pass through."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if isinstance(node, dict):
        return {k: gather(v) for k, v in node.items()}
    if isinstance(node, DTensor):
        names = _axis_names(node.device_mesh)
        return node.full_tensor(grad_placements=[
            Partial() if a in DATA_AXES else Replicate() for a in names])
    return node


def _data_groups(mesh):
    """The process groups of the mesh's data axes of size > 1."""
    axes = _mesh_axes(mesh)
    return [mesh.get_group(a) for a in DATA_AXES
            if a in axes and axes[a] > 1]


def batch_ranks() -> int:
    """How many ranks share the batch's rows under the ambient mesh (the
    product of its data axes; 1 outside a mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    axes = _mesh_axes(mesh)
    return math.prod(axes[a] for a in DATA_AXES if a in axes)


class _AllReduce(torch.autograd.Function):
    """A sum over a process group whose backward sums the gradients the
    same way (every rank's result feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks that hold the batch's other rows (the
    data axes of the ambient mesh), differentiably; ``x`` itself outside
    a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return x
    for group in _data_groups(mesh):
        x = _AllReduce.apply(x, group)
    return x


def batch_rows(mesh, n: int) -> slice:
    """The rows of an ``n``-row global batch this rank holds by
    :func:`batch_pspec`: a contiguous block by its data coordinate."""
    axes = _mesh_axes(mesh)
    names = _axis_names(mesh)
    coord = mesh.get_coordinate()
    idx, ranks = 0, 1
    for a in DATA_AXES:
        if a in axes:
            idx = idx * axes[a] + coord[names.index(a)]
            ranks *= axes[a]
    if n % ranks:
        raise ValueError(f"a batch of {n} rows does not split over "
                         f"{ranks} data ranks")
    b = n // ranks
    return slice(idx * b, (idx + 1) * b)
