"""Device meshes over ``torch.distributed`` (the counterpart of
``repro.launch.mesh``).

The process group must be initialised first (``init_process_group``
with its address, world size and rank: nothing on a machine announces a
cluster).  Single pod: 16x16 = 256 cards ('data','model').  Multi-pod:
2x16x16 = 512 cards ('pod','data','model') -- the 'pod' axis is the
slow link; the batch shards across it (pure DP between pods) and FSDP
stays within a pod (see ``parallel/sharding.py``).
"""

from __future__ import annotations

from .. import resolve_device

__all__ = ["make_production_mesh", "make_host_mesh"]


def _mesh(shape, names, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A small ('data','model') mesh over the ranks of the process group
    (tests / local runs), the sizes clipped as the reference clips them
    to the devices present.  ``device``: None for the card, ``"cpu"``
    for a gloo group."""
    import torch.distributed as dist
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return _mesh((data, model), ("data", "model"), device)
