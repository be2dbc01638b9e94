"""Turn parameters handed over as numpy into the port's tensors.

The JAX package's trees cross as nested dicts of numpy arrays, at any
depth (dense and MoE ``layers``, rwkv ``layers``, hybrid ``groups`` with
their ``b0..`` sub-blocks, caches and state trees alike).  A packed
tensor crosses as a dict with ``words`` (the uint32 words, or their
int32 view), ``scales``, ``mask``, ``shape``, ``spec`` (a format name)
and ``group``, whatever its leading dims (a stacked layer weight, or a
``(groups, experts, K, N)`` expert stack).  bfloat16 arrays (numpy's ``bfloat16`` extension dtype)
cross through a 16-bit integer view, so this module needs neither jax
nor ml_dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core.formats import format_by_name
from .kernels.ops import PackedTensor

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One array -> tensor with the same bits (uint32 -> int32 view,
    bfloat16 -> torch.bfloat16) on ``device`` (None: the card)."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)) \
            .view(torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device=None):
    """Nested dicts of numpy arrays (packed tensors as dicts with a
    ``spec`` key) -> the port's tree on ``device`` (None: the card)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        if "spec" in tree and "words" in tree:
            return PackedTensor(
                words=tensor_from_numpy(tree["words"], device),
                scales=tensor_from_numpy(tree["scales"], device).float(),
                mask=tensor_from_numpy(tree["mask"], device).to(torch.int32),
                shape=tuple(int(s) for s in tree["shape"]),
                spec=format_by_name(tree["spec"]),
                group=None if tree.get("group") is None
                else int(tree["group"]))
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
