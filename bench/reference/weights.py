"""Seeded weights of a configuration, drawn on the device.

A model's weights are a few stacks of layers plus a few top-level
leaves.  Each slice of a stack (one layer) and the top-level leaves are
drawn by a generator of their own, seeded from the run's seed and the
slice's name, with one large call per distribution.  So any one layer
can be drawn again, alone and bit for bit, by whoever needs it: the
harness draws every layer once and hands it to the program to pack; the
reference draws each layer again when it reaches it.

A leaf is ``(path, shape, init)`` with ``init`` one of
``("uniform", bound)``, ``("normal", std)``, ``("ones",)``,
``("zeros",)`` or ``("log_arange",)`` (log 1..n along the last axis,
the S4D-real initialisation of a Mamba ``A``).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["Leaf", "slice_seed", "draw", "nest", "uniform", "normal"]

Leaf = Tuple[str, Tuple[int, ...], tuple]


def uniform(d_in: int) -> tuple:
    return ("uniform", 1.0 / math.sqrt(d_in))


def normal(std: float) -> tuple:
    return ("normal", std)


def slice_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for the slice ``name`` of run ``seed``."""
    digest = hashlib.blake2b(f"{int(seed)}/{name}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def draw(seed: int, name: str, leaves: List[Leaf],
         device) -> Dict[str, torch.Tensor]:
    """{path: float32 tensor} of one slice: every uniform leaf from one
    ``torch.rand`` call, then every normal leaf from one ``torch.randn``
    call, in the order listed."""
    gen = torch.Generator(device).manual_seed(slice_seed(seed, name))
    out: Dict[str, torch.Tensor] = {}
    for kind, fill in (("uniform", torch.rand), ("normal", torch.randn)):
        mine = [lf for lf in leaves if lf[2][0] == kind]
        if not mine:
            continue
        flat = fill(sum(_numel(s) for _, s, _ in mine), generator=gen,
                    device=device, dtype=torch.float32)
        at = 0
        for path, shape, init in mine:
            n = _numel(shape)
            t = flat[at:at + n].view(shape)
            at += n
            if kind == "uniform":
                out[path] = t.mul_(2.0 * init[1]).sub_(init[1])
            else:
                out[path] = t.mul_(init[1])
    for path, shape, init in leaves:
        if init[0] == "ones":
            out[path] = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            out[path] = torch.zeros(shape, device=device)
        elif init[0] == "log_arange":
            row = torch.log(torch.arange(1, shape[-1] + 1, device=device,
                                         dtype=torch.float32))
            out[path] = row.expand(shape).contiguous()
        elif init[0] not in ("uniform", "normal"):
            raise ValueError(f"unknown init {init!r} of {path}")
    return {path: out[path] for path, _, _ in leaves}


def nest(flat: Dict[str, object]) -> dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    tree: dict = {}
    for path, val in flat.items():
        node = tree
        keys = path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = val
    return tree
