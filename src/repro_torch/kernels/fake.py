"""The hand kernels on fake tensors: what a kernel wrapper returns when
``FakeTensorMode`` (the dry run, ``launch/dryrun.py``) hands it tensors
that hold no data.

Such a call neither launches the CUDA kernel (a fake tensor's pointer is
no address) nor runs the plain version (which would decode every packed
weight to f32, something the card never does).  It returns an empty
output of the kernel's shape and dtype and reports one op to each
recorder entered with :func:`recording`: the kernel's name, its FLOPs
and its bytes (each operand read once, the output written once: the
bytes bound of ``PERF.md``).  A real tensor never takes this branch.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["is_fake", "recording", "kernel_call", "kernel_write", "nbytes"]

# recorders entered by ``recording``: each has ``kernel(name, flops,
# nbytes)``; a list, so nested recorders all see the call
_RECORDERS: list = []


def is_fake(t: torch.Tensor) -> bool:
    return isinstance(t, FakeTensor)


@contextlib.contextmanager
def recording(recorder):
    """Report every fake kernel call to ``recorder`` while inside."""
    _RECORDERS.append(recorder)
    try:
        yield recorder
    finally:
        _RECORDERS.remove(recorder)


def nbytes(ts: Iterable[Optional[torch.Tensor]]) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def kernel_call(name: str, shape, dtype: torch.dtype, like: torch.Tensor,
                flops: float, read_bytes: int) -> torch.Tensor:
    """An empty ``shape`` tensor of ``dtype`` on ``like``'s device, the
    result of one launch of kernel ``name`` that does ``flops`` and reads
    ``read_bytes``; each recorder gets one op with the written bytes
    added."""
    out = torch.empty(shape, dtype=dtype, device=like.device)
    kernel_write(name, flops, int(read_bytes) + nbytes([out]))
    return out


def kernel_write(name: str, flops: float, moved: int) -> None:
    """One launch of kernel ``name`` that returns nothing (it writes its
    operands in place), doing ``flops`` and moving ``moved`` bytes (read
    and written); each recorder gets one op."""
    for r in _RECORDERS:
        r.kernel(name, float(flops), int(moved))
