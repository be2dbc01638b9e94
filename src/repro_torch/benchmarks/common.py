"""Shared benchmark utilities: timing, CSV emission and the check each
packed row makes of what it timed (the counterpart of
``benchmarks/common.py``).

``time_call`` is the port's ``obs.stats.time_call``, which waits for the
card's work, so a CUDA call is timed to its end.
"""

from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.ref import no_tf32
from ..obs.stats import time_call

__all__ = ["time_call", "emit", "check_packed"]

# |err| / max|want|: f32 sums over K in another order (K <= 1024)
PACKED_RTOL = 1e-4


def emit(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def check_packed(name: str, x: torch.Tensor, t: ops.PackedTensor) -> None:
    """Hold one packed product against the dense product of the weight
    that the decode kernel materializes (``x @ ops.dequant(t)``, TF32
    off); raises if they differ by more than ``PACKED_RTOL``."""
    got = ops.packed_matmul(x, t)
    with no_tf32():
        want = x.float() @ ops.dequant(t)
    err = (got - want).abs().max().item()
    tol = PACKED_RTOL * want.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: packed product differs from "
                             f"x @ dequant(W) by {err:.3e} (tol {tol:.3e})")
