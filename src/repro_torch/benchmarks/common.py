"""Shared benchmark utilities: timing, CSV emission and the check each
packed row makes of what it timed (the counterpart of
``benchmarks/common.py``).

``time_call`` is the port's ``obs.stats.time_call``, which waits for the
card's work, so a CUDA call is timed to its end.
"""

from __future__ import annotations

import json
import os

import torch

from .. import resolve_device
from ..configs import get_config
from ..kernels import ops
from ..kernels.ref import no_tf32
from ..obs.stats import time_call

__all__ = ["time_call", "emit", "check_packed", "OUT_DIR", "bench_config",
           "device_name", "write_json"]

# where the serving twins write their JSON and trace (never the
# repository root's BENCH_*.json or artifacts/, the reference's files)
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "bench_torch")

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


def bench_config(arch: str = "qwen2-0.5b", full: bool = False):
    """The serving twins' config: the reference's ``.reduced()`` one, or
    with ``full`` the published width and depth."""
    cfg = get_config(arch)
    return cfg if full else cfg.reduced()


def device_name(device) -> str:
    """What a result ran on: the card's name, or ``cpu``."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def write_json(results: dict, name: str, out_dir=None) -> str:
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    print(f"# wrote {os.path.normpath(path)}", flush=True)
    return path
