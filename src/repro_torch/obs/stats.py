"""Shared timing/percentile helpers for benches and telemetry (a copy of
``repro.obs.stats``; ``time_call`` waits for CUDA work instead of
JAX's ``block_until_ready``)."""

from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["time_call", "pctl_ms", "percentiles", "summarize"]


def time_call(fn, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median wall time of ``fn(*args)`` in microseconds.

    Synchronizes the device when the result holds a CUDA tensor, so
    launched device work is included in the measurement.
    """
    for _ in range(warmup):
        r = fn(*args)
        _block(r)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        r = fn(*args)
        _block(r)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


def _block(r) -> None:
    items = r if isinstance(r, (tuple, list)) else (r,)
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in items):
        torch.cuda.synchronize()


def pctl_ms(seconds: Sequence[float], q: float) -> float:
    """``q``-th percentile of a list of second-valued samples, in ms.

    Matches the historical bench expression
    ``float(np.percentile(xs, q) * 1e3)`` exactly (percentile first,
    then unit conversion).
    """
    return float(np.percentile(np.asarray(seconds, dtype=np.float64), q) * 1e3)


def percentiles(values: Sequence[float], qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
    """``{"p50": ..., "p95": ...}`` over raw samples (no unit change)."""
    arr = np.asarray(values, dtype=np.float64)
    return {f"p{g:g}": float(np.percentile(arr, g)) for g in qs}


def summarize(values: Sequence[float]) -> Dict[str, float]:
    """Count/mean/min/max plus p50/p95/p99 of raw samples."""
    arr = np.asarray(values, dtype=np.float64)
    if arr.size == 0:
        return {"n": 0}
    out = {
        "n": int(arr.size),
        "mean": float(arr.mean()),
        "min": float(arr.min()),
        "max": float(arr.max()),
    }
    out.update(percentiles(arr))
    return out
