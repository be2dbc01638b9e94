"""Scale computation of the packed serving plane (the serving half of
``repro.core.quant``).

Scales are powers of two by default: a po2 scale is an exponent shift in
the XR-NPE datapath and keeps decode exact.  ``group_scales`` gives one
scale per (K-group, out-channel) of a (..., K, N) weight; ``None`` is the
per-channel case.  The arithmetic is the reference's, op for op, so the
po2 exponents agree exactly.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import formats as fmt
from .formats import FormatSpec

__all__ = ["max_finite", "format_scale", "group_scales",
           "expand_group_scales"]

_TINY = 1e-30


@functools.lru_cache(maxsize=None)
def max_finite(spec: FormatSpec) -> float:
    if spec.kind == "native":
        return float(torch.finfo(fmt.torch_dtype(spec.dtype)).max)
    vals = fmt.code_values(spec)
    return float(np.nanmax(np.abs(vals[np.isfinite(vals)])))


def _resolve_method(spec: FormatSpec, method: str) -> str:
    if method == "auto":
        return "posit_rms" if spec.kind == "posit" else "absmax_po2"
    return method


def _po2_ceil(s: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.ceil(torch.log2(torch.clamp(s, min=_TINY))))


def _po2_round(s: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.round(torch.log2(torch.clamp(s, min=_TINY))))


def format_scale(spec: FormatSpec, w: torch.Tensor, method: str = "auto",
                 axis=None) -> torch.Tensor:
    """Per-tensor (axis=None) or per-channel scale mapping ``w`` into the
    format's range: posits centre the RMS on 1.0 (``posit_rms``), other
    formats map the absmax onto the largest finite value
    (``absmax_po2``; ``absmax`` without the po2 rounding).  The
    reference's ``entropy`` method (fixed-point QAT) is not ported."""
    method = _resolve_method(spec, method)
    w = w.float()
    keep = axis is not None
    if method in ("absmax", "absmax_po2"):
        a = torch.amax(torch.abs(w), dim=axis, keepdim=keep) if keep \
            else torch.amax(torch.abs(w))
        s = a / max_finite(spec)
        if method == "absmax_po2":
            s = _po2_ceil(s)
        return torch.clamp(s, min=_TINY)
    if method == "posit_rms":
        r = torch.sqrt(torch.mean(torch.square(w), dim=axis, keepdim=keep)
                       if keep else torch.mean(torch.square(w)))
        return torch.clamp(_po2_round(r), min=_TINY)
    raise ValueError(method)


def group_scales(spec: FormatSpec, w: torch.Tensor,
                 group_size: Optional[int],
                 method: str = "auto") -> torch.Tensor:
    """Per-(K-group, out-channel) scales (..., G, N) for ``w`` (..., K, N),
    G = ceil(K / group_size).  ``group_size`` None/0 or >= K is the
    per-channel case (G = 1).  Rows past K never enter a group's
    statistic."""
    *lead, k, n = w.shape
    if not group_size or group_size >= k:
        s = format_scale(spec, w, method, axis=-2)
        return torch.broadcast_to(s, tuple(lead) + (1, n))
    method = _resolve_method(spec, method)
    g = int(group_size)
    ngroups = -(-k // g)
    kp = ngroups * g
    w = w.float()
    if kp != k:
        w = torch.nn.functional.pad(w, (0, 0, 0, kp - k))
    wg = w.reshape(tuple(lead) + (ngroups, g, n))
    counts = torch.clamp(k - torch.arange(ngroups, device=w.device) * g,
                         1, g).float()
    counts = counts.reshape((1,) * len(lead) + (ngroups, 1))
    if method in ("absmax", "absmax_po2"):
        s = torch.amax(torch.abs(wg), dim=-2) / max_finite(spec)
        if method == "absmax_po2":
            s = _po2_ceil(s)
        return torch.clamp(s, min=_TINY)
    if method == "posit_rms":
        r = torch.sqrt(torch.sum(torch.square(wg), dim=-2) / counts)
        return torch.clamp(_po2_round(r), min=_TINY)
    raise ValueError(method)


def expand_group_scales(scales: torch.Tensor, group_size: Optional[int],
                        k: int) -> torch.Tensor:
    """(..., G, N) group scales -> per-row multiplier over ``k`` rows; G == 1
    is returned as is (it broadcasts)."""
    if scales.shape[-2] == 1:
        return scales
    return torch.repeat_interleave(scales, int(group_size), dim=-2)[..., :k, :]
