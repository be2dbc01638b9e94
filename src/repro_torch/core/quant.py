"""Quantization machinery of the paper (eq. 3-7; the counterpart of
``repro.core.quant``).

  * entropy-based uniform quantization with learned saturation
    thresholds (eq. 3-5), the fixed-point comparison arm;
  * PACT, a parameterized clipping activation (eq. 6-7) with a trainable
    clipping threshold ``alpha``;
  * format fake-quantization: round a float tensor onto the FP4/posit
    value grid through a (power-of-two by default) scale, with a clipped
    straight-through estimator so QAT gradients flow;
  * the scales of the packed serving plane: ``group_scales`` gives one
    scale per (K-group, out-channel) of a (..., K, N) weight; ``None`` is
    the per-channel case.

Scales are powers of two by default: a po2 scale is an exponent shift in
the XR-NPE datapath and keeps decode exact.  The arithmetic is the
reference's, op for op, so the po2 exponents and the fake-quantized
values agree exactly.  The reference's ``jax.custom_vjp`` rules are
``torch.autograd.Function``s here.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import codec as codec_mod
from . import formats as fmt
from .formats import FormatSpec

__all__ = ["max_finite", "entropy_scale", "uniform_quantize", "pact",
           "pact_quantize", "format_scale", "group_scales",
           "expand_group_scales", "fake_quant", "fake_quant_stochastic"]

_TINY = 1e-30


@functools.lru_cache(maxsize=None)
def max_finite(spec: FormatSpec) -> float:
    if spec.kind == "native":
        return float(torch.finfo(fmt.torch_dtype(spec.dtype)).max)
    vals = fmt.code_values(spec)
    return float(np.nanmax(np.abs(vals[np.isfinite(vals)])))


# ---------------------------------------------------------------------------
# eq. 3-5: entropy-based uniform quantization with saturation thresholds
# ---------------------------------------------------------------------------

def entropy_scale(w: torch.Tensor, n: int) -> torch.Tensor:
    """eq. (3): scale k = mean(|W|) * (2^n - 1) / 2^(n-1)."""
    return torch.mean(torch.abs(w)) * ((2.0 ** n - 1.0) / (2.0 ** (n - 1)))


def uniform_quantize(w: torch.Tensor, n: int, w_l, w_h,
                     k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """eq. (4)+(5): clip to the learned [w_l, w_h] window, quantize to 2^n
    levels, dequantize."""
    if k is None:
        k = entropy_scale(w, n)
    levels = 2.0 ** n - 1.0
    w_hat = torch.round((torch.clamp(w / k, w_l, w_h) - w_l)
                        * (levels / (w_h - w_l)))
    return w_hat * ((w_h - w_l) / levels) + w_l


# ---------------------------------------------------------------------------
# eq. 6-7: PACT
# ---------------------------------------------------------------------------

def pact(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """eq. (6): y = 0.5 (|x| - |x - alpha| + alpha) == clip(x, 0, alpha)."""
    return 0.5 * (torch.abs(x) - torch.abs(x - alpha) + alpha)


class _PactQuant(torch.autograd.Function):
    """Rounding onto 2^n - 1 levels of [0, alpha]; backward: the STE
    through the rounding, and PACT's rule for alpha (the gradient flows
    to alpha where the input saturated)."""

    @staticmethod
    def forward(ctx, y, alpha, n: int):
        ctx.save_for_backward(y, alpha)
        levels = 2.0 ** n - 1.0
        return torch.round(y * (levels / alpha)) * (alpha / levels)

    @staticmethod
    def backward(ctx, g):
        y, alpha = ctx.saved_tensors
        saturated = (y >= alpha).to(g.dtype)
        return (g * (1.0 - saturated),
                torch.sum(g * saturated).to(alpha.dtype).reshape(alpha.shape),
                None)


def pact_quantize(x: torch.Tensor, alpha: torch.Tensor,
                  n: int) -> torch.Tensor:
    """eq. (6)+(7) with a trainable alpha (PACT's backward rule)."""
    return _PactQuant.apply(pact(x, alpha), alpha, n)


# ---------------------------------------------------------------------------
# scales
# ---------------------------------------------------------------------------

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
    (``absmax_po2``; ``absmax`` without the po2 rounding); ``entropy``
    is eq. (3) (the fixed-point arm)."""
    method = _resolve_method(spec, method)
    if method == "entropy":
        return entropy_scale(w, spec.bits)
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
        # entropy (a scalar) broadcasts to the per-channel layout too
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
    if method == "entropy":
        mean_abs = torch.sum(torch.abs(wg), dim=-2) / counts
        s = mean_abs * ((2.0 ** spec.bits - 1.0) / (2.0 ** (spec.bits - 1)))
        return torch.clamp(s, min=_TINY)
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


# ---------------------------------------------------------------------------
# format fake-quantization with a straight-through estimator (QAT forward)
# ---------------------------------------------------------------------------

class _FakeQuant(torch.autograd.Function):
    """quantize(x / scale) * scale; backward: the clipped STE (identity
    inside the representable range, zero outside) and a zero gradient for
    the scale, as the reference's ``_fq_bwd``."""

    @staticmethod
    def forward(ctx, x, scale, spec: FormatSpec):
        ctx.save_for_backward(x, scale)
        ctx.spec = spec
        return codec_mod.quantize(spec, x / scale) * scale

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        lim = max_finite(ctx.spec) * scale
        inside = (torch.abs(x) <= lim).to(g.dtype)
        return g * inside, torch.zeros_like(scale), None


def fake_quant(spec: FormatSpec, x: torch.Tensor,
               scale: Optional[torch.Tensor] = None, method: str = "auto",
               group_size: Optional[int] = None) -> torch.Tensor:
    """Quantize-dequantize ``x`` onto ``spec``'s grid with an STE backward.

    The QAT forward: the value distribution the low-bit datapath will
    see, master weights staying fp32.  With ``group_size`` set (and
    ``x.dim() >= 2``) the scales are per K-group per out-channel, the
    packed serving plane's grouping.  A scale computed here is detached
    (the reference's ``stop_gradient``)."""
    if spec.kind == "native":
        return x.to(fmt.torch_dtype(spec.dtype)).to(x.dtype)
    if scale is None:
        with torch.no_grad():
            if group_size and x.dim() >= 2:
                gs = group_scales(spec, x, group_size, method)
                scale = expand_group_scales(gs, group_size, x.shape[-2])
            else:
                scale = format_scale(spec, x, method)
        scale = scale.detach()
    return _FakeQuant.apply(x, scale, spec)


def fake_quant_stochastic(spec: FormatSpec, x: torch.Tensor,
                          generator: torch.Generator,
                          scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Stochastic rounding onto the grid (gradient compression): round up
    or down with probability proportional to the distance, unbiased in
    expectation.  The uniform draws come from ``generator`` (JAX's PRNG
    stream cannot be reproduced: the distribution is the contract)."""
    if scale is None:
        scale = format_scale(spec, x, "absmax_po2")
    y = x / scale
    lo = codec_mod.quantize(spec, y)              # the RNE landing point
    eps = torch.where(y > lo, 1, -1)
    svals = torch.as_tensor(fmt._encode_tables(spec)[0].astype(np.float32),
                            device=x.device)
    idx = torch.searchsorted(svals, lo.float().contiguous())
    nxt = svals[torch.clamp(idx + eps, 0, len(svals) - 1)]
    gap = torch.abs(nxt - lo)
    p_up = torch.where(gap > 0,
                       torch.abs(y - lo) / torch.clamp(gap, min=_TINY), 0.0)
    u = torch.rand(y.shape, generator=generator, device=x.device)
    return torch.where(u < p_up, nxt, lo) * scale
