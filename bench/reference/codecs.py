"""Number formats, scales and the precision policy of the configurations,
written out plainly for the reference.

The configurations serve their weights under the paper's mixed policy
(``paper_mixed``): posit8 (es 0) for attention and output projections,
posit16 (es 1) for an untied read-out head, FP4 (e2m1) for every other
weight matrix, with one power-of-two scale per output column; norms,
biases, the embedding, the router and the small Mamba leaves stay as
they are.  The KV cache and the recurrent state are posit8 with one
power-of-two scale per row of their last axis.

Rounding is the posit standard's: to the nearest value, a tie to the
even code, saturation at the largest magnitude, and a non-zero value is
never rounded to zero.  FP4 rounds to the nearest value (ties to the
even code) and saturates at 6.  Subnormal float32 inputs count as zero.
Everything here works on values: the reference never sees a code.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import functools
from typing import Optional

import numpy as np
import torch

__all__ = ["Fmt", "POSIT8", "POSIT16", "FP4", "quantize", "weight_format",
           "quantize_weight", "quantize_rows", "max_finite"]


@dataclasses.dataclass(frozen=True)
class Fmt:
    name: str
    bits: int
    kind: str                # posit | minifloat
    es: int = 0
    ebits: int = 0
    mbits: int = 0


POSIT8 = Fmt("posit8_0", 8, "posit", es=0)
POSIT16 = Fmt("posit16_1", 16, "posit", es=1)
FP4 = Fmt("fp4", 4, "minifloat", ebits=2, mbits=1)
_BY_NAME = {f.name: f for f in (POSIT8, POSIT16, FP4)}

_TINY = 1e-30
_FLT_MIN = float(np.finfo(np.float32).tiny)
_CHUNK = 1 << 24


def _posit_value(code: int, n: int, es: int) -> float:
    """Exact value of an n-bit posit code (NaR as NaN)."""
    mask = (1 << n) - 1
    code &= mask
    if code == 0:
        return 0.0
    if code == 1 << (n - 1):
        return float("nan")
    sign = 1.0
    if code >> (n - 1):
        sign, code = -1.0, (-code) & mask
    body = code & ((1 << (n - 1)) - 1)
    b = n - 1
    first = (body >> (b - 1)) & 1
    run = 0
    for i in range(b - 1, -1, -1):
        if (body >> i) & 1 != first:
            break
        run += 1
    k = run - 1 if first else -run
    rest = b - min(run + 1, b)
    eb = min(es, rest)
    e = (((body >> (rest - eb)) & ((1 << eb) - 1)) << (es - eb)) if eb else 0
    fbits = rest - eb
    frac = body & ((1 << fbits) - 1) if fbits else 0
    return sign * (1.0 + frac / (1 << fbits)) * 2.0 ** (k * (1 << es) + e)


def _minifloat_value(code: int, ebits: int, mbits: int) -> float:
    bias = (1 << (ebits - 1)) - 1
    sign = -1.0 if (code >> (ebits + mbits)) & 1 else 1.0
    e = (code >> mbits) & ((1 << ebits) - 1)
    m = code & ((1 << mbits) - 1)
    if e == 0:
        return sign * m / (1 << mbits) * 2.0 ** (1 - bias)
    return sign * (1.0 + m / (1 << mbits)) * 2.0 ** (e - bias)


def _value(f: Fmt, code: int, bits: Optional[int] = None) -> float:
    if f.kind == "posit":
        return _posit_value(code, bits or f.bits, f.es)
    return _minifloat_value(code, f.ebits, f.mbits)


@functools.lru_cache(maxsize=None)
def _grid(f: Fmt):
    """(sorted distinct finite values, the code of each, the rounding
    boundaries between neighbours): a posit's boundaries are the values
    of the (n+1)-bit codes between two neighbours, a minifloat's the
    arithmetic midpoints."""
    vals = np.array([_value(f, c) for c in range(1 << f.bits)])
    codes = np.arange(1 << f.bits)
    keep = np.isfinite(vals)
    vals, codes = vals[keep], codes[keep]
    order = np.argsort(vals, kind="stable")
    vals, codes = vals[order], codes[order]
    first = np.ones(len(vals), bool)
    first[1:] = vals[1:] != vals[:-1]
    codes[np.argmax(vals == 0.0)] = 0          # +0 and -0 are code 0
    vals, codes = vals[first], codes[first]
    if f.kind == "posit":
        n = f.bits
        signed = np.where(codes >= 1 << (n - 1), codes - (1 << n), codes)
        mids = (signed[:-1].astype(np.int64) << 1) + 1
        bnds = np.array([_posit_value(int(m) & ((1 << (n + 1)) - 1), n + 1,
                                      f.es) for m in mids])
    else:
        bnds = (vals[:-1] + vals[1:]) / 2.0
    return vals, codes, bnds


@functools.lru_cache(maxsize=None)
def _device_grid(f: Fmt, device: str):
    vals, codes, bnds = _grid(f)
    return (torch.as_tensor(vals.astype(np.float32), device=device),
            torch.as_tensor((codes & 1) == 0, device=device),
            torch.as_tensor(bnds.astype(np.float32), device=device))


def max_finite(f: Fmt) -> float:
    return float(_grid(f)[0][-1])


def _quantize_flat(f: Fmt, x: torch.Tensor) -> torch.Tensor:
    vals, even, bnds = _device_grid(f, str(x.device))
    x = torch.where(x.abs() < _FLT_MIN, 0.0, x)
    idx = torch.searchsorted(bnds, x, right=True)
    lower = (idx - 1).clamp(min=0)
    tie = (idx > 0) & (x == bnds[lower]) & even[lower]
    idx = torch.where(tie, lower, idx)
    out = vals[idx]
    if f.kind == "posit":
        tiny = vals[vals > 0][0]
        out = torch.where((x != 0) & (out == 0), torch.sign(x) * tiny, out)
    return out


def quantize(f: Fmt, x: torch.Tensor) -> torch.Tensor:
    """float32 values of ``x`` rounded onto the format's grid."""
    flat = x.float().reshape(-1).contiguous()
    out = torch.empty_like(flat)
    for i in range(0, flat.numel(), _CHUNK):
        out[i:i + _CHUNK] = _quantize_flat(f, flat[i:i + _CHUNK])
    return out.reshape(x.shape)


def _po2_ceil(s: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.ceil(torch.log2(s.clamp(min=_TINY))))


def _po2_round(s: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.round(torch.log2(s.clamp(min=_TINY))))


# the paper's mixed policy: leaves left as they are, then (glob, format)
# rules in order, then the default
_KEEP = ("*norm*", "*bias*", "*scale*", "*alpha*", "*embed*", "*rope*",
         "*state*", "*decay*", "*router*", "*d_skip*", "*conv_w*", "*a_log*",
         "*lora*", "*mix_*", "*bonus*", "*dt_proj*")
_RULES = (("*attn*", "posit8_0"), ("*out_proj*", "posit8_0"),
          ("*head*", "posit16_1"))
_MATRICES = ("/w", "experts/gate", "experts/up", "experts/down")


def weight_format(path: str, policy: str = "paper_mixed") -> Optional[Fmt]:
    """The format a weight leaf is served in, or None where it is served
    as it is drawn (vectors, norms, the embedding, kept leaves)."""
    if policy != "paper_mixed":
        raise ValueError(f"no such policy {policy!r}")
    if not any(path.endswith(s) for s in _MATRICES):
        return None
    if any(fnmatch.fnmatch(path, p) for p in _KEEP):
        return None
    for pat, name in _RULES:
        if fnmatch.fnmatch(path, pat):
            return _BY_NAME[name]
    return FP4


def quantize_weight(f: Fmt, w: torch.Tensor) -> torch.Tensor:
    """A (..., K, N) weight on the format's grid under one power-of-two
    scale per output column: a posit centres the column's RMS on 1.0
    (rounded to the nearest power of two), FP4 maps the column's largest
    magnitude onto its largest value (rounded up)."""
    w = w.float()
    if f.kind == "posit":
        s = _po2_round(torch.sqrt(torch.mean(w * w, dim=-2, keepdim=True)))
    else:
        s = _po2_ceil(w.abs().amax(dim=-2, keepdim=True) / max_finite(f))
    s = s.clamp(min=_TINY)
    return quantize(f, w / s) * s


def quantize_rows(x: torch.Tensor) -> torch.Tensor:
    """The posit8 cache and state format: one power-of-two scale per row
    of the last axis (its largest magnitude mapped under 64, rounded
    up)."""
    x = x.float()
    s = _po2_ceil(x.abs().amax(dim=-1, keepdim=True) / max_finite(POSIT8))
    s = s.clamp(min=_TINY)
    return quantize(POSIT8, x / s) * s
