"""Number formats of the XR-NPE SIMD datapath, in PyTorch.

The counterpart of ``repro.core.formats``: the same ``FormatSpec`` names
and fields, the same exact numpy code tables, and the same two
implementations of every codec operation --

  * table-based (``encode_table`` / ``decode_table``): every code value
    enumerated by an exact scalar decoder, ``searchsorted`` against the
    posit-standard rounding boundaries;
  * branch-free (``encode_bits`` / ``decode_bits``): integer bit algebra
    on ``int32`` tensors, code for code the reference's
    ``*_posit_bits`` / ``*_minifloat_bits``.

torch has no count-leading-zeros, so ``_clz_fixed`` takes the bit length
from ``torch.frexp`` of the (at most 15-bit, hence exactly representable)
integer.  torch's ``>>`` on ``int32`` is arithmetic: every shift below
is followed by a mask, or shifts a value known to be non-negative.
Decoders compute in float32 and cast at the end (exact for every format
whose values fit the target type).  Encoders flush float32 subnormal
inputs to zero first, as the reference's XLA arithmetic does on CPU and
TPU, so both packages give the same codes on every device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

__all__ = [
    "FormatSpec", "FORMATS", "FP4", "POSIT4", "POSIT8", "POSIT16",
    "FP8_E4M3", "FP8_E5M2", "FXP4", "FXP8", "BF16", "FP16", "FP32",
    "format_by_name", "simd_lanes", "nar_code", "code_values", "torch_dtype",
    "encode_table", "decode_table", "encode_bits", "decode_bits",
    "decode_posit_bits", "decode_minifloat_bits", "encode_posit_bits",
    "encode_minifloat_bits",
]


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    """A (de)codable number format (fields as in the reference).

    kind: 'posit' (NaR at 1000...0), 'minifloat' (subnormals, saturating,
    NaN at the all-ones code only if ``has_nan``), 'fixed' (two's
    complement with ``frac_bits``) or 'native' (a torch dtype).
    """

    name: str
    bits: int
    kind: str
    es: int = 0
    ebits: int = 0
    mbits: int = 0
    has_nan: bool = False
    frac_bits: int = 0
    dtype: Optional[str] = None

    @property
    def ncodes(self) -> int:
        return 1 << self.bits


FP4 = FormatSpec("fp4", 4, "minifloat", ebits=2, mbits=1)
POSIT4 = FormatSpec("posit4_1", 4, "posit", es=1)
POSIT8 = FormatSpec("posit8_0", 8, "posit", es=0)
POSIT16 = FormatSpec("posit16_1", 16, "posit", es=1)
FP8_E4M3 = FormatSpec("fp8_e4m3", 8, "minifloat", ebits=4, mbits=3, has_nan=True)
FP8_E5M2 = FormatSpec("fp8_e5m2", 8, "minifloat", ebits=5, mbits=2, has_nan=True)
FXP4 = FormatSpec("fxp4", 4, "fixed", frac_bits=2)
FXP8 = FormatSpec("fxp8", 8, "fixed", frac_bits=4)
BF16 = FormatSpec("bf16", 16, "native", dtype="bfloat16")
FP16 = FormatSpec("fp16", 16, "native", dtype="float16")
FP32 = FormatSpec("fp32", 32, "native", dtype="float32")

FORMATS = {
    f.name: f
    for f in (FP4, POSIT4, POSIT8, POSIT16, FP8_E4M3, FP8_E5M2, FXP4, FXP8,
              BF16, FP16, FP32)
}

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32}


def format_by_name(name: str) -> FormatSpec:
    return FORMATS[name]


def torch_dtype(name: str) -> torch.dtype:
    return _TORCH_DTYPES[name]


def simd_lanes(spec: FormatSpec) -> int:
    """How many operands of this format fit one 16-bit XR-NPE SIMD lane."""
    return max(1, 16 // spec.bits)


def nar_code(spec: FormatSpec) -> int:
    if spec.kind == "posit":
        return 1 << (spec.bits - 1)
    if spec.kind == "minifloat" and spec.has_nan:
        return (1 << (spec.bits - 1)) - 1
    return 0


# ---------------------------------------------------------------------------
# Exact scalar decoders (numpy, run once per spec to build tables)
# ---------------------------------------------------------------------------

def _posit_value(code: int, n: int, es: int) -> float:
    mask = (1 << n) - 1
    code &= mask
    if code == 0:
        return 0.0
    if code == 1 << (n - 1):
        return float("nan")
    sign = -1.0 if code >> (n - 1) else 1.0
    if sign < 0:
        code = (-code) & mask
    body = code & ((1 << (n - 1)) - 1)
    b = n - 1
    r0 = (body >> (b - 1)) & 1
    m = 0
    for i in range(b - 1, -1, -1):
        if ((body >> i) & 1) == r0:
            m += 1
        else:
            break
    k = (m - 1) if r0 else -m
    rem = b - min(m + 1, b)
    eb = min(es, rem)
    e = ((body >> (rem - eb)) & ((1 << eb) - 1)) << (es - eb) if eb else 0
    fbits = rem - eb
    frac = body & ((1 << fbits) - 1) if fbits else 0
    scale = k * (1 << es) + e
    return sign * (1.0 + frac / (1 << fbits if fbits else 1)) * (2.0 ** scale)


def _minifloat_value(code: int, ebits: int, mbits: int, has_nan: bool) -> float:
    bias = (1 << (ebits - 1)) - 1
    sign = -1.0 if (code >> (ebits + mbits)) & 1 else 1.0
    e = (code >> mbits) & ((1 << ebits) - 1)
    m = code & ((1 << mbits) - 1)
    if has_nan and e == (1 << ebits) - 1 and m == (1 << mbits) - 1:
        return float("nan")
    if e == 0:
        return sign * (m / (1 << mbits)) * (2.0 ** (1 - bias))
    return sign * (1.0 + m / (1 << mbits)) * (2.0 ** (e - bias))


def _fixed_value(code: int, bits: int, frac_bits: int) -> float:
    if code >= 1 << (bits - 1):
        code -= 1 << bits
    return code / (1 << frac_bits)


@functools.lru_cache(maxsize=None)
def code_values(spec: FormatSpec) -> np.ndarray:
    """float32 value of every raw code, indexed by code. NaN marks NaR."""
    if spec.kind == "native":
        raise ValueError("native formats have no code table")
    vals = np.empty(spec.ncodes, np.float64)
    for c in range(spec.ncodes):
        if spec.kind == "posit":
            vals[c] = _posit_value(c, spec.bits, spec.es)
        elif spec.kind == "minifloat":
            vals[c] = _minifloat_value(c, spec.ebits, spec.mbits, spec.has_nan)
        elif spec.kind == "fixed":
            vals[c] = _fixed_value(c, spec.bits, spec.frac_bits)
        else:
            raise ValueError(spec.kind)
    return vals.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _encode_tables(spec: FormatSpec):
    """(sorted values, their codes, rounding boundaries) for the table
    encoder.  Posit boundaries are the values of the (n+1)-bit midpoint
    patterns (the posit standard); minifloat/fixed boundaries are
    arithmetic midpoints.  Ties go to the even code."""
    vals = code_values(spec).astype(np.float64)
    codes = np.arange(spec.ncodes, dtype=np.int32)
    finite = np.isfinite(vals)
    vals, codes = vals[finite], codes[finite]
    order = np.argsort(vals, kind="stable")
    vals, codes = vals[order], codes[order]
    keep = np.ones(len(vals), bool)
    keep[1:] = vals[1:] != vals[:-1]
    zmask = vals == 0.0
    if zmask.any():
        codes[np.argmax(zmask)] = 0
    vals, codes = vals[keep], codes[keep]
    if spec.kind == "posit":
        n, es = spec.bits, spec.es
        signed = np.where(codes >= (1 << (n - 1)), codes - (1 << n),
                          codes).astype(np.int64)
        mids = (signed[:-1] << 1) + 1
        bnds = np.array([_posit_value(int(m) & ((1 << (n + 1)) - 1),
                                      n + 1, es) for m in mids])
    else:
        bnds = (vals[:-1] + vals[1:]) / 2.0
    return vals, codes, bnds


@functools.lru_cache(maxsize=None)
def _device_tables(spec: FormatSpec, device: str):
    """Table tensors on ``device``: (decode table with NaR/NaN -> 0,
    sorted codes, float32 boundaries)."""
    vals = code_values(spec)
    dec = np.where(np.isfinite(vals), vals, 0.0).astype(np.float32)
    _, scodes, bnds = _encode_tables(spec)
    return (torch.as_tensor(dec, device=device),
            torch.as_tensor(scodes.astype(np.int64), device=device),
            torch.as_tensor(bnds.astype(np.float32), device=device))


_FLT_MIN = float(np.finfo(np.float32).tiny)
_FLT_MAX = float(np.finfo(np.float32).max)


def _flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """float32 view of ``x`` with subnormals (and -0.0) replaced by +0.0."""
    xf = x.float()
    return torch.where(xf.abs() < _FLT_MIN, 0.0, xf)


# ---------------------------------------------------------------------------
# Table path
# ---------------------------------------------------------------------------

def decode_table(spec: FormatSpec, codes: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Raw codes -> values by table lookup (NaR/NaN codes -> 0)."""
    table, _, _ = _device_tables(spec, str(codes.device))
    return table[codes.long() & (spec.ncodes - 1)].to(dtype)


def encode_table(spec: FormatSpec, x: torch.Tensor) -> torch.Tensor:
    """float -> nearest code (int32) by ``searchsorted`` over the float32
    rounding boundaries; ties to the even code; NaN -> NaR; saturating;
    posits never round a nonzero value to zero."""
    _, scodes, bnds = _device_tables(spec, str(x.device))
    xf = _flush_subnormals(x).contiguous()
    idx = torch.searchsorted(bnds, xf, right=True)   # in [0, len(bnds)]
    lower = torch.clamp(idx - 1, min=0)
    on_tie = (idx > 0) & (xf == bnds[lower])
    lower_even = (scodes[lower] & 1) == 0
    idx = torch.where(on_tie & lower_even, lower, idx)
    out = scodes[idx].to(torch.int32)
    if spec.kind == "posit":
        nonzero = (xf != 0) & (out == 0)
        out = torch.where(nonzero & (xf > 0), 1, out)
        out = torch.where(nonzero & (xf < 0), spec.ncodes - 1, out)
    return torch.where(torch.isnan(xf), nar_code(spec), out).to(torch.int32)


# ---------------------------------------------------------------------------
# Branch-free path (the RMMEC datapath; the CUDA kernels repeat it)
# ---------------------------------------------------------------------------

def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 2**e for integer ``e`` in the normal range."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _clz_fixed(x: torch.Tensor, width: int) -> torch.Tensor:
    """Count leading zeros of ``x`` (0 <= x < 2**width, width <= 24) seen
    as a ``width``-bit integer.  frexp(x) = m * 2**e with m in [0.5, 1)
    gives the bit length e exactly (frexp(0) has e = 0)."""
    _, e = torch.frexp(x.float())
    return torch.clamp(width - e.to(torch.int32), 0, width)


def decode_posit_bits(codes: torch.Tensor, n: int, es: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Vectorized posit decode with integer ops only; NaR -> 0."""
    c = codes.to(torch.int32) & ((1 << n) - 1)
    b = n - 1
    neg = (c >> b) & 1
    is_zero = c == 0
    is_nar = c == (1 << b)
    mag = torch.where(neg == 1, (1 << n) - c, c)
    body = mag & ((1 << b) - 1)
    r0 = (body >> (b - 1)) & 1
    t = torch.where(r0 == 1, ~body, body) & ((1 << b) - 1)
    m = _clz_fixed(t, b)
    k = torch.where(r0 == 1, m - 1, -m)
    rem = b - torch.clamp(m + 1, max=b)
    eb = torch.clamp(rem, max=es)
    if es > 0:
        e = torch.where(
            eb > 0,
            ((body >> torch.clamp(rem - eb, min=0)) & ((1 << es) - 1))
            << (es - eb),
            0)
    else:
        e = torch.zeros_like(body)
    fbits = rem - eb
    frac = body & ((1 << torch.clamp(fbits, min=0)) - 1)
    scale = k * (1 << es) + e
    mant = 1.0 + frac.float() * _pow2(-fbits)
    val = mant * _pow2(scale)
    val = torch.where(neg == 1, -val, val)
    return torch.where(is_zero | is_nar, 0.0, val).to(dtype)


def decode_minifloat_bits(codes: torch.Tensor, ebits: int, mbits: int,
                          dtype=torch.float32,
                          has_nan: bool = False) -> torch.Tensor:
    """Vectorized minifloat decode (subnormal-aware); NaN codes -> 0."""
    n = 1 + ebits + mbits
    c = codes.to(torch.int32) & ((1 << n) - 1)
    bias = (1 << (ebits - 1)) - 1
    sign = torch.where(((c >> (ebits + mbits)) & 1) == 1, -1.0, 1.0)
    e = (c >> mbits) & ((1 << ebits) - 1)
    m = (c & ((1 << mbits) - 1)).float()
    sub = e == 0
    mant = torch.where(sub, m / (1 << mbits), 1.0 + m / (1 << mbits))
    scale = torch.where(sub, 1 - bias, e - bias)
    val = sign * (mant * _pow2(scale))
    if has_nan:
        is_nan = (e == (1 << ebits) - 1) & \
            ((c & ((1 << mbits) - 1)) == (1 << mbits) - 1)
        val = torch.where(is_nan, 0.0, val)
    return val.to(dtype)


def encode_posit_bits(x: torch.Tensor, n: int, es: int) -> torch.Tensor:
    """Branch-free posit encode, exact RNE: regime|exponent|13-bit
    mantissa in one int32, rounded once at the final width with guard and
    sticky bits; saturates to +-maxpos, nonzero underflow to +-minpos."""
    b = n - 1
    xf = _flush_subnormals(x)
    neg = xf < 0
    a = torch.clamp(xf.abs(), max=_FLT_MAX)      # +-inf saturate
    is_zero = a == 0
    is_nan = torch.isnan(xf)
    m, ex = torch.frexp(torch.where(is_zero | is_nan, 1.0, a))
    scale = ex.to(torch.int32) - 1
    maxscale = (n - 2) << es
    lo_clamp = scale < -maxscale
    hi_clamp = scale > maxscale
    scale = torch.clamp(scale, -maxscale, maxscale)
    k = scale >> es
    e = scale - (k << es)
    r = torch.where(k >= 0, k + 2, 1 - k)
    pattern = torch.where(
        k >= 0, ((1 << torch.clamp(k + 1, 0, 30)) - 1) << 1, 1)
    m23 = torch.round((2.0 * m - 1.0) * (1 << 23)).to(torch.int32)
    m13 = m23 >> 10
    st0 = (m23 & 1023) != 0
    v = (pattern << (es + 13)) | (e << 13) | m13
    drop = r + es + 13 - b
    keep = v >> drop
    guard = (v >> (drop - 1)) & 1
    low_mask = (1 << torch.clamp(drop - 1, 0, 30)) - 1
    sticky = ((v & low_mask) != 0) | st0
    up = guard & (sticky | ((keep & 1) != 0)).to(torch.int32)
    body = torch.clamp(keep + up, 1, (1 << b) - 1)
    body = torch.where(lo_clamp, 1, body)
    body = torch.where(hi_clamp, (1 << b) - 1, body)
    code = torch.where(neg, ((1 << n) - body) & ((1 << n) - 1), body)
    code = torch.where(is_zero, 0, code)
    return torch.where(is_nan, 1 << b, code).to(torch.int32)


def encode_minifloat_bits(x: torch.Tensor, ebits: int, mbits: int,
                          has_nan: bool = False) -> torch.Tensor:
    """Branch-free minifloat encode with subnormals, RNE and saturation.
    NaN maps to the NaN code, or to code 0 in a format without one (what
    the reference's table path returns, and its XLA path converts to)."""
    xf = _flush_subnormals(x)
    neg = xf < 0
    a = xf.abs()
    is_nan = torch.isnan(xf)
    bias = (1 << (ebits - 1)) - 1
    emax = (1 << ebits) - 1
    top_m = (1 << mbits) - (2 if has_nan else 1)
    max_fin = (1.0 + top_m / (1 << mbits)) * (2.0 ** (emax - bias))
    a = torch.where(is_nan, 0.0, torch.clamp(a, max=max_fin))
    _, e0 = torch.frexp(torch.where(a == 0, 1.0, a))
    ex = torch.clamp(e0.to(torch.int32) - 1, 1 - bias, emax - bias)
    q = torch.round(a * _pow2(mbits - ex)).to(torch.int32)
    bump = q >= (1 << (mbits + 1))
    ex = torch.where(bump, ex + 1, ex)
    q = torch.where(bump, 1 << mbits, q)
    over = ex > emax - bias
    ex = torch.clamp(ex, max=emax - bias)
    sub = q < (1 << mbits)
    e_field = torch.where(sub, 0, ex + bias)
    m_field = torch.where(sub, q, q - (1 << mbits))
    m_field = torch.where(over, top_m, m_field)
    e_field = torch.where(over, emax, e_field)
    code = (neg.to(torch.int32) << (ebits + mbits)) | (e_field << mbits) \
        | m_field
    nan_code = ((1 << (ebits + mbits)) - 1) if has_nan else 0
    return torch.where(is_nan, nan_code, code).to(torch.int32)


def encode_bits(spec: FormatSpec, x: torch.Tensor) -> torch.Tensor:
    """Branch-free encode dispatch."""
    if spec.kind == "posit":
        return encode_posit_bits(x, spec.bits, spec.es)
    if spec.kind == "minifloat":
        return encode_minifloat_bits(x, spec.ebits, spec.mbits, spec.has_nan)
    if spec.kind == "fixed":
        xf = _flush_subnormals(x)
        q = torch.clamp(torch.round(xf * (1 << spec.frac_bits)),
                        -(spec.ncodes // 2), spec.ncodes // 2 - 1)
        q = torch.where(torch.isnan(xf), 0.0, q)
        return q.to(torch.int32) & (spec.ncodes - 1)
    raise ValueError(f"no bit encoder for {spec.kind}")


def decode_bits(spec: FormatSpec, codes: torch.Tensor,
                dtype=torch.float32) -> torch.Tensor:
    """Branch-free decode dispatch."""
    if spec.kind == "posit":
        return decode_posit_bits(codes, spec.bits, spec.es, dtype)
    if spec.kind == "minifloat":
        return decode_minifloat_bits(codes, spec.ebits, spec.mbits, dtype,
                                     spec.has_nan)
    if spec.kind == "fixed":
        c = codes.to(torch.int32) & (spec.ncodes - 1)
        c = torch.where(c >= spec.ncodes // 2, c - spec.ncodes, c)
        return (c.float() / (1 << spec.frac_bits)).to(dtype)
    raise ValueError(f"no bit decoder for {spec.kind}")
