"""Exact quire accumulation oracle (a copy of ``repro.core.quire``).

The XR-NPE accumulates posit products in a quire -- a wide fixed-point
register that makes the dot product exact up to the single final
rounding.  This module is the bit-exact reference of the port's
``quire_dot`` kernel: every posit value is a dyadic rational
``mant * 2**scale``, so products and sums are exact in unbounded Python
integers.  It is numpy and Python integers only, over the port's
``code_values``.
"""

from __future__ import annotations

import numpy as np

from .formats import FormatSpec, code_values

__all__ = ["value_as_fixed", "quire_dot_exact", "quire_matmul_exact"]


def value_as_fixed(spec: FormatSpec, code: int, lsb_pow: int) -> int:
    """Value of ``code`` as an integer multiple of ``2**lsb_pow`` (exact)."""
    v = float(code_values(spec)[code & (spec.ncodes - 1)])
    if np.isnan(v):
        return 0
    frac = v * (2.0 ** -lsb_pow)
    out = int(round(frac))
    if out != frac:
        raise ValueError(f"lsb 2^{lsb_pow} too coarse for {spec.name} value {v}")
    return out


def _min_lsb(spec: FormatSpec) -> int:
    """Power p such that every value of ``spec`` is a multiple of 2**p."""
    vals = code_values(spec)
    finite = vals[np.isfinite(vals) & (vals != 0)]
    # every posit/minifloat value is mant/2^F * 2^scale; brute-force p.
    for p in range(0, -200, -1):
        scaled = finite * (2.0 ** -p)
        if np.all(scaled == np.round(scaled)):
            return p
    raise ValueError(spec)


def quire_dot_exact(spec: FormatSpec, a_codes, b_codes) -> float:
    """Exact dot product of two 1-D code vectors, one final f64 rounding."""
    a_codes = np.asarray(a_codes).ravel()
    b_codes = np.asarray(b_codes).ravel()
    if a_codes.shape != b_codes.shape:
        raise ValueError(f"code vectors differ in length: {a_codes.shape} "
                         f"vs {b_codes.shape}")
    p = _min_lsb(spec)
    av = [value_as_fixed(spec, int(c), p) for c in a_codes]
    bv = [value_as_fixed(spec, int(c), p) for c in b_codes]
    acc = 0
    for x, y in zip(av, bv):
        acc += x * y  # exact: the quire
    return float(acc) * (2.0 ** (2 * p))


def quire_matmul_exact(spec: FormatSpec, a_codes, b_codes) -> np.ndarray:
    """Exact [M,K] x [K,N] over codes -> f64 result (reference only)."""
    a_codes = np.asarray(a_codes)
    b_codes = np.asarray(b_codes)
    m, k = a_codes.shape
    k2, n = b_codes.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {k} vs {k2}")
    p = _min_lsb(spec)
    table = code_values(spec).astype(np.float64)
    table = np.where(np.isnan(table), 0.0, table)
    ai = np.round(table[a_codes & (spec.ncodes - 1)] * 2.0 ** -p).astype(object)
    bi = np.round(table[b_codes & (spec.ncodes - 1)] * 2.0 ** -p).astype(object)
    ai = np.vectorize(int, otypes=[object])(ai)
    bi = np.vectorize(int, otypes=[object])(bi)
    out = np.empty((m, n), np.float64)
    for i in range(m):
        for j in range(n):
            acc = 0
            for t in range(k):
                acc += ai[i, t] * bi[t, j]
            out[i, j] = float(acc) * (2.0 ** (2 * p))
    return out
