"""Quire-exact Posit(8,0) row dot (the counterpart of
``repro.kernels.quire_dot``).

The XR-NPE accumulates posit products in a quire (wide fixed point), so
a dot product rounds exactly once.  ``quire_dot`` returns each row's
exact sum S as two int32 limbs, ``hi = floor(S)`` and
``lo = frac(S) * 2**QUIRE_FRAC_BITS`` -- the canonical limbs the
reference leaves after its last carry fold -- and the single rounding
happens outside, in ``ops.quire_combine``.  It launches the CUDA kernel
of ``csrc/quire_dot.cu`` on a CUDA tensor and runs ``quire_dot_plain``
on a CPU tensor.  No padding is needed: the (8, 512) blocks of
``repro.kernels.ops.quire_dot`` were the TPU's.

On the card ``quire_route`` picks the kernel: a block per row with
16-byte loads, or the same loop with 4-byte loads where rows are not
whole 16-byte vectors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..core import formats as fmt
from . import _build, fake

__all__ = ["QUIRE_FRAC_BITS", "quire_dot", "quire_dot_plain", "quire_route"]

QUIRE_FRAC_BITS = 22   # lsb of the lo limb = 2^-22
_PROD_FRAC_BITS = 12   # lsb of a posit8 product: 2^-6 * 2^-6

ROUTES = {"row": 0, "scalar": 1}   # the .cu's enum Route


def quire_route(k: int, aligned: bool = True) -> str:
    """The kernel for rows of ``k`` codes (one block a row either way);
    ``aligned``: both operands start on 16-byte boundaries (mirrors the C
    entry point)."""
    return "row" if k % 4 == 0 and aligned else "scalar"


@functools.lru_cache(maxsize=None)
def _code_units(device: str) -> torch.Tensor:
    """int64 value of every posit8 code in units of 2^-6 (NaR -> 0)."""
    vals = fmt.code_values(fmt.POSIT8).astype(np.float64)
    units = np.where(np.isnan(vals), 0.0, vals) * 64.0
    return torch.as_tensor(units.astype(np.int64), device=device)


def quire_dot_plain(a_codes: torch.Tensor, b_codes: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: the same limbs from int64 tensor
    arithmetic over the integer code table."""
    table = _code_units(str(a_codes.device))
    s = (table[a_codes.long() & 0xFF] * table[b_codes.long() & 0xFF]).sum(-1)
    hi = s >> _PROD_FRAC_BITS
    lo = (s - (hi << _PROD_FRAC_BITS)) << (QUIRE_FRAC_BITS - _PROD_FRAC_BITS)
    return hi.to(torch.int32)[:, None], lo.to(torch.int32)[:, None]


_ARGTYPES = {
    "quire_dot": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}


def _lib() -> ctypes.CDLL:
    return _build.bind("quire_dot", _ARGTYPES)


def quire_dot(a_codes: torch.Tensor, b_codes: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, K) int32 posit8 codes -> (hi, lo) int32 limbs, each
    (B, 1); row i's exact value is hi[i] + lo[i] * 2**-22."""
    if a_codes.dim() != 2 or a_codes.shape != b_codes.shape:
        raise ValueError(f"quire_dot takes two (B, K) code matrices, not "
                         f"{tuple(a_codes.shape)} and {tuple(b_codes.shape)}")
    if a_codes.dtype != torch.int32 or b_codes.dtype != torch.int32:
        raise TypeError("codes must be int32")
    if fake.is_fake(a_codes):
        bsz, kdim = a_codes.shape
        limbs = fake.kernel_call("quire_dot", (bsz, 2), torch.int32,
                                 a_codes, 2.0 * bsz * kdim,
                                 fake.nbytes((a_codes, b_codes)))
        return limbs[:, :1], limbs[:, 1:]
    if a_codes.device.type == "cpu":
        return quire_dot_plain(a_codes, b_codes)
    if a_codes.device.type != "cuda":
        raise ValueError(f"quire_dot runs on cuda or cpu, not "
                         f"{a_codes.device}")
    for name, t in (("a_codes", a_codes), ("b_codes", b_codes)):
        if t.device != a_codes.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {a_codes.device}")
    bsz, kdim = a_codes.shape
    hi = torch.empty((bsz, 1), dtype=torch.int32, device=a_codes.device)
    lo = torch.empty((bsz, 1), dtype=torch.int32, device=a_codes.device)
    aligned = (a_codes.data_ptr() | b_codes.data_ptr()) % 16 == 0
    err = _lib().quire_dot(
        a_codes.data_ptr(), b_codes.data_ptr(), hi.data_ptr(), lo.data_ptr(),
        bsz, kdim, ROUTES[quire_route(kdim, aligned)],
        torch.cuda.current_stream(a_codes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quire_dot launch failed: CUDA error {err}")
    quire_dot.launches += 1
    return hi, lo


quire_dot.launches = 0
