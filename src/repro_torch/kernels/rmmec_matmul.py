"""RMMEC packed matrix product: x @ W with W stored as packed low-bit
codes (the counterpart of ``repro.kernels.rmmec_matmul``).

``rmmec_matmul`` launches the CUDA kernel of ``csrc/rmmec_matmul.cu`` on
a CUDA tensor and runs ``rmmec_matmul_plain`` on a CPU tensor.  It takes
the packed layout exactly as ``ops.pack_tensor`` leaves it: any K, Np a
multiple of the codes per word, scales per channel (G = 1) or per
K-group, and a block mask of any granularity that tiles (Kp, Np).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.formats import FormatSpec
from ..core.packing import lanes_per_word
from . import _build
from . import ref

__all__ = ["rmmec_matmul", "rmmec_matmul_plain", "default_blocks"]

KIND = {"posit": 0, "minifloat": 1, "fixed": 2}


def default_blocks(spec: FormatSpec) -> Tuple[int, int, int]:
    """(bm, bk, bn) of the 2-D kernel-padded layout, per precision mode
    (the reference's tiling; ``pack_tensor`` pads 2-D weights to it)."""
    if spec.bits <= 4:
        return (128, 1024, 256)
    if spec.bits <= 8:
        return (128, 512, 256)
    return (128, 512, 128)


def rmmec_matmul_plain(x: torch.Tensor, words: torch.Tensor,
                       scales: torch.Tensor, spec: FormatSpec,
                       n: int) -> torch.Tensor:
    """The kernel's plain version: dequantize, then an f32 product with
    TF32 off (the twin of ``ref.rmmec_matmul_ref``)."""
    return ref.rmmec_matmul_ref(x, words, scales, spec, scales.shape[-1])[:, :n]


_ARGTYPES = {
    "rmmec_matmul": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 15 + [ctypes.c_void_p],
}


def _lib() -> ctypes.CDLL:
    return _build.bind("rmmec_matmul", _ARGTYPES)


def _check(x, words, scales, mask, spec: FormatSpec, n: int):
    """Validate shapes/dtypes of one 2-D slice; returns (kp, np_, group)."""
    if spec.kind not in KIND:
        raise ValueError(f"rmmec_matmul has no decoder for {spec.name}")
    if x.dim() != 2 or words.dim() != 2 or scales.dim() != 2 \
            or mask.dim() != 2:
        raise ValueError("rmmec_matmul takes one 2-D slice: x (M, K), "
                         "words (Kp, W), scales (G, Np), mask (mk, mn)")
    if words.dtype != torch.int32 or mask.dtype != torch.int32 \
            or scales.dtype != torch.float32:
        raise TypeError("words and mask must be int32 and scales float32")
    kp = words.shape[0]
    np_ = words.shape[1] * lanes_per_word(spec.bits)
    g = scales.shape[0]
    if scales.shape[1] != np_ or kp % g or kp % mask.shape[0] \
            or np_ % mask.shape[1] or x.shape[1] > kp \
            or (n is not None and n > np_):
        raise ValueError(
            f"inconsistent packed layout: x {tuple(x.shape)}, words "
            f"{tuple(words.shape)}, scales {tuple(scales.shape)}, mask "
            f"{tuple(mask.shape)}, n={n}")
    return kp, np_, (kp // g if g > 1 else 0)


def rmmec_matmul(x: torch.Tensor, words: torch.Tensor, scales: torch.Tensor,
                 mask: torch.Tensor, spec: FormatSpec,
                 n: Optional[int] = None) -> torch.Tensor:
    """x (M, K) float32/bfloat16 @ packed W -> (M, n) float32.

    words (Kp, Np/per) int32, scales (G, Np) f32, mask (mk, mn) int32;
    ``n`` is the logical N (default Np)."""
    kp, np_, group = _check(x, words, scales, mask, spec, n)
    n = np_ if n is None else n
    if x.device.type == "cpu":
        return rmmec_matmul_plain(x, words, scales, spec, n)
    if x.device.type != "cuda":
        raise ValueError(f"rmmec_matmul runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    for name, t in (("x", x), ("words", words), ("scales", scales),
                    ("mask", mask)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    m, k = x.shape
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = _lib().rmmec_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), words.data_ptr(),
        scales.data_ptr(), mask.data_ptr(), out.data_ptr(), m, k, n, np_,
        group, kp // mask.shape[0], np_ // mask.shape[1], mask.shape[1],
        KIND[spec.kind], spec.bits, spec.es, spec.ebits, spec.mbits,
        int(spec.has_nan), spec.frac_bits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmmec_matmul launch failed: CUDA error {err}")
    rmmec_matmul.launches += 1
    return out


rmmec_matmul.launches = 0
