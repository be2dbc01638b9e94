"""Standalone SIMD decode (dequantization): packed words and po2 scales
to a dense f32 matrix (the counterpart of ``repro.kernels.codec``).

``dequant`` launches the CUDA kernel of ``csrc/dequant.cu`` on a CUDA
tensor and runs ``dequant_plain`` on a CPU tensor.  It takes one 2-D
slice of the packed layout exactly as ``ops.pack_tensor`` leaves it:
words (Kp, Np/per), scales (G, Np) per channel (G = 1) or per K-group
(G = Kp / group), and writes only the logical (K, N).  Each output is
``decode(code) * scale``, one f32 multiply, so kernel and plain version
agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.formats import FormatSpec
from ..core.packing import lanes_per_word
from . import _build
from . import ref
from .rmmec_matmul import KIND

__all__ = ["dequant", "dequant_plain"]


def dequant_plain(words: torch.Tensor, scales: torch.Tensor,
                  spec: FormatSpec, k: int, n: int) -> torch.Tensor:
    """The kernel's plain version: ``to_dense``'s arithmetic (decode to
    f32, times the expanded scale) cut to the logical (k, n)."""
    return ref.dequant_ref(words, scales, spec, scales.shape[-1])[:k, :n]


_ARGTYPES = {
    "dequant": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
    + [ctypes.c_void_p],
}


def _lib() -> ctypes.CDLL:
    return _build.bind("dequant", _ARGTYPES)


def dequant(words: torch.Tensor, scales: torch.Tensor, spec: FormatSpec,
            k: int, n: int) -> torch.Tensor:
    """Packed words (Kp, Np/per) int32 + scales (G, Np) f32 -> dense
    (k, n) f32, for k <= Kp and n <= Np."""
    if spec.kind not in KIND:
        raise ValueError(f"dequant has no decoder for {spec.name}")
    if words.dim() != 2 or scales.dim() != 2:
        raise ValueError("dequant takes one 2-D slice: words (Kp, W), "
                         "scales (G, Np)")
    if words.dtype != torch.int32 or scales.dtype != torch.float32:
        raise TypeError("words must be int32 and scales float32")
    kp = words.shape[0]
    np_ = words.shape[1] * lanes_per_word(spec.bits)
    g = scales.shape[0]
    if scales.shape[1] != np_ or g == 0 or kp % g or k > kp or n > np_:
        raise ValueError(
            f"inconsistent packed layout: words {tuple(words.shape)}, "
            f"scales {tuple(scales.shape)}, k={k}, n={n}")
    if words.device.type == "cpu":
        return dequant_plain(words, scales, spec, k, n)
    if words.device.type != "cuda":
        raise ValueError(f"dequant runs on cuda or cpu, not {words.device}")
    for name, t in (("words", words), ("scales", scales)):
        if t.device != words.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {words.device}")
    out = torch.empty((k, n), dtype=torch.float32, device=words.device)
    err = _lib().dequant(
        words.data_ptr(), scales.data_ptr(), out.data_ptr(), k, n, np_,
        kp // g if g > 1 else 0, KIND[spec.kind], spec.bits, spec.es,
        spec.ebits, spec.mbits, int(spec.has_nan), spec.frac_bits,
        torch.cuda.current_stream(words.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dequant launch failed: CUDA error {err}")
    dequant.launches += 1
    return out


dequant.launches = 0
