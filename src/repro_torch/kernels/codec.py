"""Standalone SIMD decode (dequantization): packed words and po2 scales
to a dense f32 or bf16 matrix (the counterpart of ``repro.kernels.codec``).

``dequant`` launches the CUDA kernel of ``csrc/dequant.cu`` on a CUDA
tensor and runs ``dequant_plain`` on a CPU tensor.  It takes one 2-D
slice of the packed layout exactly as ``ops.pack_tensor`` leaves it:
words (Kp, Np/per), scales (G, Np) per channel (G = 1) or per K-group
(G = Kp / group), and writes only the logical (K, N).  Each output is
``decode(code) * scale``, one f32 multiply, so kernel and plain version
agree bit for bit.  A bf16 output is that product rounded to nearest
even (PyTorch's cast), written without the f32 matrix.

On the card ``dequant_plan`` picks the launch: the strip route (a block
of 8 warps per strip of 32 16-byte word vectors and band of rows, a grid
of about ``STRIP_BLOCKS_PER_SM`` blocks per SM) where a packed row is
whole 16-byte vectors and the words and scales start on 16-byte
boundaries, else the word route (a thread per word).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from ..core.formats import FormatSpec
from ..core.packing import lanes_per_word
from . import _build, fake
from . import ref
from .rmmec_matmul import H100_SMS, KIND, _sms

__all__ = ["dequant", "dequant_plain", "dequant_plan", "DequantPlan"]

ROUTES = {"word": 0, "strip": 1}   # the .cu's enum Route
STRIP_WARPS = 8         # warps of a strip block, one row each at a time
STRIP_VECS = 32         # 16-byte word vectors of a strip, one a lane
WORD_THREADS = 256      # threads of a word-route block
STRIP_BLOCKS_PER_SM = 4


class DequantPlan(NamedTuple):
    """The route, its grid (x, y) and threads a block."""
    route: str
    grid: Tuple[int, int]
    threads: int


def dequant_plan(k: int, n: int, np_: int, bits: int, aligned: bool = True,
                 sms: int = H100_SMS) -> DequantPlan:
    """The launch of a dequant of the logical (k, n) of a packed slice
    whose rows hold ``np_`` codes of ``bits`` bits, on a card of ``sms``
    SMs; ``aligned``: words and scales start on 16-byte boundaries
    (mirrors the C entry point)."""
    per = lanes_per_word(bits)
    if (np_ // per) % 4 == 0 and aligned:
        vecs = math.ceil(n / (4 * per))          # word vectors holding outputs
        strips = max(1, math.ceil(vecs / STRIP_VECS))
        bands = max(1, min(math.ceil(k / STRIP_WARPS),
                           math.ceil(sms * STRIP_BLOCKS_PER_SM / strips)))
        return DequantPlan("strip", (strips, bands), 32 * STRIP_WARPS)
    words = k * math.ceil(n / per)
    return DequantPlan("word", (max(1, math.ceil(words / WORD_THREADS)), 1),
                       WORD_THREADS)


def dequant_plain(words: torch.Tensor, scales: torch.Tensor,
                  spec: FormatSpec, k: int, n: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's plain version: ``to_dense``'s arithmetic (decode to
    f32, times the expanded scale) cut to the logical (k, n), cast to
    ``dtype``."""
    return ref.dequant_ref(words, scales, spec,
                           scales.shape[-1])[:k, :n].to(dtype)


_ARGTYPES = {
    "dequant": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 15
    + [ctypes.c_void_p],
}


def _lib() -> ctypes.CDLL:
    return _build.bind("dequant", _ARGTYPES)


def dequant(words: torch.Tensor, scales: torch.Tensor, spec: FormatSpec,
            k: int, n: int, dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    """Packed words (Kp, Np/per) int32 + scales (G, Np) f32 -> dense
    (k, n) of ``dtype`` (float32 or bfloat16), for k <= Kp and n <= Np."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dequant writes float32 or bfloat16, not {dtype}")
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
    if fake.is_fake(words):
        return fake.kernel_call("dequant", (k, n), dtype, words, float(k * n),
                                fake.nbytes((words, scales)))
    if words.device.type == "cpu":
        return dequant_plain(words, scales, spec, k, n, dtype)
    if words.device.type != "cuda":
        raise ValueError(f"dequant runs on cuda or cpu, not {words.device}")
    for name, t in (("words", words), ("scales", scales)):
        if t.device != words.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {words.device}")
    out = torch.empty((k, n), dtype=dtype, device=words.device)
    aligned = (words.data_ptr() | scales.data_ptr()) % 16 == 0
    plan = dequant_plan(k, n, np_, spec.bits, aligned, _sms(words.device))
    err = _lib().dequant(
        words.data_ptr(), scales.data_ptr(), out.data_ptr(), k, n, np_,
        kp // g if g > 1 else 0, KIND[spec.kind], spec.bits, spec.es,
        spec.ebits, spec.mbits, int(spec.has_nan), spec.frac_bits,
        ROUTES[plan.route], *plan.grid, int(dtype == torch.bfloat16),
        torch.cuda.current_stream(words.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dequant launch failed: CUDA error {err}")
    dequant.launches += 1
    return out


dequant.launches = 0
