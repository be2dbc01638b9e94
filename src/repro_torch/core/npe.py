"""XR-NPE engine facade: semantics emulation of the SIMD-MAC datapath
(the counterpart of ``repro.core.npe``).

The software twin of the paper's Fig. 3 datapath, used by the benchmarks
and faithfulness tests: given packed operand words and a ``prec_sel``
mode, it runs the four stages -- input processing (decode + exception
handling), multiplication, accumulation, output -- and reports the
power-gating statistics the paper's dark-silicon argument rests on
(fraction of MACs skipped because an operand is zero).

The production path is ``kernels.rmmec_matmul``; this facade trades
speed for introspection.  Every tensor it makes lies on the device of
its operands.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import codec
from . import formats as fmt
from .formats import FormatSpec
from .packing import lanes_per_word, unpack

__all__ = ["NPEStats", "simd_mac", "simd_dot_packed", "PREC_SEL"]

# prec_sel register encoding (paper: mode signal selecting the datapath)
PREC_SEL = {
    0: fmt.FP4,       # 4x FP4 per 16-bit lane
    1: fmt.POSIT4,    # 4x Posit(4,1)
    2: fmt.POSIT8,    # 2x Posit(8,0)
    3: fmt.POSIT16,   # 1x Posit(16,1)
}


@dataclasses.dataclass
class NPEStats:
    """Observable engine counters (what the paper's Table II rests on)."""
    macs_total: int
    macs_gated: int          # zero-operand power-gated multiplies
    lanes_per_word: int
    operand_bits: int
    packed_bytes: int        # memory bytes of the operands
    dense_bytes: int         # fp32 equivalent

    @property
    def gating_fraction(self) -> float:
        return self.macs_gated / max(self.macs_total, 1)

    @property
    def ai_gain_vs_fp32(self) -> float:
        return self.dense_bytes / max(self.packed_bytes, 1)


def simd_mac(acc: torch.Tensor, a_codes: torch.Tensor, b_codes: torch.Tensor,
             spec: FormatSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SIMD MAC step: acc += decode(a) * decode(b), with zero-operand
    gating (zeros feed the accumulator unchanged, as in the paper).

    Returns (acc, gated_mask)."""
    a = codec.decode(spec, a_codes)
    b = codec.decode(spec, b_codes)
    gated = (a_codes == 0) | (b_codes == 0)
    prod = torch.where(gated, 0.0, a * b)
    return acc + prod, gated


def simd_dot_packed(a_words: torch.Tensor, b_words: torch.Tensor, k: int,
                    prec_sel: int) -> Tuple[torch.Tensor, NPEStats]:
    """Dot product over packed operand streams at mode ``prec_sel``.

    a_words/b_words: (W,) int32 packed streams holding ``k`` codes each.
    Returns (result f32 scalar on the words' device, NPEStats)."""
    spec = PREC_SEL[prec_sel]
    a_codes = unpack(a_words, spec.bits, k)
    b_codes = unpack(b_words, spec.bits, k)
    acc = torch.zeros((1,), dtype=torch.float32, device=a_words.device)
    acc, gated = simd_mac(acc, a_codes, b_codes, spec)
    result = torch.sum(acc)
    stats = NPEStats(
        macs_total=k,
        macs_gated=int(gated.sum()),
        lanes_per_word=lanes_per_word(spec.bits),
        operand_bits=spec.bits,
        packed_bytes=(a_words.numel() + b_words.numel()) * 4,
        dense_bytes=2 * k * 4,
    )
    return result, stats
