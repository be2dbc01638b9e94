"""The packed-weight data plane (the counterpart of ``repro.kernels.ops``).

``PackedTensor`` holds a weight as packed low-bit codes plus dequant
scales and a block mask, with the reference's fields and layout version:

  words  : (L..., Kp, Np/per) int32 -- the uint32 words of the reference,
           same bits
  scales : (L..., G, Np) f32 -- G = 1 per channel, else one row per K-group
  mask   : (L..., Kp/bk, Np/bn) int32 nonzero-block map
  shape  : logical (K, N) of one 2-D slice

``pack_tensor`` has the reference's two branches: a 2-D weight is padded
to the kernel blocks of ``default_blocks`` with a per-block mask; a
stacked (L, K, N) weight pads K to the group and N to the word, with one
gate per slice.  ``packed_matmul`` runs the RMMEC kernel on either, and
``dequant`` the decode kernel on one 2-D slice.  ``quire_dot`` is the
exact posit8 row dot of the SIMD-MAC engine plane, through the quire
kernel and one final rounding (``quire_combine``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core import codec as codec_mod
from ..core import quant
from ..core.formats import FormatSpec
from ..core.packing import lanes_per_word, pack, unpack
from . import codec as dequant_kernel
from . import quire_dot as quire_kernel
from .quire_dot import QUIRE_FRAC_BITS
from .rmmec_matmul import default_blocks, rmmec_matmul

__all__ = ["PackedTensor", "pack_tensor", "unpack_tensor", "to_dense",
           "packed_matmul", "quire_dot", "quire_combine", "dequant",
           "PACKED_TENSOR_VERSION"]

PACKED_TENSOR_VERSION = 2

# a 2-D weight of more elements packs in column slabs of about this many
# (its f32 intermediates stay a few GB: command-r-plus's 12288 x 256000
# read-out is 12.6 GB in f32)
PACK_SLAB = 1 << 26


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass
class PackedTensor:
    """A weight stored as packed low-bit codes + dequant scales."""

    words: torch.Tensor
    scales: torch.Tensor
    mask: torch.Tensor
    shape: Tuple[int, int]
    spec: FormatSpec
    group: Optional[int] = None
    version: int = PACKED_TENSOR_VERSION

    def __getitem__(self, i: int) -> "PackedTensor":
        """Slice ``i`` of a stacked tensor (the layer loop's view)."""
        return dataclasses.replace(self, words=self.words[i],
                                   scales=self.scales[i], mask=self.mask[i])

    def to(self, device) -> "PackedTensor":
        return dataclasses.replace(self, words=self.words.to(device),
                                   scales=self.scales.to(device),
                                   mask=self.mask.to(device))


def pack_tensor(spec: FormatSpec, w: torch.Tensor,
                group_size: Optional[int] = None,
                blocks: Optional[Tuple[int, int, int]] = None
                ) -> PackedTensor:
    """Quantize + pack a weight whose trailing two dims are (K, N), with
    the format's default scale method and per-(K-group, channel) scales
    (``group_size`` None: per channel).  A 2-D weight is padded to the
    kernel blocks ``(bm, bk, bn)`` (default ``default_blocks(spec)``),
    which also set the mask's granularity; a stacked one ignores them.
    A 2-D weight over ``PACK_SLAB`` elements packs in column slabs of
    whole N blocks: each code, scale and mask block depends on its own
    columns only, so the slabs concatenate to the whole pack."""
    if w.dim() < 2:
        raise ValueError("pack_tensor needs a trailing (K, N) matrix")
    lead, (k, n) = tuple(w.shape[:-2]), tuple(w.shape[-2:])
    per = lanes_per_word(spec.bits)
    g = int(group_size) if group_size else None
    if g is not None and g >= k:
        g = None                      # group=K: per-channel
    if w.dim() == 2:
        _, bk, bn = blocks or default_blocks(spec)
        if g is not None and bk % g:
            raise ValueError(f"K block {bk} not a multiple of group {g}")
        step = max(bn, PACK_SLAB // max(k, 1) // bn * bn)
        if n > step:
            parts = [pack_tensor(spec, w[:, c:c + step], group_size, blocks)
                     for c in range(0, n, step)]
            return dataclasses.replace(
                parts[0], shape=(k, n), **{
                    f: torch.cat([getattr(t, f) for t in parts], dim=-1)
                    for f in ("words", "scales", "mask")})
    else:
        bk, bn = (g or 1), per
    kp, np_ = _round_up(k, bk), _round_up(n, bn)

    scales = quant.group_scales(spec, w, g)
    codes = codec_mod.encode(
        spec, w.float() / quant.expand_group_scales(scales, g, k))
    codes = torch.nn.functional.pad(codes, (0, np_ - n, 0, kp - k))
    words = pack(codes, spec.bits)
    g_tot = kp // g if g is not None else 1
    scales_p = torch.nn.functional.pad(
        scales.float(), (0, np_ - n, 0, g_tot - scales.shape[-2]), value=1.0)
    if w.dim() == 2:
        blk = codes.reshape(kp // bk, bk, np_ // bn, bn)
        mask = (blk.abs().amax(dim=(1, 3)) > 0).to(torch.int32)
    else:
        mask = (codes.abs().amax(dim=(-2, -1), keepdim=True) > 0
                ).to(torch.int32)
    return PackedTensor(words, scales_p.contiguous(), mask, (k, n), spec, g)


def _expand_scales(t: PackedTensor, dtype=torch.float32) -> torch.Tensor:
    kp = t.words.shape[-2]
    return quant.expand_group_scales(t.scales.to(dtype),
                                     kp // t.scales.shape[-2], kp)


def to_dense(t: PackedTensor, dtype=torch.float32) -> torch.Tensor:
    """Decode a PackedTensor of any rank back to dense float."""
    n_padded = t.words.shape[-1] * lanes_per_word(t.spec.bits)
    codes = unpack(t.words, t.spec.bits, n_padded)
    w = codec_mod.decode(t.spec, codes, dtype=dtype)
    w = w[..., : t.scales.shape[-1]] * _expand_scales(t, dtype)
    return w[..., : t.shape[0], : t.shape[1]]


def unpack_tensor(t: PackedTensor) -> torch.Tensor:
    """2-D convenience alias of :func:`to_dense` (the reference keeps it
    for callers that predate the rank-generic path)."""
    return to_dense(t)


def packed_matmul(x: torch.Tensor, t: PackedTensor) -> torch.Tensor:
    """x (..., K) @ W for one 2-D packed slice -> (..., N) float32.  Group
    scales apply inside the K accumulation, per-channel scales once at
    the output."""
    if t.words.dim() != 2:
        raise ValueError("packed_matmul takes one 2-D slice; index a "
                         "stacked PackedTensor by layer first")
    k, n = t.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.float()
    out = rmmec_matmul(x2.contiguous(), t.words, t.scales, t.mask, t.spec, n)
    return out.reshape(*lead, n)


def dequant(t: PackedTensor, dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    """Materialize one 2-D PackedTensor to dense (K, N) through the
    decode kernel, in float32 or bfloat16 (a stacked tensor is indexed by
    layer first)."""
    if t.words.dim() != 2:
        raise ValueError("dequant takes one 2-D slice; index a stacked "
                         "PackedTensor by layer first")
    return dequant_kernel.dequant(t.words, t.scales, t.spec, *t.shape,
                                  dtype)


def quire_dot(a_codes: torch.Tensor, b_codes: torch.Tensor) -> torch.Tensor:
    """Bit-exact Posit(8,0) row-wise dot: (B, K) codes x2 -> (B,) f32."""
    hi, lo = quire_kernel.quire_dot(a_codes.to(torch.int32).contiguous(),
                                    b_codes.to(torch.int32).contiguous())
    return quire_combine(hi, lo)


def quire_combine(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Fold the two int32 quire limbs (B, 1) into (B,) f32 (the single
    final rounding)."""
    return hi[:, 0].float() + lo[:, 0].float() * (2.0 ** -QUIRE_FRAC_BITS)
