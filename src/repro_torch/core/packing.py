"""SIMD word packing: 8x4b / 4x8b / 2x16b codes per 32-bit word,
little-endian within the word, along the last axis (zero padded).

The reference stores ``uint32`` words; the port stores the same bits in
an ``int32`` tensor.  A code shifted into bit 31 would overflow int32, so
words are assembled in int64 and wrapped; unpacking masks after every
(arithmetic) shift.
"""

from __future__ import annotations

import torch

__all__ = ["WORD_BITS", "lanes_per_word", "packed_last_dim", "pack", "unpack"]

WORD_BITS = 32


def lanes_per_word(bits: int) -> int:
    if WORD_BITS % bits:
        raise ValueError(f"{bits}-bit codes do not tile a {WORD_BITS}-bit word")
    return WORD_BITS // bits


def packed_last_dim(k: int, bits: int) -> int:
    per = lanes_per_word(bits)
    return (k + per - 1) // per


def _shifts(bits: int, device) -> torch.Tensor:
    return torch.arange(lanes_per_word(bits), device=device) * bits


def pack(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """int codes [..., K] -> int32 words [..., ceil(K/per)]."""
    per = lanes_per_word(bits)
    k = codes.shape[-1]
    kp = packed_last_dim(k, bits) * per
    if kp != k:
        codes = torch.nn.functional.pad(codes, (0, kp - k))
    c = codes.to(torch.int64) & ((1 << bits) - 1)
    c = c.reshape(codes.shape[:-1] + (kp // per, per))
    words = (c << _shifts(bits, codes.device)).sum(-1)   # disjoint bit fields
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def unpack(words: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """int32 words [..., W] -> int32 codes [..., k]."""
    c = (words[..., None] >> _shifts(bits, words.device).to(torch.int32)) \
        & ((1 << bits) - 1)
    c = c.reshape(words.shape[:-1] + (words.shape[-1] * lanes_per_word(bits),))
    return c[..., :k].to(torch.int32)
