"""Codec registry -- the single dispatch point of the packed-weight data
plane (the counterpart of ``repro.core.codec``).

A ``Codec`` owns encode (float -> int32 codes) and decode (codes ->
float; NaR/NaN codes -> 0.0, the hardware exception path).  As in
the reference, the codec -- never its caller -- picks the table path for
tensors of at most ``_TABLE_MAX_ELEMS`` elements and the branch-free
path above that; the two are equal code for code.  The branch-free path
runs a tensor of more than ``_SLAB`` elements slab by slab (it is
elementwise, so the codes are the same), which bounds its ~20
temporaries of the tensor's size: an optimizer's moments of a stacked
layer leaf run to 10^8-10^9 elements.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Type

import torch

from . import formats as fmt
from .formats import FormatSpec

__all__ = ["Codec", "get_codec", "register_codec", "encode", "decode",
           "quantize"]

_REGISTRY: Dict[str, Type["Codec"]] = {}

_TABLE_MAX_ELEMS = 1 << 16
_SLAB = 1 << 26


def _by_slabs(fn, x: torch.Tensor) -> torch.Tensor:
    """The elementwise ``fn`` over ``x`` in slabs of ``_SLAB`` elements."""
    if x.numel() <= _SLAB:
        return fn(x)
    flat = x.reshape(-1)
    first = fn(flat[:_SLAB])
    out = first.new_empty(flat.shape)
    out[:_SLAB] = first
    for i in range(_SLAB, flat.numel(), _SLAB):
        out[i:i + _SLAB] = fn(flat[i:i + _SLAB])
    return out.reshape(x.shape)


def register_codec(kind: str) -> Callable[[Type["Codec"]], Type["Codec"]]:
    """Class decorator: route ``FormatSpec.kind == kind`` to this codec."""
    def deco(cls: Type["Codec"]) -> Type["Codec"]:
        _REGISTRY[kind] = cls
        return cls
    return deco


@functools.lru_cache(maxsize=None)
def get_codec(spec: FormatSpec) -> "Codec":
    try:
        cls = _REGISTRY[spec.kind]
    except KeyError:
        raise ValueError(f"no codec registered for format kind {spec.kind!r}"
                         ) from None
    return cls(spec)


class Codec:
    """encode/decode for one ``FormatSpec`` of a code-table kind."""

    def __init__(self, spec: FormatSpec):
        self.spec = spec

    @staticmethod
    def _prefer_table(x: torch.Tensor) -> bool:
        return x.numel() <= _TABLE_MAX_ELEMS

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        if self._prefer_table(x):
            return fmt.encode_table(self.spec, x)
        return _by_slabs(lambda v: fmt.encode_bits(self.spec, v), x)

    def decode(self, codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        if self._prefer_table(codes):
            return fmt.decode_table(self.spec, codes, dtype)
        return _by_slabs(lambda c: fmt.decode_bits(self.spec, c, dtype),
                         codes)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Round-trip onto the format's value grid (same dtype out)."""
        return self.decode(self.encode(x), dtype=torch.float32).to(x.dtype)


for _kind in ("posit", "minifloat", "fixed"):
    register_codec(_kind)(Codec)


@register_codec("native")
class NativeCodec(Codec):
    """Native dtypes: encode/decode are casts, no code table."""

    def encode(self, x):
        return x.to(fmt.torch_dtype(self.spec.dtype))

    def decode(self, codes, dtype=torch.float32):
        return codes.to(dtype)

    def quantize(self, x):
        return x.to(fmt.torch_dtype(self.spec.dtype)).to(x.dtype)


def encode(spec: FormatSpec, x: torch.Tensor) -> torch.Tensor:
    return get_codec(spec).encode(x)


def decode(spec: FormatSpec, codes: torch.Tensor,
           dtype=torch.float32) -> torch.Tensor:
    return get_codec(spec).decode(codes, dtype)


def quantize(spec: FormatSpec, x: torch.Tensor) -> torch.Tensor:
    return get_codec(spec).quantize(x)
