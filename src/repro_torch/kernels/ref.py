"""Plain PyTorch oracles of the kernels (the counterparts of
``repro.kernels.ref``): naive and readable, on any device.

Float32 products here run with TF32 off (``no_tf32``): posit16 carries
12 fraction bits, which TF32's 10 cannot hold.
"""

from __future__ import annotations

import contextlib
import math

import torch

from ..core import codec as codec_mod
from ..core import formats as fmt
from ..core import quant
from ..core.formats import FormatSpec
from ..core.packing import unpack

__all__ = ["no_tf32", "dequant_ref", "rmmec_matmul_ref", "dequant_kv_ref",
           "flash_decode_ref"]


@contextlib.contextmanager
def no_tf32():
    """Full-precision float32 matrix products inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _expand_scales(scales: torch.Tensor, k_rows: int) -> torch.Tensor:
    return quant.expand_group_scales(scales, k_rows // scales.shape[-2],
                                     k_rows)


def dequant_ref(w_words: torch.Tensor, scales: torch.Tensor,
                spec: FormatSpec, n: int) -> torch.Tensor:
    """Packed words (..., Kp, W) + scales (..., G, n) -> (..., Kp, n) f32."""
    codes = unpack(w_words, spec.bits, n)
    w = codec_mod.decode(spec, codes).float()
    return w * _expand_scales(scales.float(), codes.shape[-2])


def rmmec_matmul_ref(x: torch.Tensor, w_words: torch.Tensor,
                     scales: torch.Tensor, spec: FormatSpec,
                     n: int) -> torch.Tensor:
    """Unpack -> decode -> plain f32 product; the block mask is a no-op
    (gated blocks hold only zero codes), so the oracle ignores it."""
    w = dequant_ref(w_words, scales, spec, n)
    with no_tf32():
        return x.float() @ w[: x.shape[-1]]


def dequant_kv_ref(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(..., Dh) posit8 codes + (..., Gs) scales -> (..., Dh) f32."""
    dh, gs = codes.shape[-1], scale.shape[-1]
    x = codec_mod.decode(fmt.POSIT8, codes.to(torch.int32))
    return x * torch.repeat_interleave(scale.float(), dh // gs, dim=-1)


def flash_decode_ref(q, k_codes, k_scale, v_codes, v_scale, pos: int,
                     softcap: float = 0.0, pad=None) -> torch.Tensor:
    """Naive full-softmax oracle of the flash-decode kernel: dequantize
    the whole cache, one masked softmax over all of T."""
    dh = q.shape[-1]
    k = dequant_kv_ref(k_codes, k_scale)
    v = dequant_kv_ref(v_codes, v_scale)
    with no_tf32():
        s = torch.einsum("bkgd,btkd->bkgt", q.float(), k)
        s = s / math.sqrt(dh)
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        tpos = torch.arange(k_codes.shape[1], device=q.device)
        live = tpos[None, None, None, :] <= pos
        if pad is not None:
            live = live & (tpos[None, None, None, :] >=
                           pad.to(q.device)[:, None, None, None])
        s = torch.where(live, s, -1e30)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bkgt,btkd->bkgd", p, v)
