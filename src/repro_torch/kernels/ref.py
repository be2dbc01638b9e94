"""Plain PyTorch oracles of the kernels (the counterparts of
``repro.kernels.ref``): naive and readable, on any device.

Float32 products here run with TF32 off (``no_tf32``): posit16 carries
12 fraction bits, which TF32's 10 cannot hold.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch

from ..core import codec as codec_mod
from ..core import formats as fmt
from ..core import quant
from ..core.formats import FormatSpec
from ..core.packing import unpack

__all__ = ["no_tf32", "dequant_ref", "rmmec_matmul_ref", "quire_dot_ref",
           "scale_cols", "kv_scale_cols", "quantize_kv", "quantize_kv_many",
           "dequant_kv_ref",
           "flash_decode_ref", "paged_flash_decode_ref", "paged_prefill_ref"]


@contextlib.contextmanager
def no_tf32():
    """Full-precision float32 matrix products and convolutions inside the
    block (cuDNN's convolutions default to TF32)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


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


def quire_dot_ref(a_codes: torch.Tensor, b_codes: torch.Tensor) -> torch.Tensor:
    """Row-wise posit8 dot in float64, NaR as 0: (B, K) codes x2 -> (B,).
    float64 holds every posit8 product exactly and sums of < 2^40 of
    them without rounding, so this matches the integer quire bit for bit
    in that regime."""
    vals = fmt.code_values(fmt.POSIT8).astype(np.float64)
    table = torch.as_tensor(np.where(np.isnan(vals), 0.0, vals),
                            device=a_codes.device)
    a = table[a_codes.long() & 0xFF]
    b = table[b_codes.long() & 0xFF]
    return (a * b).sum(-1)


def scale_cols(scale: torch.Tensor, dh: int) -> torch.Tensor:
    """(..., Gs) KV scales -> one multiplier per column (..., Dh); each
    scale repeats over its Dh / Gs columns (an expand, so no host sync)."""
    *lead, gs = scale.shape
    return scale[..., None].expand(*lead, gs, dh // gs).reshape(*lead, dh)


def kv_scale_cols(head_dim: int, group_size: Optional[int]) -> int:
    """Scale columns per (token, head): Dh/group, or 1 when the group is
    None, does not divide Dh, or is >= Dh."""
    if not group_size or group_size >= head_dim or head_dim % group_size:
        return 1
    return head_dim // group_size


def quantize_kv(k: torch.Tensor, group_size: Optional[int] = None):
    """Posit8 codes (..., Dh) uint8 and po2 scales (..., Gs) bf16 of a KV
    tensor, through the weight plane's ``group_scales`` grid (the plain
    version of ``kernels.kv_write``'s quantization)."""
    return quantize_kv_many([k], [group_size])[0]


def quantize_kv_many(tensors, groups):
    """``quantize_kv`` of several tensors (each with its own group), the
    elementwise encode run once over all of them: the same bytes as one
    call per tensor, in a third of the launches for a three-leaf state."""
    scales, scaled = [], []
    for k, group_size in zip(tensors, groups):
        dh = k.shape[-1]
        gs = kv_scale_cols(dh, group_size)
        g = None if gs == 1 else group_size
        s = quant.group_scales(fmt.POSIT8, k[..., None].float(), g,
                               method="absmax_po2")[..., 0]
        scales.append(s)
        scaled.append((k.float() / scale_cols(s, dh)).reshape(-1))
    flat = scaled[0] if len(scaled) == 1 else torch.cat(scaled)
    codes = codec_mod.encode(fmt.POSIT8, flat).to(torch.uint8)
    out, at = [], 0
    for k, s in zip(tensors, scales):
        n = k.numel()
        out.append((codes[at:at + n].reshape(k.shape), s.to(torch.bfloat16)))
        at += n
    return out


def dequant_kv_ref(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(..., Dh) posit8 codes + (..., Gs) scales -> (..., Dh) f32."""
    x = codec_mod.decode(fmt.POSIT8, codes.to(torch.int32))
    return x * scale_cols(scale.float(), codes.shape[-1])


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


def _gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Pool (P, page, Kh, X) through a (B, NP) page table -> the
    request-contiguous (B, NP * page, Kh, X) cache."""
    b, npp = page_table.shape
    x = pool[page_table.long()]
    return x.reshape(b, npp * pool.shape[1], *pool.shape[2:])


def _gathered_kv(k_codes, k_scale, v_codes, v_scale, page_table):
    return (dequant_kv_ref(_gather_pages(k_codes, page_table),
                           _gather_pages(k_scale, page_table)),
            dequant_kv_ref(_gather_pages(v_codes, page_table),
                           _gather_pages(v_scale, page_table)))


def paged_flash_decode_ref(q, k_codes, k_scale, v_codes, v_scale, page_table,
                           positions, softcap: float = 0.0) -> torch.Tensor:
    """Naive oracle of the paged decode kernel: gather every request's
    pages into a contiguous cache, then one masked softmax per request
    at its own ``positions[b]``."""
    dh = q.shape[-1]
    k, v = _gathered_kv(k_codes, k_scale, v_codes, v_scale, page_table)
    with no_tf32():
        s = torch.einsum("bkgd,btkd->bkgt", q.float(), k) / math.sqrt(dh)
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        tpos = torch.arange(k.shape[1], device=q.device)
        live = tpos[None, None, None, :] <= positions[:, None, None, None]
        p = torch.softmax(torch.where(live, s, -1e30), dim=-1)
        return torch.einsum("bkgt,btkd->bkgd", p, v)


def paged_prefill_ref(q, k_codes, k_scale, v_codes, v_scale, page_table,
                      start, softcap: float = 0.0) -> torch.Tensor:
    """Naive oracle of the paged chunk-prefill kernel: gather, then one
    causally masked softmax per (request, chunk row) -- row ``i`` of
    request ``b`` attends to logical slots [0, start[b] + i].  q
    (B, C, Kh, G, Dh) -> (B, C, Kh, G, Dh) f32."""
    c, dh = q.shape[1], q.shape[-1]
    k, v = _gathered_kv(k_codes, k_scale, v_codes, v_scale, page_table)
    with no_tf32():
        s = torch.einsum("bqkgd,btkd->bkgqt", q.float(), k) / math.sqrt(dh)
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        qpos = start[:, None] + torch.arange(c, device=q.device)
        live = torch.arange(k.shape[1], device=q.device)[None, None, None,
                                                         None, :] \
            <= qpos[:, None, None, :, None]
        p = torch.softmax(torch.where(live, s, -1e30), dim=-1)
        return torch.einsum("bkgqt,btkd->bqkgd", p, v)
