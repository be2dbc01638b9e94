"""Decode attention straight from a posit8 KV cache (the counterpart of
``repro.kernels.flash_decode.flash_decode_pallas``).

``flash_decode`` launches the CUDA kernel of ``csrc/flash_decode.cu`` on
a CUDA tensor and runs ``flash_decode_plain`` on a CPU tensor.  The plain
version is the twin of the reference's blocked XLA loop
(``repro.models.attention.decode_quantized_blocks``): an online softmax
over the ``ceil((pos+1)/blk)`` live KV blocks, each dequantized on its
own, with the -1e30 sentinel and the optional tanh softcap.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import dequant_kv_ref, no_tf32

__all__ = ["flash_decode", "flash_decode_plain", "default_kv_block"]

_NEG_INF = -1e30


def default_kv_block(max_len: int) -> int:
    """Largest KV block size <= 128 that divides ``max_len``."""
    for blk in (128, 64, 32, 16, 8, 4, 2):
        if max_len % blk == 0:
            return blk
    return 1


def _online_softmax_block(qf, k, v, live, carry, softcap: float):
    """One online-softmax accumulation over a dequantized KV block.

    qf (B, Kh, G, Dh) pre-scaled queries; k/v (B, blk, Kh, Dh) f32;
    live: bool broadcastable to (B, Kh, G, blk); carry (acc, m, l)."""
    acc, m, l = carry
    s = torch.einsum("bkgd,btkd->bkgt", qf, k)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(live, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1, keepdim=True)
    pv = torch.einsum("bkgt,btkd->bkgd", p, v)
    return acc * alpha + pv, m_new, l


def flash_decode_plain(q, k_codes, k_scale, v_codes, v_scale, pos: int,
                       pad: Optional[torch.Tensor] = None,
                       softcap: float = 0.0,
                       blk: Optional[int] = None) -> torch.Tensor:
    """The kernel's plain version: a loop over the live KV blocks with an
    online softmax (shapes as in :func:`flash_decode`)."""
    b, kh, g, dh = q.shape
    t = k_codes.shape[1]
    blk = default_kv_block(t) if blk is None else blk
    qf = q.float() * (1.0 / math.sqrt(dh))
    acc = torch.zeros((b, kh, g, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, kh, g, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kh, g, 1), dtype=torch.float32, device=q.device)
    carry = (acc, m, l)
    with no_tf32():
        for i in range((pos + blk) // blk):          # ceil((pos+1)/blk)
            sl = slice(i * blk, (i + 1) * blk)
            kpos = torch.arange(i * blk, (i + 1) * blk, device=q.device)
            live = kpos[None, None, None, :] <= pos
            if pad is not None:
                live = live & (kpos[None, None, None, :] >=
                               pad[:, None, None, None])
            carry = _online_softmax_block(
                qf, dequant_kv_ref(k_codes[:, sl], k_scale[:, sl]),
                dequant_kv_ref(v_codes[:, sl], v_scale[:, sl]), live, carry,
                softcap)
    acc, _, l = carry
    return acc / l


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    fn = lib.flash_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_decode(q: torch.Tensor, k_codes: torch.Tensor,
                 k_scale: torch.Tensor, v_codes: torch.Tensor,
                 v_scale: torch.Tensor, pos: int,
                 pad: Optional[torch.Tensor] = None, softcap: float = 0.0,
                 blk: Optional[int] = None) -> torch.Tensor:
    """GQA decode attention of one new token over a posit8 KV cache.

    q (B, Kh, G, Dh) float32/bfloat16; k/v codes (B, T, Kh, Dh) uint8;
    k/v scales (B, T, Kh, Gs) bfloat16 with Gs dividing Dh; ``pos`` the
    last live slot (a Python int); ``pad`` optional (B,) int32 left-pad
    widths (slots below ``pad[b]`` are dead).  Returns (B, Kh, G, Dh) f32.
    """
    b, kh, g, dh = q.shape
    t = k_codes.shape[1]
    gs = k_scale.shape[-1]
    blk = default_kv_block(t) if blk is None else blk
    if k_codes.shape != (b, t, kh, dh) or v_codes.shape != k_codes.shape \
            or k_scale.shape != (b, t, kh, gs) \
            or v_scale.shape != k_scale.shape or dh % gs or t % blk:
        raise ValueError(
            f"inconsistent decode shapes: q {tuple(q.shape)}, codes "
            f"{tuple(k_codes.shape)}, scales {tuple(k_scale.shape)}, "
            f"blk {blk}")
    if not 0 <= pos < t:
        raise ValueError(f"pos {pos} outside the cache of {t} slots")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_codes, k_scale, v_codes, v_scale, pos,
                                  pad, softcap, blk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k_codes.dtype != torch.uint8 or v_codes.dtype != torch.uint8 \
            or k_scale.dtype != torch.bfloat16 \
            or v_scale.dtype != torch.bfloat16:
        raise TypeError("flash_decode takes float32/bfloat16 q, uint8 codes "
                        "and bfloat16 scales")
    if pad is not None and (pad.dtype != torch.int32 or pad.shape != (b,)):
        raise TypeError("pad must be a (B,) int32 tensor")
    q = q.float().contiguous()
    for name, x in (("k_codes", k_codes), ("k_scale", k_scale),
                    ("v_codes", v_codes), ("v_scale", v_scale),
                    ("pad", pad)):
        if x is not None and (x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {q.device}")
    out = torch.empty((b, kh, g, dh), dtype=torch.float32, device=q.device)
    err = _lib().flash_decode(
        q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        v_codes.data_ptr(), v_scale.data_ptr(),
        None if pad is None else pad.data_ptr(), out.data_ptr(),
        b, t, kh, g, dh, gs, pos, blk, float(softcap), 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
