"""The paged posit8 KV write: quantize the new K and V rows of a decode
step or a prefill chunk and write their codes and scales into the paged
pool, in place.

``paged_kv_write`` launches ``csrc/kv_write.cu`` on CUDA tensors (one
launch for K and V together) and runs ``paged_kv_write_plain`` on CPU
tensors: ``kernels.ref.quantize_kv`` for K and for V and two index writes
each, the pool write of the continuous and disaggregated engines before
the kernel.  On the card the kernel's codes and scales are those of the
plain version bit for bit.

Addressing (both paths; the kernel reads the page table itself):

  decode  k, v (B, Kh, Dh) and ``positions`` (B,): request b's token
          lands at slot ``positions[b] % page`` of pool page
          ``page_table[b, positions[b] // page]``;
  chunk   k, v (B, C, Kh, Dh), C whole pages, and ``start`` (B,): token
          j of request b lands at slot ``j % page`` of logical block
          ``start[b] // page + j // page``; a block past the table's NP
          columns (the pad of a final chunk) goes to the parking page 0.

The kernel's block layout comes from the pool's Dh and Gs
(``write_layout``).  On the card the entry raises ``ValueError`` for
operands the kernel does not take: a group of columns that neither
divides nor is divided into the warp's steps (group 48 of Dh 96), rows
neither bfloat16 nor float32 or of two types, rows not aligned to its
vector loads, or a page table or positions off the rows' device.  No
configuration of the port writes such a pool.  The CUDA path allocates
nothing and reads nothing back to the host; ``paged_kv_write.launches``
counts its launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build, fake
from .ref import quantize_kv

__all__ = ["paged_kv_write", "paged_kv_write_plain", "write_layout"]

_ARGTYPES = {
    "paged_kv_write": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 18
    + [ctypes.c_void_p],
}

_INT_MAX = (1 << 31) - 1


@functools.lru_cache(maxsize=None)
def write_layout(dh: int, gs: int) -> Optional[Tuple[int, int, int, int]]:
    """The kernel's layout ``(vec, lanes, eg, span)`` for rows of ``dh``
    columns in ``gs`` scale groups of g = dh / gs columns, or None when
    the kernel does not take the shape.  A warp walks a row in steps of
    32 * vec columns, ``vec`` adjacent ones a lane (4 where dh is a
    multiple of 128, 2 of 64, else 1); a group is ``span`` whole steps
    across the warp (the whole row, or g a multiple of 32 * vec), or
    ``lanes`` adjacent lanes of one step (vec <= g < 32 * vec, g / vec
    dividing 32), or ``eg`` elements of one lane (g dividing vec)."""
    g = dh // gs
    vec = 4 if dh % 128 == 0 else 2 if dh % 64 == 0 else 1
    if g == dh:
        return vec, 32, vec, -(-dh // (32 * vec))
    if g % (32 * vec) == 0:
        return vec, 32, vec, g // (32 * vec)
    if g % vec == 0 and 32 % (g // vec) == 0:
        return vec, g // vec, vec, 1
    if vec % g == 0:
        return vec, 1, g, 1
    return None


def _lib() -> ctypes.CDLL:
    return _build.bind("kv_write", _ARGTYPES)


def _check(pool, k, v, page_table, positions, start):
    """(tokens a request C, page) of a write; raises on inconsistent
    shapes."""
    kc, ks = pool["k_codes"], pool["k_scale"]
    _, page, kh, dh = kc.shape
    gs = ks.shape[-1]
    if pool["v_codes"].shape != kc.shape or pool["v_scale"].shape != ks.shape \
            or ks.shape[:3] != kc.shape[:3] or dh % gs:
        raise ValueError(f"inconsistent pool shapes: codes {tuple(kc.shape)},"
                         f" scales {tuple(ks.shape)}")
    if (positions is None) == (start is None):
        raise ValueError("give exactly one of positions (decode) and start "
                         "(chunk)")
    where = positions if start is None else start
    b = where.shape[0]
    c = 1 if start is None else k.shape[1]
    rows = (b, kh, dh) if start is None else (b, c, kh, dh)
    if k.shape != rows or v.shape != rows or where.shape != (b,) \
            or page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} / page "
                         f"table {tuple(page_table.shape)} / "
                         f"{'positions' if start is None else 'start'} "
                         f"{tuple(where.shape)} do not match the pool's "
                         f"Kh={kh}, Dh={dh}")
    if start is not None and c % page:
        raise ValueError(f"chunk of {c} tokens is not whole pages of {page}")
    return c, page


def paged_kv_write_plain(pool, k: torch.Tensor, v: torch.Tensor,
                         page_table: torch.Tensor,
                         positions: Optional[torch.Tensor] = None,
                         start: Optional[torch.Tensor] = None) -> None:
    """The kernel's plain version (arguments as in :func:`paged_kv_write`):
    the page-table addressing by ``gather``, ``quantize_kv`` of K and of V
    and an index write of each one's codes and scales."""
    page = pool["k_codes"].shape[1]
    if start is None:
        pos = positions.long()
        pg = page_table.gather(1, (pos // page)[:, None])[:, 0].long()
        index = (pg, pos % page)
    else:
        b, c = k.shape[:2]
        nblk = c // page
        npp = page_table.shape[1]
        blk_ids = start[:, None].long() // page \
            + torch.arange(nblk, device=k.device)[None]
        index = torch.where(blk_ids < npp,
                            page_table.gather(1, blk_ids.clamp(max=npp - 1)),
                            0).reshape(-1).long()
        k = k.reshape(b * nblk, page, *k.shape[2:])
        v = v.reshape(b * nblk, page, *v.shape[2:])
    gs = pool["k_scale"].shape[-1]
    group = None if gs == 1 else pool["k_codes"].shape[-1] // gs
    for name, new in (("k", k), ("v", v)):
        codes, scale = quantize_kv(new, group)
        pool[f"{name}_codes"][index] = codes
        pool[f"{name}_scale"][index] = scale


_POOL_TYPES = (("k_codes", torch.uint8), ("v_codes", torch.uint8),
               ("k_scale", torch.bfloat16), ("v_scale", torch.bfloat16))
_ROW_TYPES = (torch.bfloat16, torch.float32)


def _row_strides(x: torch.Tensor, vec: int, align: int):
    """(request stride, token stride) in elements of rows ``x`` (B, Kh,
    Dh) or (B, C, Kh, Dh) that the kernel can load ``vec`` at a time
    (0 for a dimension of one), or None."""
    shape, st = x.shape, x.stride()
    if st[-1] != 1 or (st[-2] != shape[-1] and shape[-2] != 1) \
            or x.data_ptr() % align:
        return None
    out = [s if n > 1 else 0 for n, s in zip(shape[:-2], st[:-2])]
    if any(s % vec or s > _INT_MAX for s in out):
        return None
    return out if len(out) == 2 else out + [0]


def _launch_args(pool, k, v, page_table, where):
    """The kernel's layout and the rows' strides for one launch; raises
    ``ValueError`` for operands the kernel does not take (see the
    module's docstring)."""
    dev = k.device
    for name, want in _POOL_TYPES:
        x = pool[name]
        if x.dtype != want or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"pool {name} must be contiguous {want} on "
                             f"{dev}")
    for name, x in (("page_table", page_table), ("positions/start", where)):
        if x.dtype != torch.int32 or x.device != dev \
                or (x.stride(-1) != 1 and x.shape[-1] > 1):
            raise ValueError(f"{name} must be int32 with unit stride on "
                             f"{dev}")
    dh, gs = k.shape[-1], pool["k_scale"].shape[-1]
    layout = write_layout(dh, gs)
    if layout is None:
        raise ValueError(f"paged_kv_write on the card takes no group of "
                         f"{dh // gs} columns of Dh={dh}")
    if k.dtype != v.dtype or k.dtype not in _ROW_TYPES or v.device != dev:
        raise ValueError(f"k and v must be both bfloat16 or both float32 on "
                         f"{dev}, not {k.dtype} and {v.dtype} on {v.device}")
    align = layout[0] * k.element_size()
    ks = _row_strides(k, layout[0], align)
    vs = _row_strides(v, layout[0], align)
    if ks is None or vs is None:
        raise ValueError(f"k and v rows must be unit-stride and aligned to "
                         f"{align} bytes for the kernel's loads")
    return layout, ks, vs


def paged_kv_write(pool, k: torch.Tensor, v: torch.Tensor,
                   page_table: torch.Tensor,
                   positions: Optional[torch.Tensor] = None,
                   start: Optional[torch.Tensor] = None) -> None:
    """Quantize ``k`` and ``v`` to posit8 with po2 scales (those of
    ``quantize_kv`` at the pool's group) and write codes and scales into
    the pool leaves ``pool["k_codes" | "v_codes" | "k_scale" |
    "v_scale"]`` ((P, page, Kh, Dh) uint8, (P, page, Kh, Gs) bfloat16), in
    place.  Decode: k, v (B, Kh, Dh) and ``positions`` (B,) int32; chunk:
    k, v (B, C, Kh, Dh) and ``start`` (B,) int32; ``page_table`` (B, NP)
    int32 (the module's docstring has the addressing).  Positions, starts
    and page ids are the caller's to keep in range."""
    c, page = _check(pool, k, v, page_table, positions, start)
    where = positions if start is None else start
    if fake.is_fake(k):
        kc, ks = pool["k_codes"], pool["k_scale"]
        rows = where.shape[0] * c * kc.shape[2]
        fake.kernel_write(
            "paged_kv_write", 2.0 * rows * kc.shape[3],
            fake.nbytes((k, v, page_table, where))
            + 2 * rows * (kc.shape[3] + ks.shape[3] * ks.element_size()))
        return
    if k.is_cpu:
        return paged_kv_write_plain(pool, k, v, page_table, positions, start)
    if not k.is_cuda:
        raise ValueError(f"paged_kv_write runs on cuda or cpu, not "
                         f"{k.device}")
    layout, (ksb, ksc), (vsb, vsc) = _launch_args(pool, k, v, page_table,
                                                  where)
    kc, ks = pool["k_codes"], pool["k_scale"]
    _, _, kh, dh = kc.shape
    err = _lib().paged_kv_write(
        k.data_ptr(), v.data_ptr(), kc.data_ptr(),
        pool["v_codes"].data_ptr(), ks.data_ptr(),
        pool["v_scale"].data_ptr(), page_table.data_ptr(), where.data_ptr(),
        start is not None, where.shape[0], c, kh, dh, ks.shape[-1], page,
        page_table.shape[1], page_table.stride(0), ksb, ksc, vsb, vsc,
        k.dtype == torch.float32, *layout,
        torch._C._cuda_getCurrentRawStream(k.get_device()))
    if err != 0:
        raise RuntimeError(f"paged_kv_write launch failed: CUDA error {err}")
    paged_kv_write.launches += 1


paged_kv_write.launches = 0
