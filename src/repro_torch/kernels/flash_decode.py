"""Attention straight from a posit8 KV cache (the counterpart of
``repro.kernels.flash_decode``): contiguous decode, paged decode and
paged chunk prefill.

Each wrapper launches ``csrc/flash_decode.cu`` on a CUDA tensor and runs
its plain version on a CPU tensor:

  flash_decode        / flash_decode_plain        <- flash_decode_pallas
  paged_flash_decode  / paged_flash_decode_plain  <- paged_flash_decode_pallas
  paged_flash_prefill / paged_flash_prefill_plain <- paged_flash_prefill_pallas

On the card the two decode wrappers share one C entry point
(``paged_flash_decode``): split-KV page partials, one block per (b,
kv-head, page), folded in page order by a second kernel of the same
entry.  ``flash_decode`` calls it with contiguous addressing (a cache
(B, T, Kh, Dh) is a pool of B*T/blk pages) and its scalar position and
left pad; each wrapper counts its own launches.  The prefill kernel
keeps each page dequantized in shared memory for a tile of 32 query rows
and folds the same page partials in registers.  Both compute a partial
with the same bf16 tensor-core code (a team of four warps per 16 rows;
q and p split into three bf16 terms, K and V exact in bf16) and fold
with the same function, so paged decode equals contiguous decode
bitwise when page == blk, and a C = 1 prefill chunk equals paged decode
bitwise.  The kernels take any Dh in 1..256 (instantiated at widths 32,
64, 128 and 256; a narrower head runs on the next width with zero
columns) and pages (KV blocks) of any size: a page walks as ``s``
sub-pages of ``sub_page(page, dh, kh, gs)`` slots, the largest divisor
of the page that fits a kernel (128 slots, 64 at widths above 128, fewer
where the page's scales for all Kh heads would overflow a prefill
block's shared memory), so a 256-slot page gives the bits of two
128-slot pages.  A head of 257 ..
``WIDE_MAX_DH`` columns takes the wide route of the same entry points
(``wide_route(dh)``): a SIMT kernel, one block per query row, that
folds the row's slots one by one in position order, so the same two
bitwise invariants hold there (``wide_route.launches`` counts its
launches beside each wrapper's own count).

The plain versions are the twins of the reference's blocked XLA loops
(``repro.models.attention.decode_quantized_blocks``,
``paged_decode_blocked``, ``paged_prefill_blocked``): an online softmax
over the live KV blocks, each dequantized on its own, with the -1e30
sentinel and the optional tanh softcap, all through one block step.  The
paged prefill flattens its queries to rows ``qi*G + gi`` with horizon
``start + qi``, so a C = 1 chunk is the decode computation itself.  On
the CUDA path no wrapper reads a device tensor back to the host.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build, fake
from .ref import dequant_kv_ref, no_tf32

__all__ = ["flash_decode", "flash_decode_plain", "paged_flash_decode",
           "paged_flash_decode_plain", "paged_flash_prefill",
           "paged_flash_prefill_plain", "default_kv_block", "kernel_width",
           "sub_page", "wide_route"]

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


def _init_carry(b, kh, r, dh, device):
    """Empty online-softmax state (acc, m, l) of R rows."""
    return (torch.zeros((b, kh, r, dh), dtype=torch.float32, device=device),
            torch.full((b, kh, r, 1), _NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((b, kh, r, 1), dtype=torch.float32, device=device))


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
    carry = _init_carry(b, kh, g, dh, q.device)
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


def _paged_rows_plain(qf, k_codes, k_scale, v_codes, v_scale, page_table,
                      horizon, n_live: int, softcap: float) -> torch.Tensor:
    """Online softmax of query rows qf (B, Kh, R, Dh), pre-scaled, over
    the first ``n_live`` logical blocks of each request's page-table row;
    ``horizon`` (B, 1, R|1, 1) is each row's last visible slot."""
    b, kh, r, dh = qf.shape
    psize = k_codes.shape[1]
    carry = _init_carry(b, kh, r, dh, qf.device)
    with no_tf32():
        for t in range(n_live):
            pg = page_table[:, t].long()
            kpos = torch.arange(t * psize, (t + 1) * psize, device=qf.device)
            live = kpos[None, None, None, :] <= horizon
            carry = _online_softmax_block(
                qf, dequant_kv_ref(k_codes[pg], k_scale[pg]),
                dequant_kv_ref(v_codes[pg], v_scale[pg]), live, carry,
                softcap)
    acc, _, l = carry
    return acc / l


def paged_flash_decode_plain(q, k_codes, k_scale, v_codes, v_scale,
                             page_table, positions,
                             softcap: float = 0.0) -> torch.Tensor:
    """The paged decode kernel's plain version (shapes as in
    :func:`paged_flash_decode`): the trip count is the longest request's
    live block count, read from ``positions`` on the host; blocks past a
    shorter request's prefix are exact no-ops for its rows."""
    dh = q.shape[-1]
    psize = k_codes.shape[1]
    qf = q.float() * (1.0 / math.sqrt(dh))
    n_live = (int(positions.max()) + psize) // psize
    return _paged_rows_plain(qf, k_codes, k_scale, v_codes, v_scale,
                             page_table, positions[:, None, None, None],
                             n_live, softcap)


def paged_flash_prefill_plain(q, k_codes, k_scale, v_codes, v_scale,
                              page_table, start,
                              softcap: float = 0.0) -> torch.Tensor:
    """The paged prefill kernel's plain version (shapes as in
    :func:`paged_flash_prefill`): the chunk's C*G query rows of each
    (b, kv-head) go through the decode block step as one row set."""
    b, c, kh, g, dh = q.shape
    psize = k_codes.shape[1]
    qf = q.float().permute(0, 2, 1, 3, 4).reshape(b, kh, c * g, dh) \
        * (1.0 / math.sqrt(dh))
    rows = torch.arange(c * g, device=q.device) // g
    horizon = (start[:, None] + rows[None])[:, None, :, None]
    # a padded final chunk may reach past the table: its pad rows are
    # never read back, and real rows never need those blocks
    n_live = min((int(start.max()) + c + psize - 1) // psize,
                 page_table.shape[1])
    out = _paged_rows_plain(qf, k_codes, k_scale, v_codes, v_scale,
                            page_table, horizon, n_live, softcap)
    return out.reshape(b, kh, c, g, dh).permute(0, 2, 1, 3, 4)


_ARGTYPES = {
    "paged_flash_decode": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    "paged_flash_prefill": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
}

KERNEL_WIDTHS = (32, 64, 128, 256)   # the .cu's instantiations (width_of)
MAX_SUB = 128        # most slots of a sub-page the kernels walk (MAXP)
MAX_SUB_WIDE = 64    # ... at a width above 128 (MAXP_WIDE)
MAX_DH = KERNEL_WIDTHS[-1]           # the tensor-core kernels' widest head
SMEM_LIMIT = 232448  # dynamic shared memory a block may take (H100: 227 KB)
LUT_BYTES, ROWS, TEAM_WARPS = 512, 16, 4   # the .cu's constants of the same names
WIDE_MAX_DH = 4096   # the wide route's widest head (WIDE_MAX_DH in the .cu)


def wide_route(dh: int) -> bool:
    """Whether a head of ``dh`` columns takes the wide route (the SIMT
    slot walk, 256 < Dh <= ``WIDE_MAX_DH``) and not the tensor-core page
    partials; ``wide_route.launches`` counts the wide route's launches."""
    return dh > MAX_DH


wide_route.launches = 0


def kernel_width(dh: int) -> int:
    """The instantiated width a head of ``dh`` columns runs on (the
    tensor-core route)."""
    return next(w for w in KERNEL_WIDTHS if dh <= w)


def prefill_smem_bytes(sub: int, kh: int, gs: int, width: int) -> int:
    """``smem_bytes`` of ``csrc/flash_decode.cu`` for a prefill block at
    ``width`` walking sub-pages of ``sub`` slots: two stage buffers (K and
    V codes, and the sub-page's K and V scales for all ``kh`` heads, ``gs``
    bf16 a slot and head), the dequantized K and V, and its teams.  A
    decode block stages one buffer, so this is the larger of the two."""
    def a16(x):
        return (x + 15) & ~15
    ldp = (MAX_SUB if width <= 128 else MAX_SUB_WIDE) + 8
    team = (3 * ROWS * (width + 8) * 2 + 3 * ROWS * ldp * 2
            + (2 * TEAM_WARPS * ROWS + 16) * 4)
    stage = 2 * sub * width + 2 * a16(sub * kh * gs * 2)
    teams = 1 if width >= 128 else 2
    return LUT_BYTES + 2 * stage + 2 * a16(sub) * (width + 8) * 2 \
        + teams * team


def sub_page(page: int, dh: int, kh: int = 1, gs: int = 1) -> int:
    """Slots of the sub-pages the kernels walk a page of ``page`` slots
    as: its largest divisor that fits a kernel at ``dh``'s width, at most
    ``MAX_SUB`` (``MAX_SUB_WIDE`` above 128 columns) and within
    ``SMEM_LIMIT`` for a prefill block over ``kh`` heads with ``gs``
    scales a slot and head (the whole page on the wide route, which walks
    slots).  Decode and prefill take the same sub-pages, so a C = 1
    prefill chunk stays decode bit for bit."""
    if wide_route(dh):
        return page
    w = kernel_width(dh)
    cap = MAX_SUB if w <= 128 else MAX_SUB_WIDE
    for d in range(min(page, cap), 0, -1):
        if page % d == 0 and prefill_smem_bytes(d, kh, gs, w) <= SMEM_LIMIT:
            return d
    raise ValueError(f"no sub-page of a {page}-slot page fits shared memory "
                     f"at Dh={dh}, Kh={kh}, {gs} scales a slot")


def _lib() -> ctypes.CDLL:
    return _build.bind("flash_decode", _ARGTYPES)


def _check_pool(k_codes, k_scale, v_codes, v_scale, kh: int, dh: int):
    """(page, Gs) of a posit8 pool (P, page, Kh, Dh) / (P, page, Kh, Gs)."""
    p, page = k_codes.shape[:2]
    gs = k_scale.shape[-1]
    if k_codes.shape != (p, page, kh, dh) or v_codes.shape != k_codes.shape \
            or k_scale.shape != (p, page, kh, gs) \
            or v_scale.shape != k_scale.shape or dh % gs:
        raise ValueError(
            f"inconsistent pool shapes: codes {tuple(k_codes.shape)}, "
            f"scales {tuple(k_scale.shape)} for Kh={kh}, Dh={dh}")
    return page, gs


def _cuda_operands(q, named, index_names=()):
    """float32 contiguous q; raises unless every operand (None: absent)
    is a contiguous tensor of the kernel's type on q's device: uint8
    codes, bfloat16 scales, int32 ``index_names``."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, not {q.dtype}")
    want = {"k_codes": torch.uint8, "v_codes": torch.uint8,
            "k_scale": torch.bfloat16, "v_scale": torch.bfloat16,
            **{n: torch.int32 for n in index_names}}
    for name, x in named.items():
        if x is None:
            continue
        if x.dtype != want[name]:
            raise TypeError(f"{name} must be {want[name]}, not {x.dtype}")
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    return q.float().contiguous()


def _check_kernel_shape(name: str, dh: int, page: int) -> None:
    """Raises for what the CUDA kernels do not take: Dh outside
    1..``WIDE_MAX_DH`` (the wide route's shared memory holds q and O of
    at most that many columns), or a page (KV block) of no slot."""
    if not 1 <= dh <= WIDE_MAX_DH or page < 1:
        raise ValueError(f"{name} on the card takes Dh in 1..{WIDE_MAX_DH} "
                         f"and a page of at least 1 slot, not Dh={dh}, "
                         f"page={page}")


def _decode_cuda(q, k_codes, k_scale, v_codes, v_scale, page: int,
                 n_pages: int, page_table, positions, pad, pos: int,
                 softcap: float) -> torch.Tensor:
    """One launch of the decode entry point (page partials, then their
    fold in page order) on checked operands; q (B, Kh, G, Dh) float32
    contiguous.  A null ``page_table`` addresses a contiguous cache
    (B, n_pages * page, Kh, Dh); a null ``positions`` puts every row at
    ``pos``; a null ``pad`` means no left pad.  Counts nothing: the
    wrappers count their own launches.  The kernels walk each page as
    ``page // sub`` sub-pages of ``sub_page(page, dh, kh, gs)`` slots, and
    keep a partial of the kernel's width for each (the wide route keeps
    none)."""
    b, kh, g, dh = q.shape
    _check_kernel_shape("decode", dh, page)
    sub = sub_page(page, dh, kh, k_scale.shape[-1])
    nsub = page // sub
    wide = wide_route(dh)
    scratch = torch.empty(
        0 if wide else b * kh * n_pages * nsub * g * (kernel_width(dh) + 2),
        dtype=torch.float32, device=q.device)
    out = torch.empty((b, kh, g, dh), dtype=torch.float32, device=q.device)
    ptr = [None if x is None else x.data_ptr()
           for x in (page_table, positions, pad)]
    err = _lib().paged_flash_decode(
        q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        v_codes.data_ptr(), v_scale.data_ptr(), *ptr, scratch.data_ptr(),
        out.data_ptr(), b, n_pages * nsub, sub, nsub, kh, g, dh,
        k_scale.shape[-1], pos, float(softcap), 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode launch failed: CUDA error {err}")
    wide_route.launches += wide
    return out


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
    if fake.is_fake(q):
        live = pos + 1
        return fake.kernel_call(
            "flash_decode", (b, kh, g, dh), torch.float32, q,
            4.0 * b * kh * g * live * dh,
            2 * b * live * kh * (dh + 2 * gs) + fake.nbytes((q, pad)))
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_codes, k_scale, v_codes, v_scale, pos,
                                  pad, softcap, blk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    if pad is not None and pad.shape != (b,):
        raise ValueError("pad must be a (B,) tensor")
    q = _cuda_operands(q, dict(k_codes=k_codes, k_scale=k_scale,
                               v_codes=v_codes, v_scale=v_scale, pad=pad),
                       ("pad",))
    out = _decode_cuda(q, k_codes, k_scale, v_codes, v_scale, blk, t // blk,
                       None, None, pad, pos, softcap)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def paged_flash_decode(q: torch.Tensor, k_codes: torch.Tensor,
                       k_scale: torch.Tensor, v_codes: torch.Tensor,
                       v_scale: torch.Tensor, page_table: torch.Tensor,
                       positions: torch.Tensor,
                       softcap: float = 0.0) -> torch.Tensor:
    """GQA decode attention of one new token per request over a paged
    posit8 pool.

    q (B, Kh, G, Dh) float32/bfloat16; pool codes (P, page, Kh, Dh) uint8
    and scales (P, page, Kh, Gs) bfloat16; page_table (B, NP) int32 maps
    request b's logical block t to a pool page; positions (B,) int32:
    request b attends to logical slots [0, positions[b]].  Returns
    (B, Kh, G, Dh) f32.  Positions and page ids are the caller's to keep
    in range (a position below NP * page, a page below P)."""
    b, kh, g, dh = q.shape
    _check_pool(k_codes, k_scale, v_codes, v_scale, kh, dh)
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or positions.shape != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / positions "
                         f"{tuple(positions.shape)} do not match B={b}")
    if fake.is_fake(q):
        # positions are data: count every slot the page table spans
        span = b * page_table.shape[1] * k_codes.shape[1]
        return fake.kernel_call(
            "paged_flash_decode", (b, kh, g, dh), torch.float32, q,
            4.0 * span * kh * g * dh,
            span * 2 * kh * (dh + 2 * k_scale.shape[-1])
            + fake.nbytes((q, page_table, positions)))
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_codes, k_scale, v_codes, v_scale,
                                        page_table, positions, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode runs on cuda or cpu, not "
                         f"{q.device}")
    q = _cuda_operands(q, dict(k_codes=k_codes, k_scale=k_scale,
                               v_codes=v_codes, v_scale=v_scale,
                               page_table=page_table, positions=positions),
                       ("page_table", "positions"))
    out = _decode_cuda(q, k_codes, k_scale, v_codes, v_scale,
                       k_codes.shape[1], page_table.shape[1], page_table,
                       positions, None, 0, softcap)
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0


def paged_flash_prefill(q: torch.Tensor, k_codes: torch.Tensor,
                        k_scale: torch.Tensor, v_codes: torch.Tensor,
                        v_scale: torch.Tensor, page_table: torch.Tensor,
                        start: torch.Tensor,
                        softcap: float = 0.0) -> torch.Tensor:
    """Paged chunk-prefill attention over a posit8 pool.

    q (B, C, Kh, G, Dh) float32/bfloat16: one chunk of C queries per
    request at absolute positions ``start[b] .. start[b] + C - 1``; pool,
    page table and types as in :func:`paged_flash_decode`; start (B,)
    int32.  Query ``i`` of request b attends causally to logical slots
    [0, start[b] + i].  Returns (B, C, Kh, G, Dh) f32."""
    b, c, kh, g, dh = q.shape
    _check_pool(k_codes, k_scale, v_codes, v_scale, kh, dh)
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or start.shape != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / start "
                         f"{tuple(start.shape)} do not match B={b}")
    if fake.is_fake(q):
        # the starts are data: count every slot the page table spans
        span = b * page_table.shape[1] * k_codes.shape[1]
        return fake.kernel_call(
            "paged_flash_prefill", (b, c, kh, g, dh), torch.float32, q,
            4.0 * span * c * kh * g * dh,
            span * 2 * kh * (dh + 2 * k_scale.shape[-1])
            + fake.nbytes((q, page_table, start)))
    if q.device.type == "cpu":
        return paged_flash_prefill_plain(q, k_codes, k_scale, v_codes,
                                         v_scale, page_table, start, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_prefill runs on cuda or cpu, not "
                         f"{q.device}")
    q = _cuda_operands(q, dict(k_codes=k_codes, k_scale=k_scale,
                               v_codes=v_codes, v_scale=v_scale,
                               page_table=page_table, start=start),
                       ("page_table", "start"))
    page, gs = k_codes.shape[1], k_scale.shape[-1]
    _check_kernel_shape("paged_flash_prefill", dh, page)
    sub = sub_page(page, dh, kh, gs)
    nsub = page // sub
    out = torch.empty((b, c, kh, g, dh), dtype=torch.float32, device=q.device)
    err = _lib().paged_flash_prefill(
        q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        v_codes.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
        start.data_ptr(), out.data_ptr(), b, c, page_table.shape[1] * nsub,
        sub, nsub, kh, g, dh, gs, float(softcap), 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_flash_prefill launch failed: CUDA error "
                           f"{err}")
    paged_flash_prefill.launches += 1
    wide_route.launches += wide_route(dh)
    return out


paged_flash_prefill.launches = 0
