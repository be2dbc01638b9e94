"""RMMEC packed matrix product: x @ W with W stored as packed low-bit
codes (the counterpart of ``repro.kernels.rmmec_matmul``).

``rmmec_matmul`` launches the CUDA kernels of ``csrc/rmmec_matmul.cu`` on
a CUDA tensor and runs ``rmmec_matmul_plain`` on a CPU tensor.  It takes
the packed layout exactly as ``ops.pack_tensor`` leaves it: any K, Np a
multiple of the codes per word, scales per channel (G = 1) or per
K-group, and a block mask of any granularity that tiles (Kp, Np).

Which kernel runs is decided in Python, by :func:`launch_plan`, from the
shapes and types alone (nothing is read back from the card):

  - bf16 x with a format of <= 8 bits (the main path) goes to the tensor
    cores: K is cut into chunks of ``KC`` rows whose partials are folded
    in chunk order, by ``split_k`` (M <= 16: a block per 64-column N-tile
    and chunk, the last block of a tile to arrive folds), by ``wgmma``
    (M > 16 where TMA can address x and the words, see
    :func:`tma_aligned`, and its grid ends first, see
    :func:`wgmma_faster`: a persistent block an SM walks 128 x 64 tiles,
    TMA loads, wgmma chains, the decode beside them) or by ``tile64`` /
    ``tile128`` (the other M > 16 calls: a block per output tile walks
    its chunks);
  - f32 x, or posit16 with any x (every untied read-out), goes to a
    sequential f32 FMA loop over K: ``stream`` for M <= 16 (a warp per
    strip of 32 columns walks K, or for narrow N a block per strip of
    ``stream_strip`` columns; codes decoded through ``stream_table``, a
    thread per column sums), ``simt`` above.

Either way a row's output is bitwise the same whatever M is and whatever
the other rows hold.  On the tensor route the decoded weight is exact in
bf16 and so is the group scale the packer makes (a power of two); a group
scale that is not one is rounded with the weight to bf16, as the
reference's bf16 route does.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core import codec as codec_mod
from ..core.formats import FormatSpec
from ..core.packing import lanes_per_word
from . import _build, fake
from . import ref

__all__ = ["rmmec_matmul", "rmmec_matmul_plain", "default_blocks",
           "launch_plan", "LaunchPlan", "chunk_bounds", "decode_table",
           "stream_table", "stream_strip", "stream_route", "wgmma_route",
           "wgmma_faster", "tma_aligned", "call_plan", "KC"]

KIND = {"posit": 0, "minifloat": 1, "fixed": 2}

# The launch geometry of csrc/rmmec_matmul.cu (tests hold the two together).
KC = 128                       # K rows of a chunk partial
SPLIT_K_MAX_M = 16             # most rows of the split-K route
SPLIT_BN = 64                  # columns of a split-K N-tile
SPLIT_THREADS = 128
ROUTES = {"simt": 0, "split_k": 1, "tile64": 2, "tile128": 3, "stream": 4,
          "wgmma": 5}
WG_CONSUMERS = 2               # wgmma: consumer warpgroups, 64 rows each
WG_STAGES = 4                  # wgmma: chunks in each TMA ring
# route -> (rows, columns, threads) of a block's output tile
TILES = {"tile64": (64, 64, 256), "tile128": (128, 128, 256),
         "wgmma": (64 * WG_CONSUMERS, 64, 128 * WG_CONSUMERS + 32)}
SIMT_BN = 64
SIMT_ROWS = 64                 # x rows of a SIMT block (M > 16)
STREAM_THREADS = 256           # threads of a narrow block
WARP_COLS = 32                 # columns of a warp strip (stream_kernel)
WIDE_THREADS = 256             # a stream_kernel block: eight warp strips
WIDE_BN = WIDE_THREADS // 32 * WARP_COLS
NARROW_MAX_BN = 128            # widest block strip (stream_narrow_kernel)
STREAM_NARROW = 2              # narrow strips per SM aimed at
COUNTER_SLOTS = 1 << 14        # split-K N-tiles a call may have
H100_SMS = 132


def default_blocks(spec: FormatSpec) -> Tuple[int, int, int]:
    """(bm, bk, bn) of the 2-D kernel-padded layout, per precision mode
    (the reference's tiling; ``pack_tensor`` pads 2-D weights to it)."""
    if spec.bits <= 4:
        return (128, 1024, 256)
    if spec.bits <= 8:
        return (128, 512, 256)
    return (128, 512, 128)


def rmmec_matmul_plain(x: torch.Tensor, words: torch.Tensor,
                       scales: torch.Tensor, spec: FormatSpec,
                       n: int) -> torch.Tensor:
    """The kernel's plain version: dequantize, then an f32 product with
    TF32 off (the twin of ``ref.rmmec_matmul_ref``)."""
    return ref.rmmec_matmul_ref(x, words, scales, spec, scales.shape[-1])[:, :n]


def chunk_bounds(k: int) -> Tuple[Tuple[int, int], ...]:
    """The K ranges [k0, k1) of the chunk partials: KC rows each, the last
    cut at K.  They depend on K alone, never on M or the route."""
    return tuple((k0, min(k0 + KC, k)) for k0 in range(0, k, KC))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """What one call launches: the route, its grid (x, y) and threads a
    block, the chunk partials' K ranges (empty on the f32 FMA routes), the
    scratch floats and counters of a split-K fold (0 when nothing folds
    across blocks), and the columns of a streaming strip (0 elsewhere)."""
    route: str
    grid: Tuple[int, int]
    threads: int
    chunks: Tuple[Tuple[int, int], ...]
    scratch_floats: int
    counters: int
    strip: int = 0

    @property
    def scratch_bytes(self) -> int:
        return 4 * self.scratch_floats


def stream_strip(n: int, bits: int, sms: int = H100_SMS) -> int:
    """Columns of a streaming block for N = ``n`` and ``bits``-bit codes.
    ``WIDE_BN`` (stream_kernel: 8 warps, a strip of 32 columns each) where
    that gives a block per SM or more; else a block strip for
    stream_narrow_kernel: the widest power of two up to ``NARROW_MAX_BN``
    that gives ``STREAM_NARROW`` blocks per SM, and at least one 16-byte
    piece of codes (8 posit16, 16 of 8 bits, 32 of 4 bits)."""
    if _cdiv(n, WIDE_BN) >= sms:
        return WIDE_BN
    bn = NARROW_MAX_BN
    while bn > 128 // bits and _cdiv(n, bn) < STREAM_NARROW * sms:
        bn //= 2
    return bn


def stream_route(m: int, x_dtype: torch.dtype, bits: int) -> bool:
    """Whether x (m, K) of ``x_dtype`` times ``bits``-bit codes takes the
    streaming route; ``stream_route.launches`` counts its launches beside
    the wrapper's own count."""
    return m <= SPLIT_K_MAX_M and (x_dtype != torch.bfloat16 or bits > 8)


stream_route.launches = 0


def tma_aligned(k: int, n_words: int, *ptrs: int) -> bool:
    """Whether TMA can address x (M, k) bf16 in blocks of 64 columns and
    packed words of ``n_words`` int32 a row: k a multiple of 64, the words'
    row stride a multiple of 16 bytes and every pointer in ``ptrs`` (x's,
    the words') 16-byte aligned."""
    return k % 64 == 0 and n_words % 4 == 0 and all(p % 16 == 0 for p in ptrs)


# The time of one wave of a tile route's blocks (a 128 x 128 block on every
# SM; two 64 x 64 blocks sharing each SM) in units of one wave of
# wgmma_kernel's 128 x 64 tiles: the medians of the H100's sweep over M, K,
# N and the format (rmmec_ablation --only routes; PERF.md, section 6).  A
# 64 x 64 block alone on its SM ends before a wgmma tile does (0.84 of
# one), so a tile64 grid of at most one block an SM stays on the tiles.
WAVE_COST = {"tile128": 1.75, "tile64": 1.13}


def wgmma_faster(m: int, n: int, sms: int = H100_SMS) -> bool:
    """Whether wgmma_kernel's persistent grid (128 x 64 tiles, a block an
    SM) ends before the tile route :func:`launch_plan` would otherwise
    take for an (m, n) output: each grid's waves of blocks on ``sms`` SMs
    times the cost of a wave (``WAVE_COST``)."""
    waves = _cdiv(_cdiv(m, 128) * _cdiv(n, 64), sms)
    t128 = _cdiv(m, 128) * _cdiv(n, 128)
    if 2 * t128 >= sms:
        return waves < WAVE_COST["tile128"] * _cdiv(t128, sms)
    t64 = _cdiv(m, 64) * _cdiv(n, 64)
    return t64 > sms and waves < WAVE_COST["tile64"] * _cdiv(t64, 2 * sms)


def wgmma_route(m: int, n: int, x_dtype: torch.dtype, bits: int,
                aligned: bool, sms: int = H100_SMS) -> bool:
    """Whether x (m, K) of ``x_dtype`` times ``bits``-bit codes (K, n)
    takes the wgmma route: it can (bf16 x, <= 8 bits, M > 16,
    ``aligned``: :func:`tma_aligned` holds) and :func:`wgmma_faster` says
    it ends first.  ``wgmma_route.launches`` counts its launches beside
    the wrapper's own count."""
    return (m > SPLIT_K_MAX_M and x_dtype == torch.bfloat16 and bits <= 8
            and aligned and wgmma_faster(m, n, sms))


wgmma_route.launches = 0


def launch_plan(m: int, k: int, n: int, x_dtype: torch.dtype, bits: int,
                sms: int = H100_SMS, aligned: bool = False) -> LaunchPlan:
    """The launch of x (m, k) @ W (k, n) for x of ``x_dtype`` and a format
    of ``bits`` bits on a card of ``sms`` SMs (mirrors the C entry point's
    grids); ``aligned``: :func:`tma_aligned` holds for the call's operands.
    wgmma where TMA can take the operands at M > 16 and its grid ends
    first (:func:`wgmma_route`); else 128 x 128 tiles only where they fill
    half the card or more."""
    if stream_route(m, x_dtype, bits):
        bn = stream_strip(n, bits, sms)
        threads = WIDE_THREADS if bn == WIDE_BN else STREAM_THREADS
        return LaunchPlan("stream", (_cdiv(n, bn), 1), threads, (), 0, 0, bn)
    if x_dtype != torch.bfloat16 or bits > 8:
        return LaunchPlan("simt", (_cdiv(n, SIMT_BN), _cdiv(m, SIMT_ROWS)),
                          256, (), 0, 0)
    chunks = chunk_bounds(k)
    if m <= SPLIT_K_MAX_M:
        tiles = _cdiv(n, SPLIT_BN)
        folds = len(chunks) > 1
        return LaunchPlan(
            "split_k", (tiles, len(chunks)), SPLIT_THREADS, chunks,
            len(chunks) * m * tiles * SPLIT_BN if folds else 0,
            tiles if folds else 0)
    if wgmma_route(m, n, x_dtype, bits, aligned, sms):
        bm, bn, threads = TILES["wgmma"]
        tiles = _cdiv(m, bm) * _cdiv(n, bn)
        return LaunchPlan("wgmma", (min(tiles, sms), 1), threads, chunks,
                          0, 0)
    big = 2 * _cdiv(m, 128) * _cdiv(n, 128) >= sms
    route = "tile128" if big else "tile64"
    bm, bn, threads = TILES[route]
    return LaunchPlan(route, (_cdiv(n, bn), _cdiv(m, bm)), threads, chunks,
                      0, 0)


_ARGTYPES = {
    "rmmec_matmul": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 17 + [ctypes.c_void_p],
}

# one split-K arrival counter per N-tile, per device: zeroed once; each
# launch's folding blocks put theirs back to 0
_COUNTERS: Dict[torch.device, torch.Tensor] = {}
_SMS: Dict[torch.device, int] = {}


def _counters(device: torch.device) -> torch.Tensor:
    """The device's split-K counters (``COUNTER_SLOTS`` int32), allocated
    and zeroed at the device's first split-K call and shared by every
    later one.  Calls on one device share them, so they are issued to one
    stream at a time, as every caller of the port does."""
    c = _COUNTERS.get(device)
    if c is None:
        c = torch.zeros(COUNTER_SLOTS, dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


_TABLES: Dict[Tuple[torch.device, str], torch.Tensor] = {}


def decode_table(spec: FormatSpec, device) -> torch.Tensor:
    """The tensor route's decode table of a format of 4 or 8 bits: 256
    int32, each code's value as bf16 bits (8-bit formats: code i in the
    low half) or, for 4-bit formats, byte i's two codes (low nibble in the
    low half).  Made on ``device`` by the port's codec (no host sync), once
    per format and device."""
    key = (torch.device(device), spec.name)
    t = _TABLES.get(key)
    if t is None:
        n = 1 << spec.bits
        vals = codec_mod.decode(spec, torch.arange(n, device=device))
        bits = vals.to(torch.bfloat16).view(torch.int16).to(torch.int32) \
            & 0xFFFF
        if spec.bits == 4:
            i = torch.arange(256, device=device)
            bits = bits[i & 15] | (bits[i >> 4] << 16)
        t = bits.contiguous()
        _TABLES[key] = t
    return t


_STREAM_TABLES: Dict[Tuple[torch.device, str], torch.Tensor] = {}


def _f32_bits(v: torch.Tensor) -> torch.Tensor:
    """The bits of float32 values as non-negative int64."""
    return v.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def stream_table(spec: FormatSpec, device) -> torch.Tensor:
    """The streaming route's decode table, int32, made on ``device`` by the
    port's codec once per format and device.

    Formats of 8 bits: 256 entries, code i's f32 bits.  4 bits: 256 x 2,
    the f32 bits of byte i's two codes (low nibble first).  posit16: 256 x
    2 entries (base, mul) over the code's high byte b: the code's value
    bits are ``(base + sx * mul) mod 2**32``, sx the code sign-extended,
    wherever the regime run is <= 6.  For b < 128 (sx = mag in [256 b, 256
    b + 255]) ``mul`` is the f32 step of one unit of the low 8 bits of the
    magnitude and ``base`` comes from the value of 256 b; for b >= 128
    the magnitudes are 256 h + 1 .. 256 h + 256 with h = 255 - b, so
    ``mul`` is minus h's step and ``base`` h's base plus the sign bit (the
    last magnitude, the first of the next regime, is one step past h's
    last value, which the value line meets exactly).  b = 0 and 255 (runs
    of 7 or more zeros, zero), 127 and 128 (runs of 7 or more ones, NaR)
    hold ``mul`` 0, which the kernel decodes in full."""
    key = (torch.device(device), spec.name)
    t = _STREAM_TABLES.get(key)
    if t is None:
        if spec.bits == 16:
            mag = torch.arange(1 << 15, device=device)
            bits = _f32_bits(codec_mod.decode(spec, mag))
            h = torch.arange(128, device=device)
            mul = (bits[(h << 8) + 1] - bits[h << 8]) & 0xFFFFFFFF
            base = (bits[h << 8] - (h << 8) * mul) & 0xFFFFFFFF
            t = torch.zeros((256, 2), dtype=torch.int64, device=device)
            t[:128, 0], t[:128, 1] = base, mul
            t[128:, 0] = (base.flip(0) + (1 << 31)) & 0xFFFFFFFF
            t[128:, 1] = (-mul.flip(0)) & 0xFFFFFFFF
            t[[0, 127, 128, 255]] = 0
        else:
            bits = _f32_bits(codec_mod.decode(
                spec, torch.arange(1 << spec.bits, device=device)))
            if spec.bits == 4:
                i = torch.arange(256, device=device)
                bits = torch.stack([bits[i & 15], bits[i >> 4]], dim=-1)
            t = bits
        t = torch.where(t >= 1 << 31, t - (1 << 32), t).to(
            torch.int32).contiguous()
        _STREAM_TABLES[key] = t
    return t


def _sms(device: torch.device) -> int:
    n = _SMS.get(device)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device] = n
    return n


def call_plan(x: torch.Tensor, words: torch.Tensor, spec: FormatSpec,
              n: int) -> LaunchPlan:
    """The plan ``rmmec_matmul`` launches for x (M, K) on the card times
    ``words``: :func:`launch_plan` with the card's SMs and the operands'
    alignment, read only for a call the wgmma route can take (bf16 x,
    <= 8 bits, M > 16)."""
    m, k = x.shape
    aligned = (m > SPLIT_K_MAX_M and x.dtype == torch.bfloat16
               and spec.bits <= 8
               and tma_aligned(k, words.shape[1], x.data_ptr(),
                               words.data_ptr()))
    return launch_plan(m, k, n, x.dtype, spec.bits, _sms(x.device), aligned)


def _lib() -> ctypes.CDLL:
    return _build.bind("rmmec_matmul", _ARGTYPES)


def _check(x, words, scales, mask, spec: FormatSpec, n: int):
    """Validate shapes/dtypes of one 2-D slice; returns (kp, np_, group)."""
    if spec.kind not in KIND:
        raise ValueError(f"rmmec_matmul has no decoder for {spec.name}")
    if x.dim() != 2 or words.dim() != 2 or scales.dim() != 2 \
            or mask.dim() != 2:
        raise ValueError("rmmec_matmul takes one 2-D slice: x (M, K), "
                         "words (Kp, W), scales (G, Np), mask (mk, mn)")
    if words.dtype != torch.int32 or mask.dtype != torch.int32 \
            or scales.dtype != torch.float32:
        raise TypeError("words and mask must be int32 and scales float32")
    kp = words.shape[0]
    np_ = words.shape[1] * lanes_per_word(spec.bits)
    g = scales.shape[0]
    if scales.shape[1] != np_ or kp % g or kp % mask.shape[0] \
            or np_ % mask.shape[1] or x.shape[1] > kp \
            or (n is not None and n > np_):
        raise ValueError(
            f"inconsistent packed layout: x {tuple(x.shape)}, words "
            f"{tuple(words.shape)}, scales {tuple(scales.shape)}, mask "
            f"{tuple(mask.shape)}, n={n}")
    return kp, np_, (kp // g if g > 1 else 0)


def rmmec_matmul(x: torch.Tensor, words: torch.Tensor, scales: torch.Tensor,
                 mask: torch.Tensor, spec: FormatSpec,
                 n: Optional[int] = None) -> torch.Tensor:
    """x (M, K) float32/bfloat16 @ packed W -> (M, n) float32.

    words (Kp, Np/per) int32, scales (G, Np) f32, mask (mk, mn) int32;
    ``n`` is the logical N (default Np)."""
    kp, np_, group = _check(x, words, scales, mask, spec, n)
    n = np_ if n is None else n
    if fake.is_fake(x):
        m, k = x.shape
        return fake.kernel_call("rmmec_matmul", (m, n), torch.float32, x,
                                2.0 * m * k * n,
                                fake.nbytes((x, words, scales, mask)))
    if x.device.type == "cpu":
        return rmmec_matmul_plain(x, words, scales, spec, n)
    if x.device.type != "cuda":
        raise ValueError(f"rmmec_matmul runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    for name, t in (("x", x), ("words", words), ("scales", scales),
                    ("mask", mask)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    plan = call_plan(x, words, spec, n)
    m, k = x.shape
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    scratch = counters = table = None
    if plan.route == "stream":
        table = stream_table(spec, x.device)
    elif plan.route != "simt":
        table = decode_table(spec, x.device)
    if plan.counters:
        if plan.counters > COUNTER_SLOTS:
            raise ValueError(f"rmmec_matmul: N={n} needs {plan.counters} "
                             f"split-K counters, more than {COUNTER_SLOTS}")
        scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                              device=x.device)
        counters = _counters(x.device)
    err = _lib().rmmec_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), words.data_ptr(),
        scales.data_ptr(), mask.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if counters is None else counters.data_ptr(),
        None if table is None else table.data_ptr(), m, k, n, np_,
        group, kp // mask.shape[0], np_ // mask.shape[1], mask.shape[1],
        ROUTES[plan.route], plan.strip, KIND[spec.kind], spec.bits, spec.es,
        spec.ebits, spec.mbits, int(spec.has_nan), spec.frac_bits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmmec_matmul launch failed: CUDA error {err}")
    rmmec_matmul.launches += 1
    if plan.route == "stream":
        stream_route.launches += 1
    elif plan.route == "wgmma":
        wgmma_route.launches += 1
    return out


rmmec_matmul.launches = 0
