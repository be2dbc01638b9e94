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
    and chunk, the last block of a tile to arrive folds) or by ``tile64`` /
    ``tile128`` (a block per output tile walks its chunks);
  - f32 x, or posit16 with any x, goes to ``simt``, an f32 FMA loop.

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
           "launch_plan", "LaunchPlan", "chunk_bounds", "decode_table", "KC"]

KIND = {"posit": 0, "minifloat": 1, "fixed": 2}

# The launch geometry of csrc/rmmec_matmul.cu (tests hold the two together).
KC = 128                       # K rows of a chunk partial
SPLIT_K_MAX_M = 16             # most rows of the split-K route
SPLIT_BN = 64                  # columns of a split-K N-tile
SPLIT_THREADS = 128
ROUTES = {"simt": 0, "split_k": 1, "tile64": 2, "tile128": 3}
# route -> (rows, columns, threads) of a block's output tile
TILES = {"tile64": (64, 64, 256), "tile128": (128, 128, 256)}
SIMT_BN = 64
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
    block, the chunk partials' K ranges (empty on the SIMT route), and the
    scratch floats and counters of a split-K fold (0 when nothing folds
    across blocks)."""
    route: str
    grid: Tuple[int, int]
    threads: int
    chunks: Tuple[Tuple[int, int], ...]
    scratch_floats: int
    counters: int

    @property
    def scratch_bytes(self) -> int:
        return 4 * self.scratch_floats


def launch_plan(m: int, k: int, n: int, x_dtype: torch.dtype, bits: int,
                sms: int = H100_SMS) -> LaunchPlan:
    """The launch of x (m, k) @ W (k, n) for x of ``x_dtype`` and a format
    of ``bits`` bits on a card of ``sms`` SMs (mirrors the C entry point's
    grids).  128 x 128 tiles only where they fill half the card or more."""
    if x_dtype != torch.bfloat16 or bits > 8:
        rows = 8 if m <= 32 else 64
        return LaunchPlan("simt", (_cdiv(n, SIMT_BN), _cdiv(m, rows)), 256,
                          (), 0, 0)
    chunks = chunk_bounds(k)
    if m <= SPLIT_K_MAX_M:
        tiles = _cdiv(n, SPLIT_BN)
        folds = len(chunks) > 1
        return LaunchPlan(
            "split_k", (tiles, len(chunks)), SPLIT_THREADS, chunks,
            len(chunks) * m * tiles * SPLIT_BN if folds else 0,
            tiles if folds else 0)
    big = 2 * _cdiv(m, 128) * _cdiv(n, 128) >= sms
    route = "tile128" if big else "tile64"
    bm, bn, threads = TILES[route]
    return LaunchPlan(route, (_cdiv(n, bn), _cdiv(m, bm)), threads, chunks,
                      0, 0)


_ARGTYPES = {
    "rmmec_matmul": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 16 + [ctypes.c_void_p],
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


def _sms(device: torch.device) -> int:
    n = _SMS.get(device)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device] = n
    return n


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
    m, k = x.shape
    plan = launch_plan(m, k, n, x.dtype, spec.bits, _sms(x.device))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    scratch = counters = table = None
    if plan.route != "simt":
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
        ROUTES[plan.route], KIND[spec.kind], spec.bits, spec.es, spec.ebits,
        spec.mbits, int(spec.has_nan), spec.frac_bits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmmec_matmul launch failed: CUDA error {err}")
    rmmec_matmul.launches += 1
    return out


rmmec_matmul.launches = 0
