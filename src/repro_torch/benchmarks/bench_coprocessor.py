"""Table III analogue -- the morphable matrix-multiplication co-processor
(the counterpart of ``benchmarks/bench_coprocessor.py``, same CSV rows
and derived fields).

The FPGA table reports LUT/FF/DSP/GOPS/W at iso-compute (64 MACs); the
software analogues: throughput of the morphable-array GEMM at the 8x8
and 16x16 array configurations (= block tilings of the packed layout),
per precision mode, plus packed traffic at each mode.

On the card every row runs the RMMEC kernel over the tiling's mask
blocks, checked once against ``x @ dequant(W)`` through the decode
kernel.  (The reference times its jnp oracle, ``use_ref=True``, only
because Pallas interpret mode on a CPU is slow.)
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import formats as F
from ..kernels import ops
from .common import check_packed, emit, time_call

M, K, N = 64, 512, 512
ARRAYS = (("8x8", (8, 512, 128)), ("16x16", (16, 512, 128)))
SPECS = (F.FP4, F.POSIT8, F.POSIT16)


def packed_fields(t: ops.PackedTensor, spec: F.FormatSpec, gops: float) -> str:
    """The derived CSV field of one row."""
    return (f"gops={gops:.2f};packed_bytes={t.words.numel() * 4};"
            f"mode=prec_sel_{F.simd_lanes(spec)}lane")


def run(device=None) -> None:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).to(dev)
    flops = 2 * M * K * N

    for arr, blocks in ARRAYS:
        for spec in SPECS:
            t = ops.pack_tensor(spec, w, blocks=blocks)
            name = f"coprocessor/array{arr}_{spec.name}"
            us = time_call(ops.packed_matmul, x, t)
            check_packed(name, x, t)
            gops = flops / (us * 1e-6) / 1e9
            emit(name, us, packed_fields(t, spec, gops))
