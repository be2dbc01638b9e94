"""Table II analogue -- the SIMD MAC compute engine (the counterpart of
``benchmarks/bench_mac_engine.py``, same CSV rows and derived fields).

The ASIC table reports freq/area/power/arithmetic-intensity; the
software-visible analogues here are throughput of the packed GEMM path
and the memory-traffic reduction of the packed formats (bytes per
operand), which is where the paper's 2.85x arithmetic-intensity gain
comes from, plus the exact posit8 quire dot.

On the card every packed row runs the RMMEC kernel, the quire row the
quire kernel, and each packed row is checked once against
``x @ dequant(W)`` through the decode kernel.  (The reference times its
jnp oracle, ``use_ref=True``, only because Pallas interpret mode on a
CPU is slow.)  With ``device="cpu"`` every wrapper takes its plain
version.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import formats as F
from ..kernels import ops
from ..kernels.ref import no_tf32
from .common import check_packed, emit, time_call

M, K, N = 128, 1024, 1024
GROUPS = (None, 64, 32)
SPECS = (F.POSIT16, F.POSIT8, F.POSIT4, F.FP4)


def packed_fields(t: ops.PackedTensor, spec: F.FormatSpec) -> str:
    """The derived CSV field of one packed row."""
    pbytes = t.words.numel() * 4 + t.scales.numel() * 4
    return (f"bytes_w={pbytes};AI_gain_vs_fp32={K * N * 4 / pbytes:.2f};"
            f"simd_lanes_16b={F.simd_lanes(spec)}")


def run(device=None) -> None:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).to(dev)
    dense_bytes = K * N * 4
    flops = 2 * M * K * N

    with no_tf32():
        us = time_call(torch.matmul, x, w)
    emit("mac_engine/fp32_dense", us,
         f"bytes_w={dense_bytes};AI={flops / (dense_bytes + M * K * 4):.2f}")

    # group-size axis: None = per-channel, 64/32 = finer dequant-scale
    # groups along K (more scale traffic, better accuracy)
    for group in GROUPS:
        for spec in SPECS:
            t = ops.pack_tensor(spec, w, group_size=group)
            gtag = "" if group is None else f"_g{group}"
            name = f"mac_engine/packed_{spec.name}{gtag}"
            us = time_call(ops.packed_matmul, x, t)
            check_packed(name, x, t)
            emit(name, us, packed_fields(t, spec))

    # quire-exact posit8 accumulation
    a = torch.from_numpy(rng.integers(0, 256, size=(64, 1024))
                         ).to(device=dev, dtype=torch.int32)
    b = torch.from_numpy(rng.integers(0, 256, size=(64, 1024))
                         ).to(device=dev, dtype=torch.int32)
    us = time_call(ops.quire_dot, a, b)
    emit("mac_engine/quire_dot_posit8", us, "exact=1;limbs=int32x2")
