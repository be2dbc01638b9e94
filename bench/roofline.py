"""Operations, bytes and least times on one NVIDIA H100 SXM: the
benchmark's yardstick for every roofline share and for ``mfu``.

Peaks are NVIDIA's data sheet for the SXM5 part at its 700 W limit,
dense: 989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM3.
The configurations state bf16 activations, so every product is held to
the bf16 peak (a posit16 read-out's products included).  A call's bound
is the larger of its operations over the peak and its bytes over the
bandwidth, each input byte read once and each output byte written once.

The model-level counts (``Model``) are for ``mfu``: per step, the
useful operations of the tokens it computed and the least bytes it had
to move (every served weight once per forward, the live KV once, each
running request's state slab read and written).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence, Tuple

from .reference import codecs

__all__ = ["PEAK_FLOPS", "HBM_BW", "bound", "rmmec", "paged_decode",
           "paged_prefill", "dequant", "Model"]

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12


def bound(flops: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds, which term binds: "operations" or "bytes")."""
    tc, tm = flops / PEAK_FLOPS, nbytes / HBM_BW
    return (tc, "operations") if tc >= tm else (tm, "bytes")


def rmmec(m: int, k: int, n: int, x_bytes: int, bits: int,
          scale_rows: int) -> Tuple[float, float]:
    """(operations, bytes) of x (M, K) @ a packed (K, N) weight of
    ``bits``-bit codes with ``scale_rows`` f32 scales per column, into a
    float32 (M, N)."""
    return (2.0 * m * k * n,
            m * k * x_bytes + k * n * bits / 8 + scale_rows * n * 4
            + m * n * 4)


def paged_decode(b: int, kh: int, g: int, dh: int, gs: int, live: int,
                 q_bytes: int) -> Tuple[float, float]:
    """One new query row per request over ``live`` cached slots in all
    (posit8 codes and ``gs`` bf16 scales per slot and head, keys and
    values), out in float32."""
    q = b * kh * g * dh
    return (4.0 * live * kh * g * dh,
            q * q_bytes + live * 2 * kh * (dh + 2 * gs) + q * 4)


def paged_prefill(c: int, kh: int, g: int, dh: int, gs: int, start: int,
                  q_bytes: int) -> Tuple[float, float]:
    """A chunk of ``c`` queries at positions start.. over the cached
    slots [0, start + c), causally; out in float32."""
    q = c * kh * g * dh
    pairs = c * start + c * (c + 1) // 2
    return (4.0 * pairs * kh * g * dh,
            q * q_bytes + (start + c) * 2 * kh * (dh + 2 * gs) + q * 4)


def dequant(k: int, n: int, bits: int, scale_rows: int,
            out_bytes: int) -> Tuple[float, float]:
    """Packed (K, N) codes and scales decoded into a dense (K, N)."""
    return float(k * n), k * n * bits / 8 + scale_rows * n * 4 \
        + k * n * out_bytes


@dataclasses.dataclass
class Model:
    """Per-forward constants of a configuration, from its reference's
    leaves and the served formats."""

    weight_bytes: float       # every served weight read once
    flops_per_token: float    # 2 x active matmul weights, read-out apart
    readout_flops: float      # 2 x d x V: one token's logits
    attn_layers: int
    attn_flops_per_pair: float  # 4 x H x Dh per (query, key) pair, a layer
    kv_slot_bytes: float      # one cached slot, all attention layers
    state_bytes: float        # one request's state slab, read + written

    @classmethod
    def of(cls, m: Dict, ref) -> "Model":
        weight = mat = 0.0
        for stack, depth, leaves in ref.stacks(m):
            w, f = _leaf_sums(f"{stack}/", leaves, m)
            weight += depth * w
            mat += depth * f
        w_top, _ = _leaf_sums("", [lf for lf in ref.top(m)
                                   if lf[0] != "embed/table"], m)
        d, v = m["d_model"], m["vocab"]
        hd = m["head_dim"]
        attn = m["n_layers"] // m["attn_every"] if m.get("attn_every") \
            else m["n_layers"]
        state = 0.0
        if m.get("attn_every"):
            din = m["mamba_expand"] * d
            rows = din + m["mamba_d_conv"] - 1      # h rows, conv rows
            codes = din * m["mamba_d_state"] + (m["mamba_d_conv"] - 1) * din
            state = 2.0 * (m["n_layers"] - attn) * (codes + 2 * rows)
        return cls(weight_bytes=weight + w_top,
                   flops_per_token=2.0 * mat,
                   readout_flops=2.0 * d * v,
                   attn_layers=attn,
                   attn_flops_per_pair=4.0 * m["n_heads"] * hd,
                   kv_slot_bytes=attn * 2 * m["n_kv_heads"] * (hd + 2),
                   state_bytes=state)

    def step(self, chunks: Iterable[Tuple[int, int]], sampled: int,
             decode_positions: Sequence[int]) -> Tuple[float, float]:
        """(operations, least bytes) of one engine step: prefill chunks
        as (start, real tokens), ``sampled`` first tokens read out of the
        prefill, and one decode forward over rows at the given
        positions."""
        flops = nbytes = 0.0
        for start, real in chunks:
            pairs = real * start + real * (real + 1) // 2
            flops += real * self.flops_per_token \
                + pairs * self.attn_flops_per_pair * self.attn_layers
            nbytes += self.weight_bytes \
                + (start + real) * self.kv_slot_bytes
        flops += sampled * self.readout_flops
        if decode_positions:
            rows = len(decode_positions)
            live = sum(p + 1 for p in decode_positions)
            flops += rows * (self.flops_per_token + self.readout_flops) \
                + live * self.attn_flops_per_pair * self.attn_layers
            nbytes += self.weight_bytes + live * self.kv_slot_bytes \
                + rows * self.state_bytes
        return flops, nbytes


def _leaf_sums(prefix: str, leaves, m) -> Tuple[float, float]:
    """(served bytes, matmul weights a token uses) of a slice's leaves:
    a packed matrix at its format's bits plus an f32 scale per column
    and slice; any other leaf as float32.  Experts count at
    experts-per-token of their number."""
    nbytes = mats = 0.0
    for path, shape, _ in leaves:
        n = 1
        for s in shape:
            n *= s
        fmt = codecs.weight_format(prefix + path)
        if fmt is not None:
            cols = n // shape[-2]
            nbytes += n * fmt.bits / 8 + cols * 4
        else:
            nbytes += n * 4
        if path.endswith("/w") and len(shape) == 2 or "experts/" in path:
            share = m["experts_per_tok"] / m["n_experts"] \
                if "experts/" in path else 1.0
            if not path.startswith("lm_head"):
                mats += n * share
    return nbytes, mats
