"""Three-term roofline of one rank's step (the counterpart of
``repro.roofline.analysis``), on the H100's constants by default.

  compute term    = FLOPs / peak                 [dry run: FLOP counter]
  memory term     = bytes accessed / hbm_bw      [dry run: op operands]
  collective term = wire_bytes / ici_bw          [dry run: collectives]

The dry run (``launch/dryrun.py``) counts per rank, so the terms use the
per-rank numbers directly.  Collectives come from the calls the dry run
saw, each an (op, operand bytes, result bytes) triple, under the
reference's wire model: an all-gather receives result - operand bytes,
an all-reduce moves ~2x operand in a ring, a reduce-scatter operand -
result.  The model arithmetic (``model_flops``, ``min_traffic_bytes``,
``decode_kv_bytes``, ``summarize_cell``) is the reference's, operation
for operation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

from ..configs.base import ModelConfig, ShapeConfig
from .hw import H100_SXM, HW

__all__ = ["COLLECTIVE_OPS", "collective_stats", "roofline_terms",
           "model_flops", "min_traffic_bytes", "summarize_cell",
           "active_param_count", "total_param_count", "decode_kv_bytes"]

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


def collective_stats(calls: Iterable[Tuple[str, float, float]]
                     ) -> Dict[str, float]:
    """Per-rank collective byte counts by op kind, from the
    ``(op, operand_bytes, result_bytes)`` calls of one step."""
    out: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_OPS}
    count = 0
    operand_sum = 0.0
    wire_sum = 0.0
    for op, obytes, rbytes in calls:
        if op not in out:
            raise ValueError(f"unknown collective {op!r}; known: "
                             f"{COLLECTIVE_OPS}")
        count += 1
        if obytes == 0:  # as the reference: fall back to the result
            obytes = rbytes
        out[op] += obytes
        if op == "all-gather":
            wire_sum += max(rbytes - obytes, 0)
        elif op == "all-reduce":
            wire_sum += 2 * obytes
        elif op == "reduce-scatter":
            wire_sum += max(obytes - rbytes, 0)
        else:
            wire_sum += obytes
        operand_sum += obytes
    out["count"] = float(count)
    out["operand_bytes"] = operand_sum
    out["wire_bytes"] = wire_sum
    return out


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top-k + shared experts only)."""
    if not cfg.n_experts:
        return cfg.param_count()
    active = dataclasses.replace(
        cfg,
        n_experts=cfg.experts_per_tok,
        # shared experts / dense residual stay (they are always-on)
    )
    return active.param_count()


def total_param_count(cfg: ModelConfig) -> int:
    return cfg.param_count()


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful model FLOPs for the whole step (global, not per rank).

    train  : 6 * N_active * tokens   (fwd 2x + bwd 4x)
    prefill: 2 * N_active * tokens
    decode : 2 * N_active * batch    (one token per sequence)
             + attention KV reads are memory, not matmul flops
    """
    n_act = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n_act * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.seq_len * shape.global_batch
    return 2.0 * n_act * shape.global_batch


def roofline_terms(cost: Dict[str, float], colls: Dict[str, float],
                   chips: int, hw: HW = H100_SXM,
                   per_device_cost: bool = True) -> Dict[str, float]:
    flops_dev = cost.get("flops", 0.0)
    bytes_dev = cost.get("bytes accessed", 0.0)
    if not per_device_cost:
        flops_dev /= chips
        bytes_dev /= chips
    t_compute = flops_dev / hw.peak_flops_bf16
    t_memory = bytes_dev / hw.hbm_bw
    t_coll = colls.get("wire_bytes", 0.0) / hw.ici_bw
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "coll_wire_bytes_per_device": colls.get("wire_bytes", 0.0),
        "coll_operand_bytes_per_device": colls.get("operand_bytes", 0.0),
        "coll_count": colls.get("count", 0.0),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": max(t_compute, t_memory, t_coll),
    }


def min_traffic_bytes(cfg: ModelConfig, shape: ShapeConfig,
                      weight_bits: float = 4.5,
                      quantized_kv: bool = False) -> float:
    """Analytic minimum HBM traffic for the step (global bytes): the
    memory-side 'useful work' that no implementation can avoid.

    train  : params f32 read (fwd) + read (bwd) + grad write + opt m/v
             read+write (8-bit) + one activation-boundary pass per layer.
    prefill: packed weights once + activation stream per layer.
    decode : packed weights once + KV cache read (+write 1 token).
    """
    n = cfg.param_count()
    n_act = active_param_count(cfg)
    toks = shape.seq_len * shape.global_batch
    d = cfg.d_model
    if shape.kind == "train":
        w = n * 4 * 3 + n * 1 * 4            # fp32 fwd+bwd+gradw, 8bit m/v rw
        acts = cfg.n_layers * toks * d * 2 * 4   # bf16, ~4 boundary tensors
        return float(w + acts)
    wbytes = n_act * weight_bits / 8
    if shape.kind == "prefill":
        acts = cfg.n_layers * toks * d * 2 * 2
        return float(wbytes + acts)
    # decode: one token; KV read dominates
    kv_bits = 8 if quantized_kv else 16
    n_attn = cfg.n_attn_layers
    if cfg.family == "ssm":
        kv = shape.global_batch * cfg.n_layers * \
            (cfg.d_model // max(cfg.rwkv_head_dim, 1)) * \
            cfg.rwkv_head_dim ** 2 * 4 * 2
    else:
        kv = (2 * n_attn * shape.seq_len * cfg.n_kv_heads *
              cfg.resolved_head_dim * shape.global_batch * kv_bits / 8)
    return float(wbytes + kv)


def decode_kv_bytes(cfg: ModelConfig, batch: int, max_len: int, pos: int,
                    quantized: bool = False, kv_group=None,
                    length_aware: bool = True, blk: int = 128) -> float:
    """Modeled KV-cache HBM bytes moved by ONE decode step (all layers).

    bf16 baseline: the full (max_len) k+v buffers are read per step.
    quantized    : uint8 codes + bf16 scales in the unified
                   ``group_scales`` layout (Gs = Dh/kv_group columns);
                   with ``length_aware`` only the ceil((pos+1)/blk) live
                   KV blocks are touched -- independent of ``max_len``.
    The per-step model behind ``benchmarks/bench_decode.py``; it uses the
    same attention-layer count as :func:`min_traffic_bytes`.
    """
    from ..kernels.ref import kv_scale_cols
    n_attn = cfg.n_attn_layers
    hd = cfg.resolved_head_dim
    rows = n_attn * batch * cfg.n_kv_heads        # per cached token
    if not quantized:
        return float(2 * rows * max_len * hd * 2)            # k+v bf16
    gs = kv_scale_cols(hd, kv_group)
    toks = -(-(pos + 1) // blk) * blk if length_aware else max_len
    return float(2 * rows * toks * (hd * 1 + gs * 2))        # codes+scales


def summarize_cell(cfg: ModelConfig, shape: ShapeConfig, terms: Dict,
                   chips: int, hw: HW = H100_SXM,
                   weight_bits: float = 4.5,
                   quantized_kv: bool = False) -> Dict[str, float]:
    """Attach MODEL_FLOPS ratios + roofline fractions to the raw terms.

    Two fractions are reported:
      roofline_fraction_compute -- useful-FLOPs time at peak over the
        dominant term (the classic MFU-style number; apt for train).
      roofline_fraction -- ideal step time (max of useful-FLOPs time and
        analytic minimum-traffic time) over the dominant term: meaningful
        for memory-bound shapes (decode), where the floor is traffic, not
        FLOPs.
    """
    mf = model_flops(cfg, shape)
    flops_global = terms["flops_per_device"] * chips
    useful_ratio = mf / flops_global if flops_global else 0.0
    t_useful_c = mf / (chips * hw.peak_flops_bf16)
    mt = min_traffic_bytes(cfg, shape, weight_bits, quantized_kv)
    t_useful_m = mt / (chips * hw.hbm_bw)
    t_ideal = max(t_useful_c, t_useful_m)
    bound = terms["bound_s"]
    out = dict(terms)
    out.update({
        "model_flops": mf,
        "useful_flops_ratio": useful_ratio,
        "min_traffic_bytes": mt,
        "t_ideal_s": t_ideal,
        "roofline_fraction_compute": t_useful_c / bound if bound else 0.0,
        "roofline_fraction": t_ideal / bound if bound else 0.0,
    })
    return out
