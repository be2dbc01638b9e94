"""Layer-adaptive precision assignment (paper eq. 1-2; the counterpart of
``repro.core.sensitivity``).

Each layer is scored with a first-order-Taylor sensitivity

    s_{l,sc,k} = ( ||Q^MxP(w_l) - w_l|| - ||Q^MxP'_{sc,k}(w_l) - w_l|| )
                 * ||grad L_{w_l}|| / n_l                      (eq. 1)
    s_l        = max(s_{l,sc,8}, s_{l,sc,4})                   (eq. 2)

how much the quantization error changes when layer l drops from the base
precision to an sc-bit candidate, weighted by the loss gradient's norm
and normalized per element.  Layers with low s_l take the low-bit
formats; the most sensitive keep the higher precision.  One calibration
gradient suffices.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import formats as fmt
from . import quant
from .formats import FormatSpec
from .policy import PrecisionPolicy, flatten_with_paths

__all__ = ["layer_sensitivity", "assign_layer_adaptive", "sensitivity_report"]


def _quant_err(spec: FormatSpec, w: torch.Tensor) -> torch.Tensor:
    q = quant.fake_quant(spec, w)
    return torch.linalg.norm((q - w).reshape(-1))


@torch.no_grad()
def layer_sensitivity(params, grads, base: FormatSpec = fmt.POSIT16,
                      candidates: Sequence[FormatSpec] = (fmt.POSIT8,
                                                          fmt.FP4)
                      ) -> Dict[str, float]:
    """s_l per parameter path (eq. 1-2) for every matrix leaf that has a
    gradient; ``grads`` is one calibration gradient tree of the same
    structure as ``params``.  One device-to-host copy for all scores."""
    g_leaves = dict(flatten_with_paths(grads))
    paths, scored = [], []
    for path, w in flatten_with_paths(params):
        if w.dim() < 2:           # norms/biases: never candidates
            continue
        g = g_leaves.get(path)
        if g is None:
            continue
        n_l = float(np.prod(w.shape))
        gnorm = torch.linalg.norm(g.reshape(-1))
        base_err = _quant_err(base, w)
        scores = [torch.abs(base_err - _quant_err(cand, w)) * gnorm / n_l
                  for cand in candidates]
        paths.append(path)
        scored.append(torch.max(torch.stack(scores)))
    values = torch.stack(scored).cpu().tolist() if scored else []
    return dict(zip(paths, values))


def assign_layer_adaptive(params, grads, target_avg_bits: float = 6.0,
                          low: FormatSpec = fmt.FP4,
                          mid: FormatSpec = fmt.POSIT8,
                          high: FormatSpec = fmt.POSIT16,
                          keep_fp32: Optional[Tuple[str, ...]] = None
                          ) -> PrecisionPolicy:
    """Greedy budgeted assignment: rank layers by s_l ascending; the least
    sensitive drop to ``mid``, then the least sensitive of those to
    ``low``, until the size-weighted average reaches
    ``target_avg_bits``; the rest keep ``high`` (the paper's HFP4 +
    Posit-8 + Posit-16 mixture)."""
    sens = layer_sensitivity(params, grads, base=high, candidates=(mid, low))
    sizes = {p: int(np.prod(w.shape))
             for p, w in flatten_with_paths(params) if p in sens}
    order = sorted(sens, key=lambda p: sens[p])    # least sensitive first
    total = sum(sizes.values())
    assign: Dict[str, str] = {p: high.name for p in order}
    spec_bits = {low.name: low.bits, mid.name: mid.bits,
                 high.name: high.bits}

    def avg_bits() -> float:
        return sum(sizes[p] * spec_bits[assign[p]] for p in order) \
            / max(total, 1)

    for p in order:
        if avg_bits() <= target_avg_bits:
            break
        assign[p] = mid.name
    for p in order:
        if avg_bits() <= target_avg_bits:
            break
        assign[p] = low.name
    pol = PrecisionPolicy(rules=list(assign.items()), default=high.name)
    if keep_fp32 is not None:
        pol.keep_fp32 = keep_fp32
    return pol


def sensitivity_report(params, grads, **kw) -> str:
    sens = layer_sensitivity(params, grads, **kw)
    lines = ["layer-sensitivity (eq.1-2), ascending:"]
    for p in sorted(sens, key=lambda p: sens[p]):
        lines.append(f"  {sens[p]:.3e}  {p}")
    return "\n".join(lines)
