"""The comparison that decides ``correct`` for a served model.

For each compared request the reference computes, from the prompt and
the served tokens, the logits that predict every served token.  A
served token's *gap* is how far its reference logit lies below the
reference's best logit at that position: 0 where the program served
the reference's own greedy choice, small where it chose between two
near-equal logits, large where it served something the reference would
not.  Each gap is read twice: on the float32 logits, and on the same
logits rounded to ``READOUT``, the precision the program's read-out
writes, where two logits that round alike tie and a served token tied
with the best has gap 0.

The control puts the reference itself in the program's place at a lower
precision: at the same positions it takes the token its own logits put
first, and reads that token's gap in the full-precision logits."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["READOUT", "served_gaps", "control_gaps", "sample"]

READOUT = torch.bfloat16


def served_gaps(ref: Sequence[torch.Tensor], served: Sequence[np.ndarray],
                grid: Optional[torch.dtype] = None) -> List[np.ndarray]:
    """Per request, the gap of each served token (float64 numpy); with
    ``grid``, read on the logits rounded to that dtype."""
    out = []
    for lg, toks in zip(ref, served):
        if grid is not None:
            lg = lg.to(grid).float()
        t = torch.as_tensor(np.asarray(toks, np.int64), device=lg.device)
        gap = lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]
        out.append(gap.double().cpu().numpy())
    return out


def control_gaps(ref: Sequence[torch.Tensor], low: Sequence[torch.Tensor],
                 grid: Optional[torch.dtype] = None) -> List[np.ndarray]:
    """Per request, the gap of the token the lower precision puts first
    (its first maximum, as the program's greedy sampling takes)."""
    return served_gaps(ref, [lw.argmax(-1).cpu().numpy() for lw in low],
                       grid)


def sample(finished: Sequence[dict], seed: int, tokens: int,
           most: int) -> List[dict]:
    """Requests to compare, drawn from the seed: the one that served the
    most tokens, then others in a seeded order until ``tokens`` served
    tokens are covered or ``most`` requests are taken."""
    if not finished:
        return []
    pool = sorted(finished, key=lambda r: (-len(r["served"]), r["rid"]))
    picked = [pool[0]]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0x5EED])
    for i in rng.permutation(len(pool) - 1) + 1:
        if sum(len(r["served"]) for r in picked) >= tokens \
                or len(picked) >= most:
            break
        picked.append(pool[int(i)])
    return picked
