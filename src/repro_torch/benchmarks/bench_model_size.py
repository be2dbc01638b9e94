"""Model-size table: the paper's 13.5 MB (FP32) -> 3.4 (FP8/INT8) -> 3.6
(Posit8/16) -> 2.42 MB (HFP4/Posit4/Posit8 mixed) UL-VIO story, from the
policy's memory model on the UL-VIO-sized model (the counterpart of
``benchmarks/bench_model_size.py``, same rows).  The sizes depend on the
shapes only; the weights are drawn on ``device``."""

from __future__ import annotations

import torch

from .. import resolve_device
from ..core.policy import PrecisionPolicy
from ..models import perception as P
from .common import emit

ROWS = (("fp32", "fp32"), ("fp8", "fp8_e4m3"), ("posit8", "posit8_0"),
        ("posit16", "posit16_1"), ("mxp_hfp4_posit", None), ("fp4", "fp4"))


def run(device=None) -> None:
    dev = resolve_device(device)
    # width chosen so fp32 lands near the paper's 13.5 MB UL-VIO figure
    params = P.vio_init(torch.Generator(dev).manual_seed(0), feat_dim=1024,
                        width=1024)
    rows = [(name, PrecisionPolicy.paper_mixed() if fmt is None
             else PrecisionPolicy.uniform(fmt)) for name, fmt in ROWS]
    base = rows[0][1].model_bytes(params)
    for name, pol in rows:
        b = pol.model_bytes(params)
        emit(f"model_size/{name}", 0.0,
             f"mb={b/1e6:.2f};ratio_vs_fp32={base/b:.2f}")
