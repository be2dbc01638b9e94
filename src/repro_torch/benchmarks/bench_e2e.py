"""Table IV analogue -- end-to-end inference of the packed serving plane
against the fp32 dense plane on the same model (the counterpart of
``benchmarks/bench_e2e.py``, same rows): wall time, weight bytes (the
energy proxy: off-chip movement) and output agreement (total-variation
distance of the next-token distributions).

The config is the reference's reduced qwen2, or qwen2-0.5b at full width
with ``full``.  On the card the packed rows run the RMMEC kernel.

  python -m repro_torch.benchmarks.bench_e2e [--full] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..core.policy import PrecisionPolicy, flatten_with_paths
from ..models import zoo
from .common import bench_config, emit, time_call


def run(device=None, full: bool = False) -> dict:
    dev = resolve_device(device)
    cfg = bench_config(full=full)
    params = zoo.init_model(cfg, torch.Generator(dev).manual_seed(0))
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (4, 64)),
        device=dev)}

    def logits(p):
        with torch.inference_mode():
            return zoo.apply_model(p, batch, cfg)[0]

    out = {}
    dense_bytes = sum(int(np.prod(tuple(leaf.shape))) * 4
                      for _, leaf in flatten_with_paths(params))
    us_dense = time_call(logits, params)
    emit("e2e/fp32_dense", us_dense, f"weight_bytes={dense_bytes}")
    out["fp32_dense"] = {"us": us_dense, "weight_bytes": dense_bytes}
    ref = torch.softmax(logits(params).float(), -1)
    for name, pol in (("posit8", PrecisionPolicy.uniform("posit8_0")),
                      ("mxp_paper", PrecisionPolicy.paper_mixed())):
        packed = zoo.pack_params(params, pol)
        pbytes = sum(leaf.numel() * leaf.element_size()
                     for _, leaf in flatten_with_paths(packed))
        us = time_call(logits, packed)
        got = torch.softmax(logits(packed).float(), -1)
        tv = float(0.5 * torch.mean(torch.sum(torch.abs(ref - got), -1)))
        emit(f"e2e/packed_{name}", us,
             f"weight_bytes={pbytes};traffic_gain={dense_bytes/pbytes:.2f};"
             f"tv_dist={tv:.4f}")
        out[f"packed_{name}"] = {"us": us, "weight_bytes": pbytes,
                                 "traffic_gain": dense_bytes / pbytes,
                                 "tv_dist": tv}
        del packed
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="qwen2-0.5b at full width (default: reduced)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    run(args.device, full=args.full)


if __name__ == "__main__":
    main()
