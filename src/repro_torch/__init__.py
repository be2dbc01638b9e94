"""XR-NPE reproduction in PyTorch for NVIDIA Hopper.

The counterpart of the JAX package ``repro``: the same number formats,
packed-weight data plane, dense decoder and static serving engine, with
the TPU's Pallas kernels rewritten as CUDA C++ kernels for ``sm_90a``
(``csrc/``, built with ``nvcc`` at first use).  Every kernel wrapper
launches its kernel on a CUDA tensor and runs its plain PyTorch version
on a CPU tensor.

Entry points take ``device=None``, which means ``"cuda"``; they raise
when no card is present unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
