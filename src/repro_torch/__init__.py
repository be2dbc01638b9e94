"""XR-NPE reproduction in PyTorch for NVIDIA Hopper.

The counterpart of the JAX package ``repro``: the same number formats,
packed-weight data plane, decoder LMs of the dense, MoE, recurrent
(rwkv6) and hybrid (jamba) families, static, continuous and
disaggregated serving engines (posit8 KV pages and state slabs), and the paper's SIMD-MAC engine plane (``core.npe``,
``core.quire``, the Table II/III bench twins in ``benchmarks``), with
the TPU's six Pallas kernels rewritten as CUDA C++ kernels for
``sm_90a`` (``csrc/``, built with ``nvcc`` at first use):
``rmmec_matmul``, ``flash_decode``, ``paged_flash_decode``,
``paged_flash_prefill``, ``dequant`` and ``quire_dot``.  Every kernel
wrapper launches its kernel on a CUDA tensor and runs its plain PyTorch
version on a CPU tensor.

On the CPU, ``python -m pytest tests/test_torch_*.py`` holds the port to
the JAX package; on the card, ``python3 chip_smoke.py`` checks every
kernel against its plain version and drives every path (phase 2c: the
engine plane's kernels; phase 5: its bench twins), and
``python -m repro_torch.benchmarks.run`` prints the bench twins' CSV.

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
