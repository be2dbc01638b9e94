"""Target-hardware constants of the port: the NVIDIA H100 (the
counterpart of ``repro.roofline.hw``, whose entry is a TPU's).

``H100_SXM`` is NVIDIA's data sheet for the SXM5 part at its 700 W
limit: dense (no sparsity) bf16 tensor-core and float32 SIMT peaks, HBM3
bandwidth, one direction of NVLink 4 (900 GB/s both ways) and capacity.
``detect`` names the entry of the card a process runs on.
"""

from __future__ import annotations

import dataclasses

__all__ = ["HW", "H100_SXM", "KNOWN", "detect"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops_bf16: float     # FLOP/s per card (dense tensor cores)
    hbm_bw: float              # bytes/s per card
    ici_bw: float              # bytes/s per card, one direction of the link
    hbm_bytes: float           # capacity per card
    peak_flops_f32: float = 0.0   # FLOP/s per card outside the tensor cores


H100_SXM = HW(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    hbm_bytes=80e9,
    peak_flops_f32=67e12,
)

# (name fragment the card reports, least memory in bytes) -> entry.  The
# SXM5 part reports "NVIDIA H100 80GB HBM3"; the PCIe part reports
# "NVIDIA H100 PCIe" and has other peaks, so it is not matched.
KNOWN = ((("H100", "HBM3"), 79e9, H100_SXM),)


def detect(device=None) -> HW:
    """The entry of the CUDA card ``device`` (None: the current one),
    from its reported name and memory.  Raises on a card it does not
    know: an unknown card's peaks are never assumed."""
    import torch
    props = torch.cuda.get_device_properties(
        torch.device("cuda") if device is None else device)
    for words, least_bytes, hw in KNOWN:
        if all(w in props.name for w in words) \
                and props.total_memory >= least_bytes:
            return hw
    raise ValueError(f"no roofline entry for the card {props.name!r} "
                     f"({props.total_memory} bytes); known: "
                     f"{[hw.name for _, _, hw in KNOWN]}")
