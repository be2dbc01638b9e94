"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Only the architectures the port serves so far are registered: the dense
qwen2-0.5b, the recurrent rwkv6-1.6b, the hybrid jamba-v0.1-52b and the
MoE arctic-480b and kimi-k2-1t-a32b."""

from __future__ import annotations

from .arctic_480b import CONFIG as _arctic
from .base import ModelConfig
from .jamba_v0_1_52b import CONFIG as _jamba
from .kimi_k2_1t_a32b import CONFIG as _kimi_k2
from .qwen2_0_5b import CONFIG as _qwen2_05b
from .rwkv6_1_6b import CONFIG as _rwkv6

__all__ = ["ModelConfig", "ARCHS", "get_config"]

ARCHS = {c.name: c for c in (_qwen2_05b, _kimi_k2, _arctic, _rwkv6, _jamba)}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]
