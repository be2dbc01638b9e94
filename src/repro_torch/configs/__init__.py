"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Only the architectures the port serves so far are registered."""

from __future__ import annotations

from .base import ModelConfig
from .qwen2_0_5b import CONFIG as _qwen2_05b

__all__ = ["ModelConfig", "ARCHS", "get_config"]

ARCHS = {c.name: c for c in (_qwen2_05b,)}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]
