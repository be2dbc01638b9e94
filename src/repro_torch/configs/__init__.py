"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

The ten architectures of the reference's registry, in its order (each
with its own shape set, ``base.SHAPES``): the dense gemma-2b,
deepseek-67b, command-r-plus-104b and qwen2-0.5b, the audio
musicgen-medium and the vision qwen2-vl-7b (stub frontends: precomputed
frame / patch embeddings), the MoE kimi-k2-1t-a32b and arctic-480b, the
recurrent rwkv6-1.6b and the hybrid jamba-v0.1-52b."""

from __future__ import annotations

from .arctic_480b import CONFIG as _arctic
from .base import SHAPES, ModelConfig, RunConfig, ShapeConfig
from .command_r_plus_104b import CONFIG as _command_r
from .deepseek_67b import CONFIG as _deepseek_67b
from .gemma_2b import CONFIG as _gemma_2b
from .jamba_v0_1_52b import CONFIG as _jamba
from .kimi_k2_1t_a32b import CONFIG as _kimi_k2
from .musicgen_medium import CONFIG as _musicgen
from .qwen2_0_5b import CONFIG as _qwen2_05b
from .qwen2_vl_7b import CONFIG as _qwen2_vl
from .rwkv6_1_6b import CONFIG as _rwkv6

__all__ = ["ModelConfig", "RunConfig", "ShapeConfig", "SHAPES", "ARCHS",
           "ARCH_IDS", "get_config", "get_shape", "cell_is_runnable",
           "all_cells"]

ARCHS = {
    c.name: c for c in (
        _gemma_2b, _deepseek_67b, _command_r, _qwen2_05b, _musicgen,
        _kimi_k2, _arctic, _qwen2_vl, _rwkv6, _jamba,
    )
}

ARCH_IDS = tuple(ARCHS)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k requires sub-quadratic sequence mixing: it is skipped
    for the pure full-attention architectures."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False
    return True


def all_cells():
    """The 40-cell (arch x shape) grid with runnability flags."""
    for arch in ARCH_IDS:
        cfg = ARCHS[arch]
        for sname, shape in SHAPES.items():
            yield arch, sname, cfg, shape, cell_is_runnable(cfg, shape)
