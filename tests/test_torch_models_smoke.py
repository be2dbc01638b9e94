"""Per-architecture smoke tests of the port (the counterpart of
``tests/test_models_smoke.py``): a reduced config of each of the ten
architectures runs a forward, the loss, one gradient step and one decode
step on the CPU, with output shapes checked and no NaNs; the full
configs' figures, MoE specifics, analytic parameter counts and the
long_500k skips, with the MoE active-parameter share from the port's
``roofline.analysis``."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import one_torch_thread  # noqa: E402,F401
from repro_torch.configs import ARCH_IDS, all_cells, get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

B, S = 2, 64


def _batch_for(cfg):
    batch = {"labels": torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (B, S)))}
    if cfg.frontend == "audio":
        batch["frame_embeds"] = torch.as_tensor(
            np.random.default_rng(1).normal(size=(B, S, cfg.d_model)) * 0.02,
            dtype=torch.float32)
    else:
        batch["tokens"] = torch.as_tensor(
            np.random.default_rng(2).integers(0, cfg.vocab, (B, S)))
        if cfg.frontend == "vision":
            batch["patch_embeds"] = torch.as_tensor(
                np.random.default_rng(3).normal(
                    size=(B, cfg.n_patches, cfg.d_model)) * 0.02,
                dtype=torch.float32)
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke(arch):
    cfg = get_config(arch).reduced()
    params = T.lm_init(cfg, torch.Generator().manual_seed(0))
    batch = _batch_for(cfg)

    # forward + loss
    logits, _, aux = T.lm_apply(params, batch, cfg, mode="train",
                                with_aux=True)
    assert logits.shape == (B, S, cfg.vocab)
    assert torch.isfinite(logits.float()).all()
    loss, (ce, _) = T.lm_loss(params, batch, cfg)
    assert torch.isfinite(loss)
    # one train (grad) step
    leaves = [t for t in _leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    g = torch.autograd.grad(T.lm_loss(params, batch, cfg)[0], leaves,
                            allow_unused=True)
    gnorm = sum(float(x.abs().sum()) for x in g if x is not None)
    assert np.isfinite(gnorm) and gnorm > 0
    for t in leaves:
        t.requires_grad_(False)

    # one decode step with a cache
    cache = T.init_cache(cfg, B, 128, device="cpu")
    with torch.no_grad():
        logits2, _ = T.lm_decode(params, torch.zeros((B, 1),
                                                     dtype=torch.long),
                                 cfg, cache, 3)
    assert logits2.shape == (B, 1, cfg.vocab)
    assert torch.isfinite(logits2.float()).all()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_configs_match_assignment(arch):
    """Exact figures from the assignment table."""
    cfg = get_config(arch)
    expect = {
        "gemma-2b": (18, 2048, 8, 1, 16384, 256000),
        "deepseek-67b": (95, 8192, 64, 8, 22016, 102400),
        "command-r-plus-104b": (64, 12288, 96, 8, 33792, 256000),
        "qwen2-0.5b": (24, 896, 14, 2, 4864, 151936),
        "musicgen-medium": (48, 1536, 24, 24, 6144, 2048),
        "kimi-k2-1t-a32b": (61, 7168, 64, 8, 2048, 163840),
        "arctic-480b": (35, 7168, 56, 8, 4864, 32000),
        "qwen2-vl-7b": (28, 3584, 28, 4, 18944, 152064),
        "rwkv6-1.6b": (24, 2048, 0, 0, 7168, 65536),
        "jamba-v0.1-52b": (32, 4096, 32, 8, 14336, 65536),
    }[arch]
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab)
    assert got == expect, (arch, got, expect)


def test_moe_specifics():
    kimi = get_config("kimi-k2-1t-a32b")
    assert (kimi.n_experts, kimi.experts_per_tok) == (384, 8)
    arctic = get_config("arctic-480b")
    assert (arctic.n_experts, arctic.experts_per_tok) == (128, 2)
    assert arctic.dense_residual
    jamba = get_config("jamba-v0.1-52b")
    assert (jamba.n_experts, jamba.experts_per_tok) == (16, 2)
    assert jamba.attn_every == 8 and jamba.moe_every == 2  # 1:7 interleave


def test_param_counts_plausible():
    """Analytic parameter counts are in the advertised ballpark (the
    reference's ranges), and MoE active params far below total."""
    from repro_torch.roofline import analysis as ra
    checks = {
        "gemma-2b": (2.0e9, 3.5e9),
        "deepseek-67b": (60e9, 72e9),
        "command-r-plus-104b": (95e9, 115e9),
        "qwen2-0.5b": (0.3e9, 0.7e9),
        "kimi-k2-1t-a32b": (0.85e12, 1.25e12),
        "arctic-480b": (420e9, 530e9),
        "jamba-v0.1-52b": (45e9, 60e9),
        "rwkv6-1.6b": (1.2e9, 2.2e9),
    }
    for arch, (lo, hi) in checks.items():
        n = get_config(arch).param_count()
        assert lo <= n <= hi, (arch, n)
    kimi = get_config("kimi-k2-1t-a32b")
    act = ra.active_param_count(kimi)
    assert act < 0.06 * kimi.param_count()


def test_long_500k_skips_are_correct():
    skipped = {(a, s) for a, s, _, _, ok in all_cells() if not ok}
    assert all(s == "long_500k" for _, s in skipped)
    runnable_500k = {a for a, s, _, _, ok in all_cells()
                     if s == "long_500k" and ok}
    assert runnable_500k == {"rwkv6-1.6b", "jamba-v0.1-52b"}
