"""Static-batch serving engine: prefill, then one-token decode steps over
the packed weight plane and an optional posit8 KV cache (the counterpart
of ``repro.serve.engine.ServeEngine``).

With ``quantized_kv`` the prefill cache is quantized to posit8 codes and
bf16 po2 scales at once, padded to ``max_len`` (scales pad with 1.0),
and every decode step writes its token's codes in place and reads only
the live prefix through the flash-decode kernel.  The weights are packed
once when the engine is built, and the tied read-out table is cast to
the compute dtype once then, not at every step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..core.formats import torch_dtype
from ..core.policy import PrecisionPolicy
from ..kernels.ops import PackedTensor
from ..models import zoo

__all__ = ["build_prefill_step", "build_serve_step", "ServeEngine"]


def build_prefill_step(cfg: ModelConfig, last_logit_only: bool = False,
                       quantized_kv: bool = False,
                       kv_group: Optional[int] = None):
    """(params, batch) -> (logits, cache): the full-sequence forward that
    also fills the KV cache (posit8 under ``quantized_kv``)."""

    def prefill(params, batch):
        logits, cache = zoo.apply_model(params, batch, cfg,
                                        last_only=last_logit_only)
        if quantized_kv:
            cache = zoo.quantize_cache(cache, kv_group)
        return logits, cache

    return prefill


def _next_token(logits, generator: Optional[torch.Generator],
                temperature: float) -> torch.Tensor:
    """Greedy (first-occurrence argmax) at temperature 0, else a sample of
    softmax(logits / temperature) drawn from ``generator``."""
    lg = logits[:, -1]
    if temperature > 0:
        probs = torch.softmax(lg.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(lg, dim=-1, keepdim=True)


def build_serve_step(cfg: ModelConfig):
    """(params, tokens (B, 1), cache, pos, pad, generator, temperature)
    -> (next tokens (B, 1), cache): one decode step with sampling fused
    in; the cache is updated in place.  ``pad`` (B,) int32 left-pad
    widths of a ragged batch, or None."""

    def serve_step(params, tokens, cache, pos: int, pad, generator,
                   temperature: float):
        logits, cache = zoo.decode_model(params, tokens, cfg, cache, pos, pad)
        return _next_token(logits, generator, temperature), cache

    return serve_step


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, PackedTensor)):
        return tree.to(device)
    return tree


class ServeEngine:
    """Static-batch serving with greedy / temperature sampling."""

    # cache leaves with a sequence axis, laid out (L, B, S, H, ...)
    _SEQ_KEYS = frozenset({"k", "v", "k_codes", "v_codes", "k_scale",
                           "v_scale"})
    # scales pad with the neutral po2 scale 1.0, never 0.0
    _SCALE_KEYS = frozenset({"k_scale", "v_scale"})

    def __init__(self, cfg: ModelConfig, params, max_len: int = 2048,
                 quantized_kv: bool = False,
                 policy: Optional[PrecisionPolicy] = None, device=None):
        self.cfg = cfg
        self.max_len = max_len
        self.quantized_kv = quantized_kv
        self.policy = policy
        self.device = resolve_device(device)
        params = _to_device(params, self.device)
        if policy is not None:
            params = zoo.pack_params(params, policy)
        # the tied read-out casts the table to the compute dtype: do it
        # once here (embed() takes the same cast, so nothing changes)
        params = dict(params, embed={
            "table": params["embed"]["table"].to(torch_dtype(cfg.dtype))})
        self.params = params
        kv_group = policy.group_size if policy else None
        self._prefill = build_prefill_step(cfg, last_logit_only=True,
                                           quantized_kv=quantized_kv,
                                           kv_group=kv_group)
        self._step = build_serve_step(cfg)

    @torch.inference_mode()
    def generate(self, tokens, steps: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 lengths=None) -> np.ndarray:
        """tokens (B, S0) prompt -> (B, S0 + steps) completed.

        ``lengths``: optional (B,) true prompt lengths of a LEFT-padded
        ragged batch; pad tokens are masked out of attention and RoPE
        positions start at each request's first real token."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                 device=self.device)
        b, s0 = tokens.shape
        if s0 + steps > self.max_len:
            raise ValueError(f"prompt {s0} + {steps} steps exceeds max_len "
                             f"{self.max_len}")
        batch = {"tokens": tokens}
        pad = None
        if lengths is not None:
            lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int32,
                                      device=self.device)
            pad = (s0 - lengths).to(torch.int32)
            idx = torch.arange(s0, dtype=torch.int32, device=self.device)[None]
            batch["positions"] = torch.clamp(idx - pad[:, None], min=0)
            batch["kv_mask"] = idx >= pad[:, None]
        logits, cache = self._prefill(self.params, batch)
        cache = self._pad_cache(cache)
        last = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        outs = [tokens]
        for i in range(steps):
            outs.append(last)
            last, cache = self._step(self.params, last, cache, s0 + i, pad,
                                     generator, temperature)
        return torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)

    def _pad_cache(self, cache):
        """Grow the prefill-length cache to ``max_len`` slots (seq axis 2)."""
        out = {}
        for key, x in cache.items():
            if key in self._SEQ_KEYS and x.shape[2] < self.max_len:
                fill = 1.0 if key in self._SCALE_KEYS else 0.0
                full = torch.full(x.shape[:2] + (self.max_len,) + x.shape[3:],
                                  fill, dtype=x.dtype, device=x.device)
                full[:, :, : x.shape[2]] = x
                x = full
            out[key] = x
        return out
