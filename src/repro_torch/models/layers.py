"""Common layers (the counterpart of ``repro.models.layers``).

A dense weight is a plain tensor or a ``PackedTensor``; a packed one runs
the RMMEC kernel (``kernels.ops.packed_matmul``), which launches on a
CUDA tensor and takes its plain version on a CPU tensor.  Parameters are
nested dicts with the reference's keys; initialisers draw from a
``torch.Generator`` on its device.
"""

from __future__ import annotations

import math

import torch

from ..kernels.ops import PackedTensor, packed_matmul

__all__ = ["dense_init", "dense", "rmsnorm_init", "rmsnorm", "embed_init",
           "embed", "embed_logits", "ffn_init", "ffn", "rope", "rope_freqs"]


def _uniform(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return u * (2.0 * scale) - scale


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               bias: bool = False, lead=()):
    """``lead`` stacks the weight, e.g. ``(n_layers,)``."""
    p = {"w": _uniform(gen, (*lead, d_in, d_out), 1.0 / math.sqrt(d_in))}
    if bias:
        p["bias"] = torch.zeros((*lead, d_out), device=gen.device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ bias), in the dtype of ``x``."""
    w = p["w"]
    if isinstance(w, PackedTensor):
        y = packed_matmul(x, w).to(x.dtype)
    else:
        y = x @ w.to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def rmsnorm_init(d: int, lead=(), device=None):
    return {"norm_scale": torch.ones((*lead, d), device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(torch.square(x32), -1, keepdim=True)
                          + eps)
    return (y * p["norm_scale"]).to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int):
    return {"table": torch.randn((vocab, d), generator=gen, device=gen.device)
            * 0.02}


def embed(p, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return p["table"].to(dtype)[tokens]


def embed_logits(p, x: torch.Tensor) -> torch.Tensor:
    """Tied read-out x @ table^T.  The serving engine stores the table in
    the compute dtype once, so the cast here is free on the decode path."""
    return x @ p["table"].to(x.dtype).T


def ffn_init(gen: torch.Generator, d: int, d_ff: int, kind: str = "swiglu",
             out_bias: bool = False, lead=()):
    if kind in ("swiglu", "geglu"):
        return {"gate": dense_init(gen, d, d_ff, lead=lead),
                "up": dense_init(gen, d, d_ff, lead=lead),
                "down": dense_init(gen, d_ff, d, bias=out_bias, lead=lead)}
    return {"up": dense_init(gen, d, d_ff, lead=lead),
            "down": dense_init(gen, d_ff, d, bias=out_bias, lead=lead)}


def ffn(p, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        g = dense(p["gate"], x)
        act = torch.nn.functional.silu(g) if kind == "swiglu" \
            else torch.nn.functional.gelu(g, approximate="tanh")
        h = act * dense(p["up"], x)
    else:
        h = torch.nn.functional.gelu(dense(p["up"], x), approximate="tanh")
    return dense(p["down"], h)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh); positions (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
