"""Common layers (the counterpart of ``repro.models.layers``).

A dense weight is a plain tensor or a ``PackedTensor``; a packed one runs
the RMMEC kernel (``kernels.ops.packed_matmul``), which launches on a
CUDA tensor and takes its plain version on a CPU tensor.  Parameters are
nested dicts with the reference's keys; initialisers draw from a
``torch.Generator`` on its device.

``rowstable_matmul`` multiplies through GEMMs of one fixed shape on the
card, so that a row's result does not depend on how many rows share the
call.  The recurrent and MoE blocks use it for the weights the serving
policy leaves unpacked (``dt_proj``, the decay LoRA, the router, the
decoded expert slices): a request decoded alone and the same request
decoded in a batch of eight, or prefilled whole and in chunks, then see
the same bits.  Every other unpacked product is one matmul.
"""

from __future__ import annotations

import math

import torch

from ..kernels.ops import PackedTensor, packed_matmul

__all__ = ["dense_init", "dense", "rmsnorm_init", "rmsnorm", "embed_init",
           "embed", "embed_logits", "ffn_init", "ffn", "rope", "mrope",
           "rope_freqs", "normal", "rowstable_matmul"]

# rows of one GEMM of ``rowstable_matmul`` on the card
ROW_TILE = 64


def _uniform(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return u * (2.0 * scale) - scale


def normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device) * std


def rowstable_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) in the dtype of ``x``.  On a CUDA tensor the
    rows go through GEMMs of exactly ``ROW_TILE`` rows (the last tile
    zero-padded): the library picks its kernel, and with it the order of
    the K sums, from the shape, so one shape for every call keeps each
    row's bits independent of M.  On the CPU it is one matmul."""
    w = w.to(x.dtype)
    if not x.is_cuda:
        return x @ w
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    mp = -(-m // ROW_TILE) * ROW_TILE
    if mp != m:
        x2 = torch.cat([x2, x2.new_zeros((mp - m, k))])
    tiles = [x2[r:r + ROW_TILE] @ w for r in range(0, mp, ROW_TILE)]
    out = tiles[0] if len(tiles) == 1 else torch.cat(tiles)
    return out[:m].reshape(*lead, w.shape[-1])


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               bias: bool = False, lead=()):
    """``lead`` stacks the weight, e.g. ``(n_layers,)``."""
    p = {"w": _uniform(gen, (*lead, d_in, d_out), 1.0 / math.sqrt(d_in))}
    if bias:
        p["bias"] = torch.zeros((*lead, d_out), device=gen.device)
    return p


def dense(p, x: torch.Tensor, rowstable: bool = False) -> torch.Tensor:
    """x @ w (+ bias), in the dtype of ``x``.  ``rowstable``: an unpacked
    weight multiplies through ``rowstable_matmul`` (a packed one is
    row-stable in its kernel already)."""
    w = p["w"]
    if isinstance(w, PackedTensor):
        y = packed_matmul(x, w).to(x.dtype)
    elif rowstable:
        y = rowstable_matmul(x, w)
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


def _apply_rot(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh); positions (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    return _apply_rot(x, cos, sin)


def mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
          sections=None) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): the Dh/2 frequency dims are split into
    (t, h, w) sections, each rotated by its own position stream.

    x (B, S, H, Dh); positions3 (3, B, S) int.  The default sections are
    the reference's: (16, 24, 24) at Dh 128."""
    half = x.shape[-1] // 2
    if sections is None:
        hw = 3 * half // 8
        sections = (half - 2 * hw, hw, hw)
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)
    ang = positions3[sec_id].movedim(0, -1).float() * freqs
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    return _apply_rot(x, cos, sin)
