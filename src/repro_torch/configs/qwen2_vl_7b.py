"""qwen2-vl-7b [vlm] -- M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
Vision patch frontend is a STUB per the assignment: input_specs()
provides precomputed patch embeddings (256-patch span)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128,
    ffn_kind="swiglu", qkv_bias=True,
    frontend="vision", rope_kind="mrope", n_patches=256,
    source="arXiv:2409.12191; hf",
)
