"""jamba-v0.1-52b [hybrid] -- Mamba+attn 1:7 interleave, MoE 16e top-2
every other layer [arXiv:2403.19887; hf].  Sub-quadratic (Mamba state +
sparse attention layers): runs the long_500k cell."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, head_dim=128,
    ffn_kind="swiglu",
    n_experts=16, experts_per_tok=2, moe_d_ff=14336, moe_every=2,
    attn_every=8, mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    sub_quadratic=True,
    source="arXiv:2403.19887; hf",
)
