"""kimi-k2-1t-a32b [moe] -- trillion-param MoE, 384 experts top-8, one
shared expert [arXiv:2501.kimi2; unverified (paper-table)]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, head_dim=112,
    ffn_kind="swiglu",
    n_experts=384, experts_per_tok=8, moe_d_ff=2048, shared_experts=1,
    source="arXiv:2501.kimi2; unverified",
)
