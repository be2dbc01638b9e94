"""rwkv6-1.6b [ssm] -- Finch, data-dependent decay, attention-free
[arXiv:2404.05892; unverified].  Sub-quadratic: runs the long_500k cell."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=7168, vocab=65536, rwkv_head_dim=64,
    sub_quadratic=True,
    source="arXiv:2404.05892; unverified",
)
