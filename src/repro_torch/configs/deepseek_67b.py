"""deepseek-67b [dense] -- llama-arch, GQA kv=8 [arXiv:2401.02954; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400, head_dim=128,
    ffn_kind="swiglu",
    source="arXiv:2401.02954; hf",
)
