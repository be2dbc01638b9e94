"""musicgen-medium [audio] -- decoder-only over EnCodec tokens, MHA (kv=24)
[arXiv:2306.05284; hf].  The EnCodec frontend is a STUB per the
assignment: input_specs() provides precomputed frame embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="dense",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048, head_dim=64,
    ffn_kind="gelu", frontend="audio",
    source="arXiv:2306.05284; hf",
)
