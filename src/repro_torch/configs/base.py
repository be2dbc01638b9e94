"""Model / shape / run configuration dataclasses (a copy of
``repro.configs.base``).

The port keeps its own copy so that it imports nothing of the JAX
package; the field names and defaults are the reference's, so a config
built on either side describes the same model (``RunConfig``: the same
run).  ``reduced()`` derives
the CPU-test variant (same family and wiring, tiny dims).
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "RunConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- attention flavour
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    rope_kind: str = "default"     # default | mrope
    # --- ffn flavour
    ffn_kind: str = "swiglu"       # swiglu | geglu | gelu
    out_bias: bool = False
    tie_embeddings: bool = False
    # --- MoE
    n_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0
    shared_experts: int = 0
    dense_residual: bool = False
    moe_every: int = 1
    capacity_factor: float = 1.25
    # --- hybrid / ssm
    attn_every: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rwkv_head_dim: int = 64
    # --- modality frontend
    frontend: str = "none"         # none | audio | vision
    n_patches: int = 0
    # --- numerics
    dtype: str = "bfloat16"
    remat: str = "full"
    scan_layers: bool = True
    seq_chunk: int = 1024          # prefill attention kv/q chunking
    ssm_chunk: int = 64
    attn_impl: str = "scan"        # scan (online softmax over kv chunks)
    attn_scores_f32: bool = True
    decode_impl: str = "blocked"   # read by the reference only: the port
                                   # picks the decode kernel by device
    sub_quadratic: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def n_attn_layers(self) -> int:
        """Attention-layer count: all layers, or 1 per ``attn_every``
        group for hybrid stacks."""
        if self.attn_every == 0:
            return self.n_layers
        return self.n_layers // self.attn_every

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if self.attn_every == 0 else
                         max(2, self.attn_every)),
            d_model=128,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32 if self.n_heads else 0,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            experts_per_tok=min(self.experts_per_tok, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            shared_experts=min(self.shared_experts, 1),
            mamba_d_state=8,
            rwkv_head_dim=32,
            n_patches=min(self.n_patches, 8),
            seq_chunk=32,
            ssm_chunk=8,
            remat="none",
        )

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.n_heads:
            per_layer += d * hd * (self.n_heads + 2 * self.n_kv_heads)  # qkv
            per_layer += self.n_heads * hd * d                           # out
        ff_mats = 3 if self.ffn_kind in ("swiglu", "geglu") else 2
        n_attnish = self.n_attn_layers
        n_ssm = L - n_attnish
        if self.family == "ssm":
            n_ssm, n_attnish = L, 0
            per_layer = 0
        total = emb + n_attnish * per_layer
        # ffn/moe per layer
        if self.n_experts:
            moe_layers = L // self.moe_every
            dense_layers = L - moe_layers
            ef = self.moe_d_ff or f
            total += moe_layers * (self.n_experts + self.shared_experts) \
                * ef * d * ff_mats
            total += moe_layers * d * self.n_experts  # router
            if self.dense_residual:
                total += moe_layers * f * d * ff_mats
            total += dense_layers * f * d * ff_mats
        else:
            total += L * f * d * ff_mats
        # ssm/rwkv mixers
        if self.family == "ssm":
            total += L * (d * d * 5 // 1)  # r,k,v,g,o projections approx
            total += L * d * f  # channel mix (2 mats, f=7168/2? keep approx)
        if self.family == "hybrid":
            din = d * self.mamba_expand
            total += n_ssm * (d * din * 2 + din * d + din * self.mamba_d_state * 2)
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training/serving run knobs consumed by the launcher."""
    arch: str = "qwen2-0.5b"
    shape: str = "train_4k"
    steps: int = 100
    microbatch: int = 0            # 0 -> no gradient accumulation
    lr: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0
    # paper technique
    qat: bool = False
    precision_policy: str = "fp32"   # fp32|fp4|posit8_0|mixed|adaptive
    target_avg_bits: float = 6.0
    # distributed tricks
    grad_compression: str = "none"   # none | posit8
    opt_state_dtype: str = "float32" # float32 | bfloat16 | posit8 (8-bit Adam)
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    quantize_kv: bool = False        # posit8 KV cache (serving)
