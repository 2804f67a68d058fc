"""Architecture + run-shape configuration schema for the model zoo."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    attn_type: str = "gqa"         # gqa | mla | none
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    m_rope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) dims
    window: Optional[int] = None   # local-attention window
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0              # per-expert hidden (fine-grained)
    first_dense_layers: int = 0    # leading dense layers before MoE stack
    capacity_factor: float = 1.25
    # recurrent / ssm
    block_pattern: tuple[str, ...] = ("attn",)   # cycled over layers
    rnn_width: int = 0             # RG-LRU width
    conv_width: int = 4
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    # ffn
    mlp_act: str = "silu"          # silu | gelu
    mlp_gated: bool = True         # SwiGLU/GeGLU vs plain 2-layer MLP
    router_score: str = "softmax"  # softmax | sigmoid (deepseek-v3)
    # io / misc
    input_mode: str = "tokens"     # tokens | embeddings (stub frontend)
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    mtp: bool = False              # deepseek-v3 multi-token prediction head
    dtype: str = "bfloat16"
    # positions for stub-frontend models still index rope tables
    max_seq_len: int = 1 << 20

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Resolved per-layer block kinds, length num_layers."""
        kinds = []
        for i in range(self.num_layers):
            if self.num_experts and i < self.first_dense_layers:
                kinds.append("attn_dense")   # dense FFN prelude in MoE models
            else:
                kinds.append(self.block_pattern[i % len(self.block_pattern)])
        return tuple(kinds)

    @property
    def attn_q_dim(self) -> int:
        if self.attn_type == "mla":
            return self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.num_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    num_microbatches: int = 1      # grad-accum for train shapes


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence mixing; only these archs run it
# (see DESIGN.md §Arch-applicability for the skip rationale).
LONG_CONTEXT_ARCHS = ("recurrentgemma-2b", "mamba2-780m")


def cells_for(arch: "ArchConfig"):
    """The dry-run cells this architecture runs."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch.name in LONG_CONTEXT_ARCHS:
        names.append("long_500k")
    return [SHAPES[n] for n in names]
