"""qwen3-1.7b [dense] — GQA with per-head qk-norm.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936 [hf:Qwen/Qwen3-*].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    d_ff=6144,
    vocab_size=151936,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
)
