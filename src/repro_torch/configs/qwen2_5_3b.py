"""qwen2.5-3b [dense] — GQA kv=2 with QKV bias.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936 [hf:Qwen/Qwen2.5-*].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    d_ff=11008,
    vocab_size=151936,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
)
