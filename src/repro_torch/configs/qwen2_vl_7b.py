"""qwen2-vl-7b [vlm] — M-RoPE, dynamic-resolution ViT frontend (stubbed).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 [arXiv:2409.12191].
Backbone only per the assignment: input_specs() provides precomputed patch
embeddings and M-RoPE (t, h, w) position streams; mrope_section=(16, 24, 24)
as released.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    d_ff=18944,
    vocab_size=152064,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    qkv_bias=True,
    m_rope_sections=(16, 24, 24),
    rope_theta=1000000.0,
    input_mode="embeddings",
)
