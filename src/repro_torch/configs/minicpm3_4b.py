"""minicpm3-4b [dense] — MLA attention, deep-narrow.

62L d_model=2560 40H d_ff=6400 vocab=73448 [hf:openbmb/MiniCPM3-4B].
MLA dims: q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32, v_head 64.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    d_ff=6400,
    vocab_size=73448,
    num_heads=40,
    num_kv_heads=40,
    attn_type="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
)
