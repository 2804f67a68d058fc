"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2:1 pattern.

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000 [arXiv:2402.19427; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    d_ff=7680,
    vocab_size=256000,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    attn_type="gqa",
    window=2048,
    block_pattern=("rec", "rec", "attn"),
    rnn_width=2560,
    conv_width=4,
    mlp_act="gelu",
    tie_embeddings=True,
)
