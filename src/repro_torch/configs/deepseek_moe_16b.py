"""deepseek-moe-16b [moe] — fine-grained experts, 2 shared + 64 routed top-6.

28L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=102400
[arXiv:2401.06066; hf].  First layer is dense (d_ff=10944) per the released
config.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    d_ff=10944,                 # dense prelude layer width
    vocab_size=102400,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    attn_type="gqa",
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    block_pattern=("moe",),
)
