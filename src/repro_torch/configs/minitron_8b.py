"""minitron-8b [dense] — width-pruned Nemotron-4.

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000 [arXiv:2407.14679].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=16384,
    vocab_size=256000,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
)
