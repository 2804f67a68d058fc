"""musicgen-large [audio] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (MHA) d_ff=8192 vocab=2048 [arXiv:2306.05284].
Backbone only per the assignment: the EnCodec frontend is a stub —
input_specs() provides precomputed frame embeddings.  Pre-LN transformer
with LayerNorm, GELU MLP (non-gated), sinusoidal positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    d_ff=8192,
    vocab_size=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    input_mode="embeddings",
    norm_type="layernorm",
    mlp_act="gelu",
    mlp_gated=False,
)
