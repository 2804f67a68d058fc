"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1536 ssm_state=128 vocab=50280 [arXiv:2405.21060].
headdim 64, expand 2 (d_inner 3072, 48 heads), conv width 4.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    d_ff=0,
    vocab_size=50280,
    attn_type="none",
    block_pattern=("ssm",),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    conv_width=4,
    tie_embeddings=True,
)
