"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.

61L d_model=7168 128H (MLA) expert d_ff=2048 vocab=129280 [arXiv:2412.19437].
MLA dims per the released config: q_lora 1536, kv_lora 512, qk_nope 128,
qk_rope 64, v_head 128.  First 3 layers dense (d_ff=18432); sigmoid router.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    d_ff=18432,                 # dense prelude layers
    vocab_size=129280,
    num_heads=128,
    num_kv_heads=128,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=256,
    num_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=2048,
    first_dense_layers=3,
    router_score="sigmoid",
    block_pattern=("moe",),
    mtp=True,
)
