"""Architecture registry + reduced smoke-test variants."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, cells_for
from repro_torch.configs import (recurrentgemma_2b, deepseek_moe_16b,
                           deepseek_v3_671b, minicpm3_4b, qwen3_1_7b,
                           minitron_8b, qwen2_5_3b, musicgen_large,
                           qwen2_vl_7b, mamba2_780m)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (recurrentgemma_2b, deepseek_moe_16b, deepseek_v3_671b,
              minicpm3_4b, qwen3_1_7b, minitron_8b, qwen2_5_3b,
              musicgen_large, qwen2_vl_7b, mamba2_780m)
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Family-preserving small variant for CPU smoke tests: same block
    pattern / attention type / routing structure, tiny widths."""
    kw: dict = dict(
        d_model=128,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
    )
    n_pre = 1 if cfg.first_dense_layers else 0
    has_tail = (cfg.num_layers - (cfg.first_dense_layers if cfg.num_experts else 0)) \
        % len(cfg.block_pattern) != 0
    kw["first_dense_layers"] = n_pre
    kw["num_layers"] = n_pre + 2 * len(cfg.block_pattern) + (1 if has_tail else 0)
    if cfg.num_heads:
        heads = 4
        kw["num_heads"] = heads
        kw["num_kv_heads"] = max(1, (cfg.num_kv_heads * heads) // cfg.num_heads)
        kw["head_dim"] = 32
    if cfg.attn_type == "mla":
        kw.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=16,
                  qk_rope_dim=8, v_head_dim=16)
    if cfg.num_experts:
        kw.update(num_experts=8,
                  experts_per_token=min(cfg.experts_per_token, 2),
                  num_shared_experts=min(cfg.num_shared_experts, 1),
                  moe_d_ff=64,
                  # drop-free at smoke scale so decode/forward parity is exact
                  capacity_factor=8.0)
    if cfg.rnn_width:
        kw["rnn_width"] = 128
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=16)
    if cfg.window:
        kw["window"] = 16
    if cfg.m_rope_sections:
        kw["m_rope_sections"] = (4, 6, 6)   # half of head_dim 32
    return dataclasses.replace(cfg, **kw)


REDUCED = {name: reduced(cfg) for name, cfg in ARCHS.items()}
