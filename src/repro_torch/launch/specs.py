"""Meta-tensor stand-ins for the inputs and caches of every (arch x shape)
dry-run cell, and their partition specs over a ``MeshShape``: the JAX
package's launch/specs.py with meta tensors in place of
``jax.ShapeDtypeStruct``.  Nothing here allocates device memory."""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.layers import tree_map
from repro_torch.models.transformer import init_cache
from repro_torch.sharding.rules import MeshShape, batch_spec, data_axes


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def act_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def train_inputs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    d: dict[str, Any] = {"labels": _meta((b, s), torch.int32)}
    if cfg.input_mode == "tokens":
        d["tokens"] = _meta((b, s), torch.int32)
    else:
        d["embeds"] = _meta((b, s, cfg.d_model), act_dtype(cfg))
    if cfg.m_rope_sections:
        d["mrope_positions"] = _meta((3, b, s), torch.int32)
    return d


def train_input_shardings(mesh: MeshShape, cfg: ArchConfig,
                          shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len

    def sh(name, leaf):
        if name == "mrope_positions":
            inner = batch_spec(mesh, b, leaf.ndim - 1, seq_dim=1, seq_len=s)
            return (None,) + inner
        return batch_spec(mesh, b, leaf.ndim, seq_dim=1, seq_len=s)

    return {k: sh(k, v) for k, v in train_inputs(cfg, shape).items()}


def prefill_inputs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    d = train_inputs(cfg, shape)
    d.pop("labels")
    return d


def decode_inputs(cfg: ArchConfig, shape: ShapeConfig, dtype=None):
    """(the step's input, its position): tokens (B,) int32 or embeds
    (B, D) in dtype (default the config's), and an int32 scalar."""
    b = shape.global_batch
    if cfg.input_mode == "tokens":
        inp = _meta((b,), torch.int32)
    else:
        inp = _meta((b, cfg.d_model), dtype or act_dtype(cfg))
    return inp, _meta((), torch.int32)


def cache_abstract(cfg: ArchConfig, batch: int, cache_len: int,
                   dtype=None) -> list:
    """The port's caches (one dict per layer) as meta tensors, in dtype
    (default the config's)."""
    return init_cache(cfg, batch, cache_len, dtype or act_dtype(cfg),
                      device="meta")


def _cache_leaf_spec(mesh: MeshShape, leaf, batch: int) -> tuple:
    """The reference's cache sharding: the batch dim (index 0, or 1 under
    a stacked `layers` dim) over (pod, data); then the first long (>= 512)
    dim, the cache's sequence dim, over "model", so that each model shard
    scores its local keys; else the largest trailing dim that "model"
    divides."""
    dims = list(leaf.shape)
    parts: list = [None] * len(dims)
    dp = data_axes(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    bdim = 0 if dims and dims[0] == batch else (
        1 if len(dims) > 1 and dims[1] == batch else None)
    if bdim is not None and batch % dp_size == 0 and batch >= dp_size:
        parts[bdim] = dp if len(dp) > 1 else dp[0]
    msize = mesh.shape.get("model", 1)
    done = False
    for i in range(len(dims)):          # the sequence dim first
        if parts[i] is None and i != bdim and dims[i] >= 512 \
                and dims[i] % msize == 0:
            parts[i] = "model"
            done = True
            break
    if not done:                        # else the largest trailing dim
        for i in range(len(dims) - 1, -1, -1):
            if parts[i] is None and i != bdim and dims[i] % msize == 0 \
                    and dims[i] >= msize:
                parts[i] = "model"
                break
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def cache_shardings(mesh: MeshShape, cache_abs, batch: int):
    return tree_map(lambda l: _cache_leaf_spec(mesh, l, batch), cache_abs)


def logits_sharding(mesh: MeshShape, cfg: ArchConfig,
                    global_batch: int) -> tuple:
    vshard = "model" if cfg.vocab_size % mesh.shape.get("model", 1) == 0 \
        else None
    bs = batch_spec(mesh, global_batch, 1)
    return (bs[0] if len(bs) else None, vshard)
