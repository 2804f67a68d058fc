"""Model assembly: block definitions, forward (train / prefill) and
single-token decode with KV caches, for GQA transformers, dense or MoE.

The parameter tree is the JAX package's (``model_spec``): homogeneous runs
of the layer pattern are stacked under ``body`` with a leading (n_rep,)
dim, the remainder under ``prelude`` / ``tail``.  ``Transformer`` holds it
as an ``nn.Module`` whose blocks are an ``nn.ModuleList`` in execution
order (prelude, body repeats, tail), the stacked tensors taken apart into
one block each; the names (``ln1.gamma``, ``attn.w_q``, ...) and the
layouts (``x @ w``, w of shape (d_in, d_out)) are the JAX package's.

Caches are a list with one {"k", "v"} dict per layer, in the blocks'
order (the JAX package stacks the body's).

Block kinds: attn / attn_dense — (pre-norm attention) + (pre-norm dense
FFN); moe — (pre-norm attention) + (pre-norm MoE FFN, ``moe.apply_moe``),
after the dense prelude of ``first_dense_layers``.  The stacked body's
expert weights, (n_rep, E, d_in, d_out), are taken apart into per-block
views like every other stacked leaf.  Everything else raises
``NotImplementedError`` (ROADMAP.md item 11c): RG-LRU and SSM blocks, MLA,
M-RoPE, embedding inputs, the audio family's positions and the MTP head.
Training and its losses are item 11b.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (ParamSpec, apply_ffn, apply_norm,
                                       ffn_spec, is_spec, norm_spec,
                                       stack_specs, tree_map)
from repro_torch.utils.device import resolve_device

ATTN_KINDS = ("attn", "attn_dense", "moe")


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for any feature outside this slice."""
    unsupported = []
    if cfg.family == "audio":
        unsupported.append("family 'audio'")
    if cfg.input_mode != "tokens":
        unsupported.append(f"input_mode {cfg.input_mode!r}")
    if cfg.attn_type != "gqa":
        unsupported.append(f"attn_type {cfg.attn_type!r}")
    if cfg.m_rope_sections:
        unsupported.append("m_rope_sections")
    if cfg.mtp:
        unsupported.append("mtp")
    kinds = sorted(set(cfg.layer_kinds) - set(ATTN_KINDS))
    unsupported += [f"block kind {k!r}" for k in kinds]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unsupported)} not ported yet: the port "
            f"runs GQA transformers, dense or MoE (ROADMAP.md item 11c)")


# ---------------------------------------------------------------------------
# block spec / apply
# ---------------------------------------------------------------------------

def block_spec(cfg: ArchConfig, kind: str):
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  f"(ROADMAP.md item 11c)")
    d = cfg.d_model
    s = {"ln1": norm_spec(cfg, d), "attn": attn.gqa_spec(cfg),
         "ln2": norm_spec(cfg, d)}
    if kind == "moe":
        s["moe"] = moe_mod.moe_spec(cfg)
    else:
        s["ffn"] = ffn_spec(cfg, d, cfg.d_ff)
    return s


def _attn_window(cfg, kind):
    # local-attention window applies to the attention blocks of hybrid archs
    return cfg.window if kind == "attn" and cfg.window else None


def apply_block(cfg, kind, p, x, pos, *, mode: str, cache=None,
                cache_len: int = 0):
    """mode: train | prefill | decode.  Returns (x, new_cache)."""
    window = _attn_window(cfg, kind)
    h_in = apply_norm(cfg, p["ln1"], x)
    if mode == "decode":
        h, new_cache = attn.gqa_decode(cfg, p["attn"], h_in, cache, pos,
                                       window=window)
    else:
        h, new_cache = attn.gqa_forward(
            cfg, p["attn"], h_in, pos, window=window,
            make_cache=(mode == "prefill"), cache_len=cache_len)
    x = x + h
    h2 = apply_norm(cfg, p["ln2"], x)
    if kind == "moe":
        x = x + moe_mod.apply_moe(cfg, p["moe"], h2)
    else:
        x = x + apply_ffn(cfg, p["ffn"], h2)
    return x, new_cache


def init_block_cache(cfg, kind, batch: int, cache_len: int, dtype,
                     device="cuda"):
    """One layer's {"k", "v"} cache, zeros on ``device`` (default the
    card; a missing card raises)."""
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  f"(ROADMAP.md item 11c)")
    device = resolve_device(device)
    window = _attn_window(cfg, kind)
    alloc = min(window, cache_len) if window else cache_len
    shape = (batch, alloc, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# layer segmentation and the parameter tree
# ---------------------------------------------------------------------------

def plan_segments(cfg: ArchConfig):
    """(prelude kinds, unit kinds, n_rep, tail kinds), as the JAX package
    segments the layers for its scan."""
    check_supported(cfg)
    kinds = list(cfg.layer_kinds)
    n_pre = cfg.first_dense_layers if cfg.num_experts else 0
    prelude = kinds[:n_pre]
    rest = kinds[n_pre:]
    unit = list(cfg.block_pattern)
    n_rep = len(rest) // len(unit)
    if rest[:n_rep * len(unit)] != unit * n_rep:
        return prelude + rest, [], 0, []
    tail = rest[n_rep * len(unit):]
    return prelude, unit, n_rep, tail


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """Block kinds in execution order."""
    prelude, unit, n_rep, tail = plan_segments(cfg)
    return prelude + unit * n_rep + tail


def model_spec(cfg: ArchConfig):
    d, v = cfg.d_model, cfg.vocab_size
    prelude, unit, n_rep, tail = plan_segments(cfg)
    spec: dict[str, Any] = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), scale=0.02),
        "final_norm": norm_spec(cfg, d),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = ParamSpec((d, v), ("embed", "vocab"))
    if prelude:
        spec["prelude"] = [block_spec(cfg, k) for k in prelude]
    if n_rep:
        unit_spec = {f"b{i}": block_spec(cfg, k) for i, k in enumerate(unit)}
        spec["body"] = stack_specs(unit_spec, n_rep)
    if tail:
        spec["tail"] = [block_spec(cfg, k) for k in tail]
    return spec


def match_tree(spec, tree, where: str = "params"):
    """tree's tensors in spec's structure.  Raises unless every dict has
    exactly the spec's keys, every list its length and every leaf is a
    tensor of its spec's shape, so that each leaf is used exactly once."""
    if is_spec(spec):
        if not torch.is_tensor(tree):
            raise TypeError(f"{where}: {type(tree).__name__}, not a tensor")
        if tuple(tree.shape) != spec.shape:
            raise ValueError(f"{where}: shape {tuple(tree.shape)}, spec "
                             f"{spec.shape}")
        return tree
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{where}: keys {got}, spec {sorted(spec)}")
        return {k: match_tree(s, tree[k], f"{where}.{k}")
                for k, s in spec.items()}
    if not isinstance(tree, (list, tuple)) or len(tree) != len(spec):
        raise ValueError(f"{where}: not a list of {len(spec)}")
    return [match_tree(s, t, f"{where}[{i}]")
            for i, (s, t) in enumerate(zip(spec, tree))]


class ParamTree(nn.Module):
    """An nn.Module holding a dict of tensors as parameters and
    submodules under the same names; ``p["w_q"]`` reads one, as on the
    JAX package's tree."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, t in tree.items():
            if isinstance(t, dict):
                self.add_module(name, ParamTree(t))
            else:
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name):
        return getattr(self, name)


class Transformer(nn.Module):
    """A GQA LM, dense or MoE, holding a ``model_spec`` parameter tree.

    params: the tree of tensors in the spec's structure (``match_tree``),
    ``body`` stacked.  Each block's parameters are views of the stacked
    tensors (no copy) unless dtype or device asks for a conversion.
    """

    def __init__(self, cfg: ArchConfig, params, *, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        prelude, unit, n_rep, tail = plan_segments(cfg)
        tree = tree_map(lambda t: t.to(device=device, dtype=dtype),
                        match_tree(model_spec(cfg), params))
        self.kinds = layer_kinds(cfg)
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.register_parameter("unembed", None if cfg.tie_embeddings else
                                nn.Parameter(tree["unembed"],
                                             requires_grad=False))
        self.final_norm = ParamTree(tree["final_norm"])
        blocks = [ParamTree(p) for p in tree.get("prelude", [])]
        for r in range(n_rep):
            blocks += [ParamTree(tree_map(lambda t: t[r],
                                          tree["body"][f"b{i}"]))
                       for i in range(len(unit))]
        blocks += [ParamTree(p) for p in tree.get("tail", [])]
        self.blocks = nn.ModuleList(blocks)


def check_model(cfg: ArchConfig, model: Transformer) -> None:
    """The functions below take cfg beside the model, as the JAX package's
    take it beside the params; it must be the config the model was built
    from."""
    if cfg != model.cfg:
        raise ValueError(f"config {cfg.name!r} does not match the model's "
                         f"({model.cfg.name!r}, {model.cfg.num_layers} "
                         f"layers)")


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------

def embed_inputs(cfg, model: Transformer, batch):
    """tokens (B, S) -> hidden (B, S, D)."""
    check_model(cfg, model)
    return model.embed[batch["tokens"]]


def _positions(cfg, batch, b, s, device):
    return torch.arange(s, device=device).expand(b, s)


def unembed(cfg, model: Transformer, x):
    check_model(cfg, model)
    if cfg.tie_embeddings:
        return x @ model.embed.T
    return x @ model.unembed


def forward(cfg: ArchConfig, model: Transformer, batch, *,
            mode: str = "train", cache_len: int = 0,
            return_logits: bool = True):
    """Returns (logits, caches, aux); caches is None unless mode is
    "prefill" (then one {"k", "v"} per layer, cache_len slots each).
    aux: {"hidden": the last block's output, "normed": after the final
    norm}."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode {mode!r}: forward takes train or prefill")
    x = embed_inputs(cfg, model, batch)
    b, s, _ = x.shape
    pos = _positions(cfg, batch, b, s, x.device)
    caches = []
    for kind, p in zip(model.kinds, model.blocks, strict=True):
        x, c = apply_block(cfg, kind, p, x, pos, mode=mode,
                           cache_len=cache_len)
        caches.append(c)
    h_final = x
    x = apply_norm(cfg, model.final_norm, x)
    logits = unembed(cfg, model, x) if return_logits else None
    aux = {"hidden": h_final, "normed": x}
    return logits, (caches if mode == "prefill" else None), aux


def decode_step(cfg: ArchConfig, model: Transformer, inputs, caches,
                pos: int):
    """One decode step.  inputs: tokens (B,); pos: the position written
    (a Python int).  Returns (logits (B, V), caches), the caches updated
    in place."""
    check_model(cfg, model)
    x = model.embed[inputs][:, None, :]              # (B, 1, D)
    new_caches = []
    for kind, p, c in zip(model.kinds, model.blocks, caches, strict=True):
        x, c = apply_block(cfg, kind, p, x, pos, mode="decode", cache=c)
        new_caches.append(c)
    x = apply_norm(cfg, model.final_norm, x)
    logits = unembed(cfg, model, x)[:, 0, :]
    return logits, new_caches


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
               device="cuda"):
    """One {"k", "v"} cache per layer, in the blocks' order, on ``device``
    (default the card; a missing card raises)."""
    kinds = layer_kinds(cfg)
    device = resolve_device(device)
    return [init_block_cache(cfg, k, batch, cache_len, dtype, device)
            for k in kinds]
