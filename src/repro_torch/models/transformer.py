"""Model assembly: block definitions, forward (train / prefill),
single-token decode with caches, and the LM loss, for every family of the
JAX package: GQA or MLA transformers, dense or MoE, the recurrent
hybrids, and the stub front ends (qwen2-vl-7b's precomputed patch
embeddings with M-RoPE (t, h, w) position streams; musicgen-large's
precomputed frame embeddings with sinusoidal absolute positions).

The parameter tree is the JAX package's (``model_spec``): homogeneous runs
of the layer pattern are stacked under ``body`` with a leading (n_rep,)
dim, the remainder under ``prelude`` / ``tail``.  ``Transformer`` holds it
as an ``nn.Module`` whose blocks are an ``nn.ModuleList`` in execution
order (prelude, body repeats, tail), each block's parameters views of the
stacked tensors (no copy); the names (``ln1.gamma``, ``attn.w_q``, ...)
and the layouts (``x @ w``, w of shape (d_in, d_out)) are the JAX
package's.  ``Transformer.tree()`` gives the tree back in the JAX layout,
the stacked tensors those views share: the optimizer and the checkpoints
work on it, so an update of a stacked leaf is seen by every block.

Training keeps those per-block leaves: ``train.step`` takes the gradient
of each block's parameters and stacks them once per step into the JAX
layout (``Transformer.grad_tree``).  The other design, the stacked
tensors as the leaves and a slice per block in every forward, would give
each slice a backward that writes a full-size zero tensor per layer.

Caches are a list with one dict per layer, in the blocks' order (the JAX
package stacks the body's): {"k", "v"} for a GQA block (a ring of
``window`` slots for a windowed one), {"c_kv", "k_pe"} for MLA, {"h",
"conv"} for ``rec`` and {"h", "conv_x", "conv_bc"} for ``ssm``.

Block kinds: attn / attn_dense — (pre-norm attention) + (pre-norm dense
FFN); moe — (pre-norm attention) + (pre-norm MoE FFN, ``moe.apply_moe``),
after the dense prelude of ``first_dense_layers``; rec — (pre-norm RG-LRU
recurrent block, ``rglru``) + (pre-norm FFN); ssm — pre-norm Mamba-2 mixer
(``ssm``), no separate FFN.  Attention is GQA or MLA (``attn_type``).
deepseek-v3's MTP head is held as ``Transformer.mtp``; only ``lm_loss``
reads it, as in the reference.
"""
from __future__ import annotations

from typing import Any

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru, ssm
from repro_torch.models.layers import (ParamSpec, apply_ffn, apply_norm,
                                       chunked_xent, ffn_spec, is_spec,
                                       norm_spec, stack_specs, tree_map)
from repro_torch.utils.device import resolve_device

ATTN_KINDS = ("attn", "attn_dense", "moe")
KINDS = ATTN_KINDS + ("rec", "ssm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for a block kind outside ``KINDS``."""
    kinds = sorted(set(cfg.layer_kinds) - set(KINDS))
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: block kind(s) {', '.join(map(repr, kinds))} not "
            f"in the port (it has {', '.join(KINDS)})")


# ---------------------------------------------------------------------------
# block spec / apply
# ---------------------------------------------------------------------------

def _attn_spec(cfg):
    return attn.mla_spec(cfg) if cfg.attn_type == "mla" else attn.gqa_spec(cfg)


def block_spec(cfg: ArchConfig, kind: str):
    d = cfg.d_model
    if kind in ATTN_KINDS:
        s = {"ln1": norm_spec(cfg, d), "attn": _attn_spec(cfg),
             "ln2": norm_spec(cfg, d)}
        if kind == "moe":
            s["moe"] = moe_mod.moe_spec(cfg)
        else:
            s["ffn"] = ffn_spec(cfg, d, cfg.d_ff)
        return s
    if kind == "rec":
        return {"ln1": norm_spec(cfg, d), "rec": rglru.rglru_spec(cfg),
                "ln2": norm_spec(cfg, d),
                "ffn": ffn_spec(cfg, d, cfg.d_ff)}
    if kind == "ssm":
        return {"ln1": norm_spec(cfg, d), "ssm": ssm.ssm_spec(cfg)}
    raise ValueError(f"unknown block kind {kind!r}")


def _attn_window(cfg, kind):
    # local-attention window applies to the attention blocks of hybrid archs
    return cfg.window if kind == "attn" and cfg.window else None


def _apply_attn(cfg, kind, p, h_in, pos, mode, cache, cache_len):
    prefill = mode == "prefill"
    if cfg.attn_type == "mla":
        if mode == "decode":
            return attn.mla_decode(cfg, p, h_in, cache, pos)
        return attn.mla_forward(cfg, p, h_in, pos, make_cache=prefill,
                                cache_len=cache_len)
    window = _attn_window(cfg, kind)
    if mode == "decode":
        return attn.gqa_decode(cfg, p, h_in, cache, pos, window=window)
    return attn.gqa_forward(cfg, p, h_in, pos, window=window,
                            make_cache=prefill, cache_len=cache_len)


def apply_block(cfg, kind, p, x, pos, *, mode: str, cache=None,
                cache_len: int = 0):
    """mode: train | prefill | decode.  Returns (x, new_cache)."""
    h_in = apply_norm(cfg, p["ln1"], x)
    prefill = mode == "prefill"
    if kind == "ssm":
        if mode == "decode":
            h, new_cache = ssm.ssm_decode(cfg, p["ssm"], h_in, cache)
        else:
            h, new_cache = ssm.ssm_forward(cfg, p["ssm"], h_in,
                                           make_cache=prefill)
        return x + h, new_cache
    if kind == "rec":
        if mode == "decode":
            h, new_cache = rglru.rglru_decode(cfg, p["rec"], h_in, cache)
        else:
            h, new_cache = rglru.rglru_forward(cfg, p["rec"], h_in,
                                               make_cache=prefill)
    else:
        h, new_cache = _apply_attn(cfg, kind, p["attn"], h_in, pos, mode,
                                   cache, cache_len)
    x = x + h
    h2 = apply_norm(cfg, p["ln2"], x)
    if kind == "moe":
        x = x + moe_mod.apply_moe(cfg, p["moe"], h2)
    else:
        x = x + apply_ffn(cfg, p["ffn"], h2)
    return x, new_cache


def init_block_cache(cfg, kind, batch: int, cache_len: int, dtype,
                     device="cuda"):
    """One layer's cache, zeros on ``device`` (default the card; a missing
    card raises)."""
    device = resolve_device(device)
    if kind == "rec":
        return rglru.rglru_init_cache(cfg, batch, dtype, device)
    if kind == "ssm":
        return ssm.ssm_init_cache(cfg, batch, dtype, device)
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    if cfg.attn_type == "mla":
        return {"c_kv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                                    dtype=dtype, device=device),
                "k_pe": torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                                    dtype=dtype, device=device)}
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
    if cfg.mtp:
        spec["mtp"] = {
            "proj": ParamSpec((2 * d, d), ("embed", "embed2")),
            "norm_h": norm_spec(cfg, d),
            "norm_e": norm_spec(cfg, d),
            "block": block_spec(cfg, cfg.block_pattern[-1]),
            "final_norm": norm_spec(cfg, d),
        }
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

    def __init__(self, tree: dict, requires_grad: bool = False):
        super().__init__()
        for name, t in tree.items():
            if isinstance(t, dict):
                self.add_module(name, ParamTree(t, requires_grad))
            else:
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=requires_grad))

    def __getitem__(self, name):
        return getattr(self, name)


def _tree_of(module: ParamTree, spec):
    """module's parameters in spec's (nested dict) structure."""
    return {k: (module[k] if is_spec(v) else _tree_of(module[k], v))
            for k, v in spec.items()}


class Transformer(nn.Module):
    """An LM holding a ``model_spec`` parameter tree.

    params: the tree of tensors in the spec's structure (``match_tree``),
    ``body`` stacked.  Each block's parameters are views of the stacked
    tensors (no copy) unless dtype or device asks for a conversion.  The
    MTP head, where the config has one, is ``self.mtp``.  trainable=True
    makes every parameter require grad (default: serving, no autograd).
    """

    def __init__(self, cfg: ArchConfig, params, *, dtype=None, device=None,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.spec = model_spec(cfg)
        prelude, unit, n_rep, tail = plan_segments(cfg)
        tree = tree_map(lambda t: t.to(device=device, dtype=dtype),
                        match_tree(self.spec, params))
        self.kinds = layer_kinds(cfg)
        self.segments = (len(prelude), len(unit), n_rep, len(tail))
        self.embed = nn.Parameter(tree["embed"], requires_grad=trainable)
        self.register_parameter("unembed", None if cfg.tie_embeddings else
                                nn.Parameter(tree["unembed"],
                                             requires_grad=trainable))
        self.final_norm = ParamTree(tree["final_norm"], trainable)
        blocks = [ParamTree(p, trainable) for p in tree.get("prelude", [])]
        for r in range(n_rep):
            blocks += [ParamTree(tree_map(lambda t: t[r],
                                          tree["body"][f"b{i}"]), trainable)
                       for i in range(len(unit))]
        blocks += [ParamTree(p, trainable) for p in tree.get("tail", [])]
        self.blocks = nn.ModuleList(blocks)
        self.mtp = (ParamTree(tree["mtp"], trainable) if "mtp" in tree
                    else None)
        # the stacked tensors the body's blocks view (not parameters
        # themselves: each block's slices are)
        self._body = tree.get("body")

    def _body_blocks(self, i: int):
        """The blocks holding unit slot i of the stacked body, by repeat."""
        n_pre, n_unit, n_rep, _ = self.segments
        return [self.blocks[n_pre + r * n_unit + i] for r in range(n_rep)]

    def tree(self, fn=None):
        """The parameters in the JAX layout (``model_spec``'s structure):
        with fn None the tensors themselves, a body leaf the stacked tensor
        its blocks view (raises if a block no longer views it, e.g. after
        ``.to()`` moved the blocks apart); else fn(parameter) per leaf, a
        body leaf ``torch.stack`` of fn over its blocks' slices."""
        spec = self.spec
        n_pre, n_unit, n_rep, n_tail = self.segments
        one = (lambda t: t) if fn is None else fn
        out = {"embed": one(self.embed),
               "final_norm": tree_map(one, _tree_of(self.final_norm,
                                                    spec["final_norm"]))}
        if self.unembed is not None:
            out["unembed"] = one(self.unembed)
        if n_pre:
            out["prelude"] = [tree_map(one, _tree_of(self.blocks[i], s))
                              for i, s in enumerate(spec["prelude"])]
        if n_rep:
            out["body"] = {}
            for i in range(n_unit):
                key = f"b{i}"
                views = [_tree_of(b, spec["body"][key])
                         for b in self._body_blocks(i)]
                if fn is None:
                    out["body"][key] = self._stacked(
                        self._body[key], views, key)
                else:
                    out["body"][key] = _stack_leaves(
                        spec["body"][key], [tree_map(fn, v) for v in views])
        if n_tail:
            start = len(self.blocks) - n_tail
            out["tail"] = [tree_map(one, _tree_of(self.blocks[start + i], s))
                           for i, s in enumerate(spec["tail"])]
        if self.mtp is not None:
            out["mtp"] = tree_map(one, _tree_of(self.mtp, spec["mtp"]))
        return out

    @staticmethod
    def _stacked(stacked, views, where):
        """stacked (a dict of stacked tensors), checked to be what each
        repeat's views slice."""
        if isinstance(stacked, dict):
            return {k: Transformer._stacked(stacked[k], [v[k] for v in views],
                                            f"{where}.{k}")
                    for k in sorted(stacked)}
        for r, v in enumerate(views):
            if (v.data_ptr() != stacked[r].data_ptr()
                    or v.shape != stacked.shape[1:]):
                raise RuntimeError(f"body.{where}: block {r}'s parameter no "
                                   f"longer views the stacked tensor")
        return stacked

    def grad_tree(self, grads: dict):
        """grads ({id(parameter): gradient}) in the JAX layout: a body
        leaf's per-block gradients stacked (one copy per step).  grads is
        consumed: each gradient leaves the dict as it is placed, so where
        the dict held the only references, a leaf's per-block and stacked
        copies coexist one leaf at a time."""
        return self.tree(lambda p: grads.pop(id(p)))


def _stack_leaves(spec, per_rep: list):
    if is_spec(spec):
        return torch.stack(per_rep)
    return {k: _stack_leaves(spec[k], [t[k] for t in per_rep])
            for k in sorted(spec)}


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

def _sinusoidal(pos, d: int):
    """Sinusoidal absolute positions (musicgen): (..., d) float32 for
    integer positions pos (...)."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=pos.device) / half)
    ang = pos[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_inputs(cfg, model: Transformer, batch):
    """tokens (B, S), or embeds (B, S, D) for the stub front ends ->
    hidden (B, S, D) in the weights' dtype; the audio family adds its
    sinusoidal positions."""
    check_model(cfg, model)
    if cfg.input_mode == "tokens":
        x = model.embed[batch["tokens"]]
    else:
        x = batch["embeds"].to(model.embed.dtype)
    if cfg.family == "audio":
        s = x.shape[1]
        x = x + _sinusoidal(torch.arange(s, device=x.device),
                            cfg.d_model).to(x.dtype)
    return x


def _positions(cfg, batch, b, s, device):
    """(B, S) positions, or the (3, B, S) M-RoPE streams: the batch's
    ``mrope_positions`` where given, else arange(S) in all three."""
    if cfg.m_rope_sections:
        if "mrope_positions" in batch:
            return batch["mrope_positions"]
        return torch.arange(s, device=device).expand(3, b, s)
    return torch.arange(s, device=device).expand(b, s)


def unembed(cfg, model: Transformer, x):
    check_model(cfg, model)
    if cfg.tie_embeddings:
        return x @ model.embed.T
    return x @ model.unembed


def forward(cfg: ArchConfig, model: Transformer, batch, *,
            mode: str = "train", cache_len: int = 0, remat: bool = False,
            return_logits: bool = True):
    """Returns (logits, caches, aux); caches is None unless mode is
    "prefill" (then one per layer, in ``init_cache``'s layout: cache_len
    slots for an attention cache, the state after the last position for a
    recurrent one).
    batch: {"tokens": (B, S)} or, for the stub front ends, {"embeds":
    (B, S, D)}, with M-RoPE optionally {"mrope_positions": (3, B, S)}.
    remat=True (train mode) recomputes each unit of the stacked body in
    backward (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` over its scanned unit.
    aux: {"hidden": the last block's output, "normed": after the final
    norm}."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode {mode!r}: forward takes train or prefill")
    x = embed_inputs(cfg, model, batch)
    b, s, _ = x.shape
    pos = _positions(cfg, batch, b, s, x.device)
    n_pre, n_unit, n_rep, _ = model.segments
    remat = remat and mode == "train"
    caches = []

    def run(x, lo, hi):
        cs = []
        for kind, p in zip(model.kinds[lo:hi], model.blocks[lo:hi],
                           strict=True):
            x, c = apply_block(cfg, kind, p, x, pos, mode=mode,
                               cache_len=cache_len)
            cs.append(c)
        return x, cs

    i = 0
    while i < len(model.blocks):
        in_body = n_pre <= i < n_pre + n_rep * n_unit
        hi = i + n_unit if in_body else i + 1
        if remat and in_body:
            x = checkpoint(lambda x, lo=i, hi=hi: run(x, lo, hi)[0], x,
                           use_reentrant=False)
        else:
            x, cs = run(x, i, hi)
            caches += cs
        i = hi
    h_final = x
    x = apply_norm(cfg, model.final_norm, x)
    logits = unembed(cfg, model, x) if return_logits else None
    aux = {"hidden": h_final, "normed": x}
    return logits, (caches if mode == "prefill" else None), aux


def decode_step(cfg: ArchConfig, model: Transformer, inputs, caches,
                pos: int):
    """One decode step.  inputs: tokens (B,), or embeds (B, D) for the
    stub front ends; pos: the position written (a Python int; M-RoPE
    rotates all three streams by it).  Returns (logits (B, V), caches):
    the attention caches updated in place, each recurrent layer's state a
    new dict."""
    check_model(cfg, model)
    if cfg.input_mode == "tokens":
        x = model.embed[inputs][:, None, :]          # (B, 1, D)
    else:
        x = inputs[:, None, :].to(model.embed.dtype)
    if cfg.family == "audio":
        x = x + _sinusoidal(torch.tensor([pos], device=x.device),
                            cfg.d_model).to(x.dtype)
    new_caches = []
    for kind, p, c in zip(model.kinds, model.blocks, caches, strict=True):
        x, c = apply_block(cfg, kind, p, x, pos, mode="decode", cache=c)
        new_caches.append(c)
    x = apply_norm(cfg, model.final_norm, x)
    logits = unembed(cfg, model, x)[:, 0, :]
    return logits, new_caches


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
               device="cuda"):
    """One cache per layer, in the blocks' order (module docstring), on
    ``device`` (default the card; a missing card raises)."""
    kinds = layer_kinds(cfg)
    device = resolve_device(device)
    return [init_block_cache(cfg, k, batch, cache_len, dtype, device)
            for k in kinds]


# ---------------------------------------------------------------------------
# losses (incl. deepseek-v3 MTP)
# ---------------------------------------------------------------------------

def lm_loss(cfg: ArchConfig, model: Transformer, batch, *,
            remat: bool = False, mtp_weight: float = 0.3,
            loss_chunk: int = 1024):
    """Next-token cross entropy (+ the MTP auxiliary for deepseek-v3),
    through ``chunked_xent``: the (B, S, V) logits never exist whole.
    batch: forward's, plus "labels" (B, S); the targets are the labels
    shifted by one, the last position padded with -1 (ignored)."""
    _, _, aux = forward(cfg, model, batch, mode="train", remat=remat,
                        return_logits=False)
    labels = batch["labels"]
    unemb = functools.partial(unembed, cfg, model)
    pad = torch.full_like(labels[:, :1], -1)
    next_labels = torch.cat([labels[:, 1:], pad], dim=1)
    loss = chunked_xent(aux["normed"], next_labels, unemb, chunk=loss_chunk)
    if cfg.mtp and model.mtp is not None:
        p = model.mtp
        h = aux["hidden"]                            # (B, S, D)
        if cfg.input_mode == "tokens":
            nxt = model.embed[batch["tokens"]]
        else:
            nxt = batch["embeds"].to(h.dtype)
        # h_t with the embedding of token t+1 predicts token t+2; the
        # shifts pad so that S stays chunk-divisible
        hh = apply_norm(cfg, p["norm_h"], h)
        ee_next = torch.cat([nxt[:, 1:], torch.zeros_like(nxt[:, :1])],
                            dim=1)
        ee = apply_norm(cfg, p["norm_e"], ee_next)
        z = torch.cat([hh, ee], dim=-1) @ p["proj"]
        b, s2, _ = z.shape
        pos = torch.arange(s2, device=z.device).expand(b, s2)
        if cfg.m_rope_sections:
            pos = pos.expand(3, b, s2)
        z, _ = apply_block(cfg, cfg.block_pattern[-1], p["block"], z, pos,
                           mode="train")
        z = apply_norm(cfg, p["final_norm"], z)
        mtp_labels = torch.cat([labels[:, 2:], pad, pad], dim=1)
        mtp_loss = chunked_xent(z, mtp_labels, unemb, chunk=loss_chunk)
        loss = loss + mtp_weight * mtp_loss
    return loss
