"""Mixture-of-Experts FFN with sort-based token dispatch, in PyTorch.

The JAX package's semantics, step for step:

- the router runs in float32; ``router_probs`` is a softmax (or a sigmoid,
  deepseek-v3's); each token keeps its k most probable experts, the lower
  expert id first on ties (``lax.top_k``'s order, made explicit here by a
  stable descending sort, since ``torch.topk`` promises no tie order), and
  their gates are renormalised with a 1e-9 floor;
- each batch row is its own dispatch group with a static capacity
  ``cap = max(1, ceil(capacity_factor * S * k / E))``: the row's (token,
  expert) assignments are sorted stably by expert id, an assignment's
  rank within its expert is its position less the expert's first position
  (``searchsorted``), and an assignment ranked ``cap`` or later is dropped
  (first come in sorted order keeps its slot);
- the expert products run over the whole (E, B, cap, D) buffer in x's
  dtype (a decode step computes every expert for every token, as the
  reference does), a dropped assignment reads 0, each gate is cast to x's
  dtype; the shared experts are added after the routed ones.

One deviation in the order of additions: the reference scatter-adds a
token's k contributions in x's dtype; an unfixed order of atomic adds on
the card would make bf16 results vary from run to run, so here each
token's k contributions are summed over k in a fixed order.

``layers.moe_sharding`` / ``constrain_moe`` of the JAX package are GSPMD
layout hints for an expert-parallel mesh; they have no single-device
counterpart and are not ported.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import ParamSpec, _act, apply_ffn, ffn_spec


def moe_spec(cfg):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    s = {
        "router": ParamSpec((d, e), ("embed", "null"), scale=0.02),
        "w_gate": ParamSpec((e, d, f), ("experts", "expert_embed", "ffn")),
        "w_up": ParamSpec((e, d, f), ("experts", "expert_embed", "ffn")),
        "w_down": ParamSpec((e, f, d), ("experts", "ffn", "expert_embed")),
    }
    if cfg.num_shared_experts:
        s["shared"] = ffn_spec(cfg, d, cfg.num_shared_experts * cfg.moe_d_ff)
    return s


def router_probs(cfg, logits):
    if cfg.router_score == "sigmoid":       # deepseek-v3
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def top_k(probs, k: int):
    """(values, ids) of the k largest entries of the last dim, in
    descending order, the lower id first among equal values."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def capacity(cfg, s: int) -> int:
    """Slots per expert in one batch row of s tokens."""
    return max(1, math.ceil(cfg.capacity_factor * s * cfg.experts_per_token
                            / cfg.num_experts))


def _dispatch(cfg, ids):
    """ids (B, S, k) expert choices -> (sort_idx, tok, slot, valid), each
    (B, S*k) in the row's order sorted by expert id: the flat assignment
    each entry came from, its token, its slot in the row's (E * cap)
    buffer (E * cap, out of bounds, where dropped) and whether it kept a
    slot."""
    b, s, k = ids.shape
    e, cap = cfg.num_experts, capacity(cfg, s)
    flat_ids = ids.reshape(b, s * k)
    sort_idx = torch.argsort(flat_ids, dim=1, stable=True)
    tok = sort_idx // k
    eid = torch.gather(flat_ids, 1, sort_idx)
    first = torch.searchsorted(eid, eid, side="left")
    rank = torch.arange(s * k, device=ids.device)[None, :] - first
    valid = rank < cap
    slot = torch.where(valid, eid * cap + rank, e * cap)
    return sort_idx, tok, slot, valid


def apply_moe(cfg, p, x):
    """x: (B, S, D) -> (B, S, D).  Routed experts + shared experts."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = capacity(cfg, s)

    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    gate, ids = top_k(router_probs(cfg, logits), k)     # (B, S, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    sort_idx, _, slot, valid = _dispatch(cfg, ids)
    # each assignment's slot and validity back in (token, choice) order
    slot = torch.empty_like(slot).scatter_(1, sort_idx, slot)
    valid = torch.empty_like(valid).scatter_(1, sort_idx, valid)
    # the row's slot -> a row of one (E, B, cap) buffer, expert-major so
    # that each expert's rows are one matrix; dropped -> one spare row
    rows = torch.where(
        valid, ((slot // cap) * b + torch.arange(b, device=x.device)[:, None])
        * cap + slot % cap, e * b * cap)

    buf = x.new_zeros(e * b * cap + 1, d)
    buf[rows.reshape(-1)] = x.repeat_interleave(k, dim=1).reshape(-1, d)
    h_in = buf[:-1].view(e, b * cap, d)
    h = _act(cfg, torch.bmm(h_in, p["w_gate"])) * torch.bmm(h_in, p["w_up"])
    out = torch.bmm(h, p["w_down"]).view(e * b * cap, d)

    # dropped assignments read 0 (the reference's fill), so their gates
    # add nothing
    got = out[rows.clamp(max=e * b * cap - 1)]                 # (B, S*k, D)
    got = torch.where(valid[..., None], got, 0)
    contrib = got * gate.reshape(b, s * k)[..., None].to(x.dtype)
    y = contrib.view(b, s, k, d).sum(dim=2)

    if cfg.num_shared_experts:
        y = y + apply_ffn(cfg, p["shared"], x)
    return y


def load_balance_loss(cfg, logits, ids):
    """Switch-style auxiliary loss: E * sum_e f_e * p_e."""
    e = cfg.num_experts
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)                           # (E,)
    counts = torch.bincount(ids.reshape(-1), minlength=e).to(torch.float32)
    fe = counts / torch.clamp(counts.sum(), min=1.0)
    return e * torch.sum(fe * me)
