"""Attention blocks in PyTorch: GQA (+qk-norm, qkv-bias, local windows)
and MLA (DeepSeek-style multi-head latent attention with a compressed KV
cache and the absorbed decode path).

Layouts: x (B, S, D); q (B, S, H, hd); kv (B, S, K, hd).  The attention
itself is plain PyTorch: the scores come in float32 from the storage-dtype
operands (the JAX package's ``preferred_element_type=jnp.float32``), masked
with ``NEG`` and normalised in float32.  The JAX package's online-softmax
chunking keeps (S, S) scores out of HBM at 32k tokens; the port's prompts
are short, so one block of scores per call.

A decode write past the cache raises (the reference's
``dynamic_update_slice`` clamps).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import (ParamSpec, apply_m_rope, apply_rope,
                                       rms_norm)

NEG = -1e30


def _scores(q, k):
    """(B, H, Sq, Skv) float32 scores from q (B, Sq, H, hd) and
    k (B, Skv, H, hd).  bf16 products are exact in float32, so upcasting
    first and summing in float32 is the float32-accumulated product."""
    return torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32),
                        k.to(torch.float32))


def attention(q, k, v, *, window: int | None = None):
    """Causal attention.  q: (B, S, H, hd); k, v: (B, Skv, K, hd) with
    H = K * G.  window=w restricts each query to the last w keys.

    Returns (B, S, H, hd) in q's dtype (the windowed form in k's, as the
    JAX package's ``_windowed``)."""
    b, s, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    scale = 1.0 / math.sqrt(hd)
    scores = _scores(q, k) * scale                       # (b, h, s, skv)
    qpos = torch.arange(s, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    scores = torch.where(mask[None, None], scores, NEG)
    m = scores.max(dim=-1, keepdim=True).values
    p = torch.exp(scores - m)
    acc = torch.einsum("bhqs,bshd->bhqd", p, v.to(torch.float32))
    out = acc / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    out = out.permute(0, 2, 1, 3)                        # (b, s, h, hd)
    return out.to(k.dtype if window is not None else q.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def gqa_spec(cfg):
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "w_q": ParamSpec((d, h * hd), ("embed", "heads")),
        "w_k": ParamSpec((d, kh * hd), ("embed", "kv")),
        "w_v": ParamSpec((d, kh * hd), ("embed", "kv")),
        "w_o": ParamSpec((h * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        s["b_q"] = ParamSpec((h * hd,), ("heads",), "zeros")
        s["b_k"] = ParamSpec((kh * hd,), ("kv",), "zeros")
        s["b_v"] = ParamSpec((kh * hd,), ("kv",), "zeros")
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), ("null",), "zeros")
        s["k_norm"] = ParamSpec((hd,), ("null",), "zeros")
    return s


def _project_qkv(cfg, p, x):
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["w_q"]
    k = x @ p["w_k"]
    v = x @ p["w_v"]
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kh, hd)
    v = v.reshape(b, s, kh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope_qk(cfg, q, k, pos):
    if cfg.m_rope_sections:
        return (apply_m_rope(q, pos, cfg.rope_theta, cfg.m_rope_sections),
                apply_m_rope(k, pos, cfg.rope_theta, cfg.m_rope_sections))
    return (apply_rope(q, pos, cfg.rope_theta),
            apply_rope(k, pos, cfg.rope_theta))


def gqa_forward(cfg, p, x, pos, *, window=None, make_cache=False,
                cache_len: int = 0):
    """Train / prefill.  pos: (B, S) int, or (3, B, S) for M-RoPE.  With
    make_cache, the cache holds the last min(alloc, S) keys and values
    from slot 0, alloc = cache_len (min(window, cache_len) for a windowed
    block)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, pos)
    out = attention(q, k, v, window=window)
    y = out.reshape(b, s, -1) @ p["w_o"]
    cache = None
    if make_cache:
        alloc = min(window, cache_len) if window else cache_len
        kc = torch.zeros((b, alloc) + k.shape[2:], dtype=k.dtype,
                         device=k.device)
        vc = torch.zeros_like(kc)
        take = min(alloc, s)
        kc[:, :take] = k[:, s - take:]
        vc[:, :take] = v[:, s - take:]
        cache = {"k": kc, "v": vc}
    return y, cache


def gqa_decode(cfg, p, x, cache, pos: int, *, window=None):
    """One-token decode.  x: (B, 1, D); cache k/v: (B, A, K, hd);
    pos: the position written this step (a Python int, uniform across the
    batch; M-RoPE rotates all three streams by it).  A windowed cache is
    a ring: slot j holds the largest position <= pos congruent to j mod
    A.  Returns (y, new cache); the cache tensors are updated in place."""
    b = x.shape[0]
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(cfg, p, x)     # (B,1,H,hd)/(B,1,K,hd)
    p3 = torch.full((3, b, 1) if cfg.m_rope_sections else (b, 1), pos,
                    device=x.device)
    q, k = _rope_qk(cfg, q, k, p3)
    kc, vc = cache["k"], cache["v"]
    alloc = kc.shape[1]
    slot = pos % alloc if window else pos
    if not 0 <= slot < alloc:
        raise ValueError(f"decode position {pos} past the cache's {alloc} "
                         f"slots")
    kc[:, slot] = k[:, 0]
    vc[:, slot] = v[:, 0]

    qg = q.reshape(b, kh, h // kh, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.to(torch.float32),
                          kc.to(torch.float32))
    scores = scores / math.sqrt(hd)
    j = torch.arange(alloc, device=x.device)
    if window:
        kpos = pos - torch.remainder(pos - j, alloc)
        valid = (kpos >= 0) & (kpos <= pos) & (pos - kpos < window)
    else:
        valid = j <= pos
    scores = torch.where(valid[None, None, None, :], scores, NEG)
    attn = torch.softmax(scores, dim=-1).to(vc.dtype)
    ctx = torch.einsum("bkgs,bskh->bkgh", attn.to(torch.float32),
                       vc.to(torch.float32))
    y = ctx.reshape(b, 1, h * hd).to(x.dtype) @ p["w_o"]
    return y, {"k": kc, "v": vc}


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V3 / MiniCPM3)
# ---------------------------------------------------------------------------

def mla_spec(cfg):
    d, h = cfg.d_model, cfg.num_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "w_dq": ParamSpec((d, ql), ("embed", "lora")),
        "q_norm": ParamSpec((ql,), ("null",), "zeros"),
        "w_uq": ParamSpec((ql, h * (nope + rope_d)), ("lora", "heads")),
        "w_dkv": ParamSpec((d, kvl + rope_d), ("embed", "lora")),
        "kv_norm": ParamSpec((kvl,), ("null",), "zeros"),
        "w_uk": ParamSpec((kvl, h * nope), ("lora", "heads")),
        "w_uv": ParamSpec((kvl, h * vd), ("lora", "heads")),
        "w_o": ParamSpec((h * vd, d), ("heads", "embed")),
    }


def _mla_q(cfg, p, x):
    b, s, _ = x.shape
    h = cfg.num_heads
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(b, s, h, nope + rope_d)
    return q[..., :nope], q[..., nope:]


def _mla_kv_low(cfg, p, x):
    kvl = cfg.kv_lora_rank
    low = x @ p["w_dkv"]
    c_kv = rms_norm(low[..., :kvl], p["kv_norm"], cfg.norm_eps)
    return c_kv, low[..., kvl:]


def mla_forward(cfg, p, x, pos, *, make_cache=False, cache_len: int = 0):
    """Train / prefill.  pos: (B, S) int.  Keys and values are expanded
    from the latent per head; the scale is 1/sqrt(nope + rope).  With
    make_cache the cache holds the latent {"c_kv": (B, cache_len,
    kv_lora), "k_pe": (B, cache_len, rope)}, positions 0..S-1 filled.

    The reference pads v up to the qk width for its flash kernel and
    slices the output back; ``attention`` takes v at its own width, and
    the zero columns change no sum."""
    b, s, _ = x.shape
    h = cfg.num_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_pe = _mla_q(cfg, p, x)
    c_kv, k_pe = _mla_kv_low(cfg, p, x)
    q_pe = apply_rope(q_pe, pos, cfg.rope_theta)
    k_pe = apply_rope(k_pe[:, :, None, :], pos, cfg.rope_theta)  # (B,S,1,r)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, nope)
    v = (c_kv @ p["w_uv"]).reshape(b, s, h, vd)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, s, h, rope_d)], dim=-1)
    out = attention(q, k, v)                              # (B, S, H, vd)
    y = out.reshape(b, s, h * vd) @ p["w_o"]
    cache = None
    if make_cache:
        if s > cache_len:
            raise ValueError(f"prefill of {s} positions past the cache's "
                             f"{cache_len} slots")
        ckv_c = x.new_zeros((b, cache_len, cfg.kv_lora_rank))
        kpe_c = x.new_zeros((b, cache_len, rope_d))
        ckv_c[:, :s] = c_kv
        kpe_c[:, :s] = k_pe[:, :, 0, :]
        cache = {"c_kv": ckv_c, "k_pe": kpe_c}
    return y, cache


def mla_decode(cfg, p, x, cache, pos: int):
    """Absorbed one-token decode: W_uk folds into the query and W_uv into
    the output, so the step reads only the latent cache, O(T * (kv_lora +
    rope)) per head.  x: (B, 1, D); pos: the position written (a Python
    int).  Every cast of the reference is kept: the absorbed query, the
    attention weights and the latent context round to the cache's (or
    W_uv's) dtype before their products, which in bf16 is part of the
    result.  Returns (y, cache), the cache updated in place."""
    b = x.shape[0]
    h = cfg.num_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvl = cfg.kv_lora_rank
    f32 = torch.float32
    q_nope, q_pe = _mla_q(cfg, p, x)           # (B,1,H,*)
    c_kv_t, k_pe_t = _mla_kv_low(cfg, p, x)    # (B,1,kvl), (B,1,r)
    posv = torch.full((b, 1), pos, device=x.device)
    q_pe = apply_rope(q_pe, posv, cfg.rope_theta)
    k_pe_t = apply_rope(k_pe_t[:, :, None, :], posv, cfg.rope_theta)[:, :, 0]
    ckv_c, kpe_c = cache["c_kv"], cache["k_pe"]
    slots = ckv_c.shape[1]
    if not 0 <= pos < slots:
        raise ValueError(f"decode position {pos} past the cache's {slots} "
                         f"slots")
    ckv_c[:, pos] = c_kv_t[:, 0]
    kpe_c[:, pos] = k_pe_t[:, 0]

    ckv = ckv_c.to(f32)
    w_uk = p["w_uk"].reshape(kvl, h, nope)
    q_low = torch.einsum("bhn,lhn->bhl", q_nope[:, 0].to(f32),
                         w_uk.to(f32))                     # (B, H, kvl)
    s_low = torch.einsum("bhl,bsl->bhs", q_low.to(ckv_c.dtype).to(f32), ckv)
    s_pe = torch.einsum("bhr,bsr->bhs", q_pe[:, 0].to(f32), kpe_c.to(f32))
    scores = (s_low + s_pe) / math.sqrt(nope + rope_d)
    valid = torch.arange(slots, device=x.device) <= pos
    scores = torch.where(valid[None, None, :], scores, NEG)
    attn = torch.softmax(scores, dim=-1).to(ckv_c.dtype)
    ctx_low = torch.einsum("bhs,bsl->bhl", attn.to(f32), ckv)
    w_uv = p["w_uv"].reshape(kvl, h, vd)
    ctx = torch.einsum("bhl,lhv->bhv", ctx_low.to(w_uv.dtype).to(f32),
                       w_uv.to(f32))
    y = ctx.reshape(b, 1, h * vd).to(x.dtype) @ p["w_o"]
    return y, {"c_kv": ckv_c, "k_pe": kpe_c}
