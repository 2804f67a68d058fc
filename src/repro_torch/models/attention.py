"""Attention blocks in PyTorch: GQA (+qk-norm, qkv-bias, local windows)
and MLA (DeepSeek-style multi-head latent attention with a compressed KV
cache and the absorbed decode path).

Layouts: x (B, S, D); q (B, S, H, hd); kv (B, S, K, hd).  Train and
prefill run the JAX package's chunked online-softmax attention
(``flash_attention``; ``_windowed`` for a local window) in plain
PyTorch: the scores come in float32 from the storage-dtype operands (the
reference's ``preferred_element_type=jnp.float32``), masked with ``NEG``
and normalised in float32, one tile of query rows by kv_chunk keys at a
time, so no (S, S) score matrix exists: a 32,768-token prompt holds at
most ``TILE_BYTES`` of float32 scores at once.  Decode reads the whole
cache in one block.

Where the reference asserts that a chunk divides the sequence, the port
raises ``ValueError``.  A decode write past the cache raises (the
reference's ``dynamic_update_slice`` clamps).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (ParamSpec, apply_m_rope, apply_rope,
                                       rms_norm)

NEG = -1e30


# the (B, H, rows, keys) float32 score tile a step of ``flash_attention``
# or ``_windowed`` holds at most (or one chunk's, where that is larger)
TILE_BYTES = 1 << 30


def _chunks_per_block(b: int, h: int, n: int, rows: int, cols: int) -> int:
    """The most query chunks (a divisor of n) whose (b, h, chunks * rows,
    cols) float32 score tile stays within TILE_BYTES; at least one."""
    per = b * h * rows * cols * 4
    return max([d for d in range(1, n + 1)
                if n % d == 0 and d * per <= TILE_BYTES] or [1])


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, q_chunk: int = 512,
                    kv_chunk: int = 512, q_offset: int = 0):
    """Chunked online-softmax attention (train / prefill).  q: (B, S, H,
    hd); k: (B, Skv, K, hd), v: (B, Skv, K, hd_v) with H = K * G.

    Returns (B, S, H, hd_v) in q's dtype; window=w restricts each query
    to the last w keys (``_windowed``, in k's dtype).  Raises ValueError
    where the reference asserts: S not a multiple of min(q_chunk, S), or
    (without a window) Skv not a multiple of min(kv_chunk, Skv).

    Every query row takes the reference's steps over the kv chunks
    0 .. nkv-1 in float32: the scores from upcast operands, the causal
    mask to NEG, m_new = max(m, rowmax), p = exp(s - m_new), alpha =
    exp(m - m_new), l = l alpha + sum p, acc = acc alpha + p v; out =
    acc / max(l, 1e-30).  A row's result does not depend on which rows
    share a step, so one loop over the kv chunks carries a block of
    query chunks at once, as many as keep the (B, H, rows, kv_chunk)
    tile within TILE_BYTES (``_chunks_per_block``): nq / blocks x nkv
    steps where the reference takes nq x nkv.  No chunk is skipped, fully
    masked or not, so the work is the reference's."""
    b, s, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    scale = 1.0 / math.sqrt(hd)
    cq = min(q_chunk, s)
    if s % cq:
        raise ValueError(f"{s} queries are not a multiple of the "
                         f"{cq}-query chunk")
    nq = s // cq
    if window is not None:
        return _windowed(q, k, v, window, cq, q_offset, scale)
    ckv = min(kv_chunk, skv)
    if skv % ckv:
        raise ValueError(f"{skv} keys are not a multiple of the "
                         f"{ckv}-key chunk")
    nkv = skv // ckv
    rows = cq * _chunks_per_block(b, h, nq, cq, ckv)
    # float32 in the (B, H, S, hd) layout, so that every step's products
    # take their operands as they lie
    qf, kf, vf = (t.to(torch.float32).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    dev = q.device
    kpos = torch.arange(ckv, device=dev)
    outs = []
    for r0 in range(0, s, rows):
        qi = qf[:, :, r0:r0 + rows]
        qpos = q_offset + r0 + torch.arange(rows, device=dev)
        m = torch.full((b, h, rows), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = m.new_zeros((b, h, rows, vf.shape[-1]))
        for j in range(nkv):
            kj = kf[:, :, j * ckv:(j + 1) * ckv]
            vj = vf[:, :, j * ckv:(j + 1) * ckv]
            s_ij = torch.einsum("bhqd,bhsd->bhqs", qi, kj) * scale
            if causal:
                mask = qpos[:, None] >= (j * ckv + kpos)[None, :]
                s_ij = torch.where(mask[None, None], s_ij, NEG)
            m_new = torch.maximum(m, s_ij.amax(dim=-1))
            p = torch.exp(s_ij - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqs,bhsd->bhqd", p, vj)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]    # (b,h,rows,hd)
        outs.append(out.permute(0, 2, 1, 3))                 # (b,rows,h,hd)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.to(q.dtype)


def _windowed(q, k, v, window: int, cq: int, q_offset: int, scale: float):
    """Sliding-window causal attention: query chunk i (of cq rows) sees
    the window + cq keys that start at i * cq of the keys left-padded by
    window (the reference's ``dynamic_slice``), masked to kpos <= qpos,
    qpos - kpos < window and kpos >= 0; one softmax over that span.
    FLOPs O(S * (window + cq)).  Chunks whose (B, H, cq, span) tiles fit
    TILE_BYTES together run as one batched step.  Returns (B, S, H, hd_v)
    in k's dtype."""
    b, s, h, hd = q.shape
    nq = s // cq
    span = window + cq
    f32 = torch.float32
    kp = F.pad(k.to(f32), (0, 0, 0, 0, window, 0))
    vp = F.pad(v.to(f32), (0, 0, 0, 0, window, 0))
    dev = q.device
    arange_q = torch.arange(cq, device=dev)
    arange_s = torch.arange(span, device=dev)
    per = _chunks_per_block(b, h, nq, cq, span)
    qf = q.to(f32).reshape(b, nq, cq, h, hd)
    outs = []
    for i0 in range(0, nq, per):
        starts = range(i0 * cq, (i0 + per) * cq, cq)
        kj = torch.stack([kp[:, st:st + span] for st in starts], dim=1)
        vj = torch.stack([vp[:, st:st + span] for st in starts], dim=1)
        base = q_offset + torch.arange(i0, i0 + per, device=dev)[:, None] * cq
        qpos = base + arange_q                        # (per, cq)
        kpos = base - window + arange_s               # (per, span)
        diff = qpos[:, :, None] - kpos[:, None, :]
        mask = (diff >= 0) & (diff < window) & (kpos[:, None, :] >= 0)
        s_ij = torch.einsum("bcqhd,bcshd->bchqs", qf[:, i0:i0 + per],
                            kj) * scale
        s_ij = torch.where(mask[None, :, None], s_ij, NEG)
        m = s_ij.amax(dim=-1, keepdim=True)
        p = torch.exp(s_ij - m)
        out = torch.einsum("bchqs,bcshd->bchqd", p, vj) / torch.clamp(
            p.sum(dim=-1), min=1e-30)[..., None]
        outs.append(out.permute(0, 1, 3, 2, 4))       # (b, per, cq, h, hd)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(b, s, h, -1).to(k.dtype)


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
    out = flash_attention(q, k, v, causal=True, window=window)
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
    slices the output back; ``flash_attention`` takes v at its own width,
    and the zero columns change no sum."""
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
    out = flash_attention(q, k, v, causal=True)           # (B, S, H, vd)
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
