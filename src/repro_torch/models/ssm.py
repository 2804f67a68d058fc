"""Mamba-2 (SSD, state-space duality) mixer block in PyTorch.

The reference's chunked SSD algorithm: an intra-chunk quadratic term
(matmuls) plus an inter-chunk linear state recurrence (a short loop over
chunks).  Plain PyTorch, as the JAX package leaves it to XLA.

Shapes: d_inner = expand * d_model; heads P = d_inner / headdim; state N.
x/z from the in-projection; B, C shared across heads (n_groups = 1); a
per-head scalar decay dt with A = -exp(A_log) < 0.

The reference's three-operand einsums are written here as two pairwise
products each, in the order that keeps every intermediate at most
(B, c, l, l, P) or (B, c, l, P, H) (about 25 MB a layer at mamba2-780m's
width, B 8, S 128): ``torch.einsum`` would pair them left to right, and
one order materialises (B, c, l, l, P, H).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, rms_norm, silu
from repro_torch.utils.device import resolve_device


def _dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    heads = di // cfg.ssm_headdim
    return di, heads, cfg.ssm_state, cfg.ssm_headdim


def ssm_spec(cfg):
    d = cfg.d_model
    di, heads, n, _ = _dims(cfg)
    return {
        "w_zx": ParamSpec((d, 2 * di), ("embed", "rnn")),
        "w_bc": ParamSpec((d, 2 * n), ("embed", "null")),
        "w_dt": ParamSpec((d, heads), ("embed", "rnn")),
        "dt_bias": ParamSpec((heads,), ("rnn",), "zeros"),
        "conv_x": ParamSpec((cfg.conv_width, di), ("null", "rnn")),
        "conv_bc": ParamSpec((cfg.conv_width, 2 * n), ("null", "null")),
        "a_log": ParamSpec((heads,), ("rnn",), "ones"),
        "d_skip": ParamSpec((heads,), ("rnn",), "ones"),
        "norm": ParamSpec((di,), ("rnn",), "zeros"),
        "w_out": ParamSpec((di, d), ("rnn", "embed")),
    }


def _conv(w, x, state=None):
    """Depthwise causal conv of width cw, then SiLU.  x: (B, S, C); state:
    (B, cw-1, C) trailing inputs (zeros without one).  Returns (out, the
    new state)."""
    cw = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(cw))
    return silu(out), xp[:, xp.shape[1] - (cw - 1):, :]


def ssd_chunked(xh, dt, a_log, bmat, cmat, chunk: int):
    """Chunked SSD scan.

    xh: (B, S, P, H) inputs per head; dt: (B, S, P) float32; bmat/cmat:
    (B, S, N).  S must be at most ``chunk`` or a multiple of it (the
    reference's contract: it asserts, this raises ``ValueError``).
    Returns (y (B, S, P, H) in xh's dtype, final state (B, P, N, H)
    float32).
    """
    b, s, p, hdim = xh.shape
    n = bmat.shape[-1]
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {l}")
    nc = s // l
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))                    # (P,)
    da = dt * a                                      # (B, S, P) negative
    xdt = xh * dt[..., None]                         # B-weighted input

    xc = xdt.reshape(b, nc, l, p, hdim).to(f32)
    dac = da.reshape(b, nc, l, p).to(f32)
    bc = bmat.reshape(b, nc, l, n).to(f32)
    cc = cmat.reshape(b, nc, l, n).to(f32)

    cum = torch.cumsum(dac, dim=2)                   # (B, nc, l, P)
    # intra-chunk: y_ij = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) xdt_j
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)     # (B, nc, l, l)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,i,j,P)
    ii = torch.arange(l, device=xh.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # mask BEFORE exp: exp of the (unused) i<j entries overflows
    decay = torch.exp(torch.where(causal, diff, -1e9))
    y_intra = torch.einsum("bcijp,bcjph->bciph", cb[..., None] * decay, xc)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) B_j (outer) xdt_j
    dec_state = torch.exp(cum[:, :, -1:, :] - cum)   # (B, nc, l, P)
    states = torch.einsum("bcjn,bcjph->bcpnh", bc,
                          dec_state[..., None] * xc)

    # inter-chunk recurrence: h_c = exp(sum_c) h_{c-1} + S_c
    chunk_decay = torch.exp(cum[:, :, -1, :])       # (B, nc, P)
    h = torch.zeros((b, p, n, hdim), dtype=f32, device=xh.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)            # (B, nc, P, N, H)

    # inter-chunk output: C_i exp(cum_i) h_{c-1}
    y_inter = (torch.einsum("bcin,bcpnh->bciph", cc, h_prevs)
               * torch.exp(cum)[..., None])
    y = (y_intra + y_inter).reshape(b, s, p, hdim)
    return y.to(xh.dtype), h


def _project(cfg, p, x):
    """z, the conv input, the B/C input and dt (float32 softplus of the
    matmul in x's dtype) from x."""
    di = _dims(cfg)[0]
    zx = x @ p["w_zx"]
    dt = F.softplus((x @ p["w_dt"]).to(torch.float32)
                    + p["dt_bias"].to(torch.float32))
    return zx[..., :di], zx[..., di:], x @ p["w_bc"], dt


def _out(cfg, p, y, z, x):
    di = _dims(cfg)[0]
    b, s = y.shape[:2]
    y = y.reshape(b, s, di).to(x.dtype)
    return rms_norm(y * silu(z), p["norm"], cfg.norm_eps) @ p["w_out"]


def ssm_forward(cfg, p, x, *, make_cache=False, chunk: int = 256):
    """x: (B, S, D) -> (B, S, D); with make_cache the cache {"h": (B, P,
    N, H) float32, "conv_x", "conv_bc"} after the last step."""
    b, s, _ = x.shape
    _, heads, n, hd = _dims(cfg)
    z, xi, bc_raw, dt = _project(cfg, p, x)          # dt (B, S, P)
    xc, conv_x_state = _conv(p["conv_x"], xi)
    bcc, conv_bc_state = _conv(p["conv_bc"], bc_raw)
    xh = xc.reshape(b, s, heads, hd)
    y, h_last = ssd_chunked(xh, dt, p["a_log"], bcc[..., :n], bcc[..., n:],
                            chunk)
    y = y + (p["d_skip"].to(torch.float32)[None, None, :, None]
             * xh.to(torch.float32))
    cache = None
    if make_cache:
        cache = {"h": h_last, "conv_x": conv_x_state,
                 "conv_bc": conv_bc_state}
    return _out(cfg, p, y, z, x), cache


def ssm_decode(cfg, p, x, cache):
    """One step.  x: (B, 1, D); cache: h (B, P, N, H) float32, conv_x
    (B, cw-1, di), conv_bc (B, cw-1, 2N).  Returns (y, a new cache)."""
    b = x.shape[0]
    _, heads, n, hd = _dims(cfg)
    f32 = torch.float32
    z, xi, bc_raw, dt = _project(cfg, p, x)
    dt = dt[:, 0]                                     # (B, P)
    xc, conv_x_state = _conv(p["conv_x"], xi, cache["conv_x"])
    bcc, conv_bc_state = _conv(p["conv_bc"], bc_raw, cache["conv_bc"])
    bmat, cmat = bcc[:, 0, :n].to(f32), bcc[:, 0, n:].to(f32)   # (B, N)
    xh = xc[:, 0].reshape(b, heads, hd).to(f32)
    a = -torch.exp(p["a_log"].to(f32))
    dec = torch.exp(dt * a)                           # (B, P)
    upd = bmat[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :]
    h = dec[..., None, None] * cache["h"] + upd
    y = torch.einsum("bn,bpnh->bph", cmat, h)
    y = y + p["d_skip"].to(f32)[None, :, None] * xh
    return _out(cfg, p, y[:, None], z, x), {
        "h": h, "conv_x": conv_x_state, "conv_bc": conv_bc_state}


def ssm_init_cache(cfg, batch: int, dtype, device="cuda"):
    """Zero state on ``device`` (default the card; a missing card
    raises)."""
    device = resolve_device(device)
    di, heads, n, hd = _dims(cfg)
    cw = cfg.conv_width
    return {"h": torch.zeros((batch, heads, n, hd), dtype=torch.float32,
                             device=device),
            "conv_x": torch.zeros((batch, cw - 1, di), dtype=dtype,
                                  device=device),
            "conv_bc": torch.zeros((batch, cw - 1, 2 * n), dtype=dtype,
                                   device=device)}
