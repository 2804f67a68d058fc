"""RG-LRU recurrent block (RecurrentGemma / Griffin) in PyTorch.

Recurrence (per channel):  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
with a_t = exp(c * r_t * log sigmoid(Lambda)),  r_t, i_t input-sigmoid gates.

The JAX package runs the prefill recurrence as ``lax.associative_scan``
and leaves it to XLA; here it is a log-depth doubling scan in plain
PyTorch (``linear_scan``: ceil(log2 S) rounds of elementwise work, sums in
float32).  Decode is the single-step update.  Gate matrices are
block-diagonal, as in the Griffin paper.

Dtypes are the reference's: the gates and the recurrence run in float32
(the bf16 gate weights upcast, as ``jnp.einsum`` promotes them), the
prefill's h rounds to x's dtype before the output product and before the
last step is cached, and the cached h stays float32 from there on.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, gelu_tanh
from repro_torch.utils.device import resolve_device

_C = 8.0  # Griffin's fixed gate sharpness


def rglru_spec(cfg, blocks: int = 16):
    d, r = cfg.d_model, cfg.rnn_width
    rb = r // blocks
    return {
        "w_gate_branch": ParamSpec((d, r), ("embed", "rnn")),
        "w_in": ParamSpec((d, r), ("embed", "rnn")),
        "conv_w": ParamSpec((cfg.conv_width, r), ("null", "rnn")),
        "conv_b": ParamSpec((r,), ("rnn",), "zeros"),
        # block-diagonal input/recurrence gates (shard-local)
        "w_a": ParamSpec((blocks, rb, rb), ("rnn_blocks", "null", "null")),
        "b_a": ParamSpec((r,), ("rnn",), "zeros"),
        "w_x": ParamSpec((blocks, rb, rb), ("rnn_blocks", "null", "null")),
        "b_x": ParamSpec((r,), ("rnn",), "zeros"),
        "lam": ParamSpec((r,), ("rnn",), "rglru_lambda"),
        "w_out": ParamSpec((r, d), ("rnn", "embed")),
    }


def _block_diag_matmul(x, w):
    """x: (..., r) with w: (blocks, rb, rb) block-diagonal.  Both come to
    their promoted dtype first (``torch.einsum`` refuses mixed dtypes)."""
    blocks, rb, _ = w.shape
    dt = torch.promote_types(x.dtype, w.dtype)
    xs = x.to(dt).reshape(x.shape[:-1] + (blocks, rb))
    return torch.einsum("...gi,gij->...gj", xs, w.to(dt)).reshape(x.shape)


def _gates(p, xc):
    """a_t and the gated input of the recurrence, from float32 xc."""
    r_t = torch.sigmoid(_block_diag_matmul(xc, p["w_a"]) + p["b_a"])
    i_t = torch.sigmoid(_block_diag_matmul(xc, p["w_x"]) + p["b_x"])
    log_a = _C * r_t * F.logsigmoid(p["lam"].to(torch.float32))
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_t * xc)
    return a, gated


def _causal_conv(p, x, state=None):
    """Depthwise causal conv of width cw.  x: (B, S, r); state: (B, cw-1,
    r), the trailing inputs of the previous segment (zeros without one).
    Returns (out, the new state)."""
    w = p["conv_w"]
    cw = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(cw))
    return out + p["conv_b"], xp[:, xp.shape[1] - (cw - 1):, :]


def linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t along dim 1 from h_{-1} = 0, for every t:
    the doubling (Hillis-Steele) form of the reference's associative scan,
    ceil(log2 S) rounds, each composing every element with the one k
    steps back."""
    k, s = 1, a.shape[1]
    while k < s:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def rglru_forward(cfg, p, x, *, make_cache=False):
    """Train / prefill.  x: (B, S, D) -> (B, S, D); with make_cache the
    cache {"h": (B, r) float32, "conv": (B, cw-1, r)} after the last
    step."""
    gate_branch = gelu_tanh(x @ p["w_gate_branch"])
    xi = x @ p["w_in"]
    xc, conv_state = _causal_conv(p, xi)
    a, gated = _gates(p, xc.to(torch.float32))
    h = linear_scan(a, gated).to(x.dtype)
    y = (gate_branch * h) @ p["w_out"]
    cache = None
    if make_cache:
        cache = {"h": h[:, -1, :].to(torch.float32), "conv": conv_state}
    return y, cache


def rglru_decode(cfg, p, x, cache):
    """One step.  x: (B, 1, D); cache: {h: (B, r) float32, conv: (B, cw-1,
    r)}.  Returns (y, a new cache)."""
    gate_branch = gelu_tanh(x @ p["w_gate_branch"])
    xi = x @ p["w_in"]
    xc, conv_state = _causal_conv(p, xi, cache["conv"])
    a, gated = _gates(p, xc.to(torch.float32))         # (B, 1, r)
    h = a[:, 0] * cache["h"] + gated[:, 0]
    y = (gate_branch * h[:, None, :].to(x.dtype)) @ p["w_out"]
    return y, {"h": h, "conv": conv_state}


def rglru_init_cache(cfg, batch: int, dtype, device="cuda"):
    """Zero state on ``device`` (default the card; a missing card
    raises)."""
    device = resolve_device(device)
    r, cw = cfg.rnn_width, cfg.conv_width
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cw - 1, r), dtype=dtype,
                                device=device)}
