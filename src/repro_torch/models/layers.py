"""Shared layer primitives and the ParamSpec system, in PyTorch.

Every parameter is declared once as a ``ParamSpec`` (shape, logical axes,
init), as in the JAX package; the same declaration drives initialisation
and the shape checks of ``transformer.Transformer``.  Layouts are the JAX
package's: a projection is ``x @ w`` with w of shape (d_in, d_out), so
weights carry across without transposes.

Not here: the activation and MoE sharding helpers (GSPMD layout hints,
with no single-device counterpart).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    init: str = "normal"          # normal | zeros | ones | rglru_lambda
    scale: float | None = None    # stddev override for "normal"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in length")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn, tree):
    """fn over the leaves of a tree of dicts and lists (dict keys in sorted
    order, the order of ``jax.tree.flatten``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t) for t in tree]
    return fn(tree)


def stack_specs(struct, n: int):
    """Prepend a stacked `layers` dim of size n to every spec in a tree."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init,
                            s.scale), struct)


def init_params(struct, dtype, *, generator: torch.Generator, device):
    """Materialise a ParamSpec tree as a tree of tensors on ``device``.

    The distributions are the JAX package's: "normal" draws N(0, scale^2)
    in float32 (scale defaults to 1/sqrt(fan_in), fan_in the first dim of
    a matrix) and then casts to dtype; "zeros" and "ones" are constant;
    "rglru_lambda" is logit(u), u uniform on (0.9, 0.999) in float32.
    The draws come from ``generator`` (on its own device), leaf by leaf in
    the tree's sorted-key order; they cannot match ``jax.random``'s.
    """
    device = torch.device(device)

    def one(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init == "rglru_lambda":
            # Lambda such that a = sigmoid(Lambda) lies in (0.9, 0.999)
            u = torch.rand(spec.shape, generator=generator,
                           dtype=torch.float32, device=generator.device)
            u = u.mul_(0.999 - 0.9).add_(0.9)
            return torch.log(u / (1 - u)).to(device=device, dtype=dtype)
        if spec.init != "normal":
            raise ValueError(f"unknown init {spec.init!r}")
        scale = spec.scale
        if scale is None:
            fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        z = torch.randn(spec.shape, generator=generator,
                        dtype=torch.float32, device=generator.device)
        # in place: a second float32 temporary of a stacked expert leaf
        # (27 x 64 x 2,048 x 1,408) would be another 19.93 GB
        return z.mul_(scale).to(device=device, dtype=dtype)

    return tree_map(one, struct)


def abstract_params(struct, dtype):
    """The tree of ``struct`` as empty tensors of ``dtype`` on the meta
    device: shapes without storage, for the dry-run's account."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), struct)


def logical_axes(struct):
    """Tree of logical-axis tuples, mirroring the param tree."""
    return tree_map(lambda s: s.axes, struct)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps: float):
    """RMS norm in float32, scaled by (1 + gamma), cast back to x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + gamma.to(torch.float32))).to(dt)


def layer_norm(x, gamma, beta, eps: float):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * gamma + beta
    return y.to(dt)


def norm_spec(cfg, dim: int):
    if cfg.norm_type == "layernorm":
        return {"gamma": ParamSpec((dim,), ("null",), "ones"),
                "beta": ParamSpec((dim,), ("null",), "zeros")}
    return {"gamma": ParamSpec((dim,), ("null",), "zeros")}


def apply_norm(cfg, p, x):
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["gamma"], p["beta"], cfg.norm_eps)
    return rms_norm(x, p["gamma"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x, pos, theta: float):
    """x: (..., S, H, hd) with pos (..., S).

    Rotates the two halves of the last dim against each other (the JAX
    package's layout): (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos).
    """
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # (hd/2,)
    return _rotate(x, pos[..., None].to(torch.float32) * freqs)


def _rotate(x, angles):
    """x: (B, S, H, hd) rotated by angles (B, S, hd/2) in float32, cast
    back to x's dtype."""
    cos = torch.cos(angles)[..., None, :]                  # over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_m_rope(x, pos3, theta: float, sections: tuple[int, ...]):
    """Qwen2-VL M-RoPE: the hd/2 frequency slots are split into
    (temporal, height, width) sections, each rotated by its own position
    stream.  x: (B, S, H, hd); pos3: (3, B, S)."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim / 2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # (half,)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(pos3[i][..., None].to(torch.float32)
                     * freqs[start:start + sec])           # (B, S, sec)
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU / GeGLU / plain)
# ---------------------------------------------------------------------------

def ffn_spec(cfg, d_in: int, d_hidden: int):
    s = {"w_down": ParamSpec((d_hidden, d_in), ("ffn", "embed"))}
    if cfg.mlp_gated:
        s["w_gate"] = ParamSpec((d_in, d_hidden), ("embed", "ffn"))
    s["w_up"] = ParamSpec((d_in, d_hidden), ("embed", "ffn"))
    return s


def _in_dtype(c: float, dtype) -> float:
    """c rounded to dtype (the constant as the reference's jaxpr holds
    it), as a Python float."""
    return torch.tensor(c, dtype=dtype).item()


def silu(x):
    """``jax.nn.silu`` step for step: x * 1 / (1 + exp(-x)) (XLA's
    expansion of the logistic), each step rounded to x's dtype.  In bf16,
    ``F.silu``'s single rounding differs from it in ~40% of elements."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def gelu_tanh(x):
    """``jax.nn.gelu`` (the tanh approximation) step for step, with its
    constants rounded to x's dtype; in bf16 ``F.gelu(approximate="tanh")``
    differs from it in ~40% of elements."""
    c1 = _in_dtype(0.044715, x.dtype)
    c2 = _in_dtype(math.sqrt(2 / math.pi), x.dtype)
    return x * (0.5 * (1 + torch.tanh(c2 * (x + c1 * (x * x * x)))))


def _act(cfg, x):
    return silu(x) if cfg.mlp_act == "silu" else gelu_tanh(x)


def apply_ffn(cfg, p, x):
    if cfg.mlp_gated:
        h = _act(cfg, x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = _act(cfg, x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _token_losses(logits, labels, z_loss: float = 0.0):
    """(per-token loss, valid mask) in float32; labels < 0 are ignored.
    The max is detached, and the label's logit is picked by comparing a
    vocabulary iota with the label, as the reference does."""
    lg = logits.to(torch.float32)
    valid = labels >= 0
    lab = torch.clamp(labels, min=0)
    m = lg.max(dim=-1, keepdim=True).values.detach()
    sh = lg - m
    lse = torch.log(torch.exp(sh).sum(dim=-1)) + m[..., 0]
    iota = torch.arange(lg.shape[-1], device=lg.device)
    picked = torch.where(iota == lab[..., None], sh, 0.0).sum(dim=-1) \
        + m[..., 0]
    loss = lse - picked
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return loss, valid


def softmax_xent(logits, labels, mask=None, z_loss: float = 0.0):
    """Mean cross-entropy in float32 over the valid tokens: labels >= 0
    (and mask > 0 where a mask is given)."""
    loss, valid = _token_losses(logits, labels, z_loss)
    if mask is not None:
        valid = valid & (mask > 0)
    denom = torch.clamp(valid.sum(), min=1)
    return (loss * valid).sum() / denom


def chunked_xent(x, labels, unembed_fn, *, chunk: int = 1024,
                 z_loss: float = 0.0):
    """Cross-entropy over the sequence in chunks of ``chunk`` positions
    (the whole sequence where it does not divide): per chunk only the
    (B, c, V) logits exist, and with more than one chunk each chunk's are
    recomputed in backward (``torch.utils.checkpoint``), so the (B, S, V)
    logits never exist whole.  Each chunk's loss is summed over its
    tokens; the denominator (the valid tokens) is applied at the end.
    x: (B, S, D); labels: (B, S)."""
    s = x.shape[1]
    c = min(chunk, s)
    if s % c:
        c = s

    def one(xc, yc):
        loss, valid = _token_losses(unembed_fn(xc), yc, z_loss)
        return (loss * valid).sum(), valid.sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    remat = s // c > 1 and torch.is_grad_enabled()
    for i in range(0, s, c):
        xc, yc = x[:, i:i + c], labels[:, i:i + c]
        part, n = (checkpoint(one, xc, yc, use_reentrant=False) if remat
                   else one(xc, yc))
        tot = tot + part
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1)
