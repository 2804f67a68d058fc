"""Shared layer primitives and the ParamSpec system, in PyTorch.

Every parameter is declared once as a ``ParamSpec`` (shape, logical axes,
init), as in the JAX package; the same declaration drives initialisation
and the shape checks of ``transformer.Transformer``.  Layouts are the JAX
package's: a projection is ``x @ w`` with w of shape (d_in, d_out), so
weights carry across without transposes.

Not here (later slices, ROADMAP.md items 11b / 11c): the activation and
MoE sharding helpers, M-RoPE and the losses.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


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
    a matrix) and then casts to dtype; "zeros" and "ones" are constant.
    The draws come from ``generator`` (on its own device), leaf by leaf in
    the tree's sorted-key order; they cannot match ``jax.random``'s.
    """
    device = torch.device(device)

    def one(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init != "normal":
            raise NotImplementedError(
                f"init {spec.init!r} belongs to a block kind outside the "
                f"dense-attention slice (ROADMAP.md item 11c)")
        scale = spec.scale
        if scale is None:
            fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        z = torch.randn(spec.shape, generator=generator,
                        dtype=torch.float32, device=generator.device)
        return (scale * z).to(device=device, dtype=dtype)

    return tree_map(one, struct)


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
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    angles = pos[..., None].to(torch.float32) * freqs      # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                  # over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU / GeGLU / plain)
# ---------------------------------------------------------------------------

def ffn_spec(cfg, d_in: int, d_hidden: int):
    s = {"w_down": ParamSpec((d_hidden, d_in), ("ffn", "embed"))}
    if cfg.mlp_gated:
        s["w_gate"] = ParamSpec((d_in, d_hidden), ("embed", "ffn"))
    s["w_up"] = ParamSpec((d_in, d_hidden), ("embed", "ffn"))
    return s


def _act(cfg, x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.mlp_act == "silu" else F.gelu(x,
                                                          approximate="tanh")


def apply_ffn(cfg, p, x):
    if cfg.mlp_gated:
        h = _act(cfg, x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = _act(cfg, x @ p["w_up"])
    return h @ p["w_down"]
