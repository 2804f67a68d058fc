"""Shared layer primitives and the ParamSpec system, in PyTorch.

Every parameter is declared once as a ``ParamSpec`` (shape, logical axes,
init), as in the JAX package; the same declaration drives initialisation
and the shape checks of ``transformer.Transformer``.  Layouts are the JAX
package's: a projection is ``x @ w`` with w of shape (d_in, d_out), so
weights carry across without transposes.

Not here: the activation and MoE sharding helpers (GSPMD layout hints,
with no single-device counterpart), M-RoPE (ROADMAP.md item 11c-iv) and
the losses (item 11b).
"""
from __future__ import annotations

import dataclasses
import math

import torch


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
