"""AdamW with optionally quantized moments, in PyTorch: the JAX package's
update, not ``torch.optim.AdamW`` (which has no global-norm clip, no
schedule and no int8 state).

One step (``apply_updates``): clip the gradients by their global norm,
update both moments in float32, bias-correct them, add the decoupled
weight decay to the update and scale it by the schedule's lr.  Moments
are stored in float32, bfloat16, or int8 (``quantize_blockwise``: int8
codes of the parameter's shape with float32 absmax scales per 256-block
of the last dim, or per row where it does not divide; m rounded
stochastically, v stored in the sqrt domain and rounded to nearest).

Trees are the JAX package's: nested dicts (sorted keys) and lists, the
order of ``jax.tree.flatten``, which fixes the order of the global norm's
sum and each leaf's index i.  The port updates the parameters and the
moments in place (the reference returns new trees), so that a model whose
blocks view its stacked leaves sees the update.

int8's stochastic rounding draws from a ``torch.Generator`` seeded from
(seed, step, i), as the reference folds (step, i) into PRNGKey(0): a step
draws the same uniforms after a restart.  ``uniforms=`` replaces the draws
(the parity tests inject the reference's).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"     # float32 | bfloat16 | int8
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step) -> float:
    """Linear warm-up to lr over warmup_steps, then cosine to
    min_lr_frac * lr at total_steps; in float32 as the reference."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return float(cfg.lr * warm * frac)


# -- block-quantized tensors -------------------------------------------------

def _round(x, uniforms):
    """Round to nearest (uniforms None) or stochastically: floor(x + u)."""
    if uniforms is None:
        return torch.round(x)
    return torch.floor(x + uniforms)


def quantize_blockwise(x, uniforms=None):
    """float32 (..., L) -> (int8 codes (..., L), float32 scales (...,
    L / BLOCK), or (..., 1) where L does not divide).  uniforms: x's
    shape, for stochastic rounding."""
    if x.ndim and x.shape[-1] % BLOCK == 0:
        l = x.shape[-1]
        blocks = x.reshape(x.shape[:-1] + (l // BLOCK, BLOCK))
        scale = torch.clamp(blocks.abs().amax(dim=-1), min=1e-12) / 127.0
        u = None if uniforms is None else uniforms.reshape(blocks.shape)
        q = torch.clamp(_round(blocks / scale[..., None], u), -127, 127)
        return q.to(torch.int8).reshape(x.shape), scale
    amax = x.abs().amax(dim=-1, keepdim=True) if x.ndim else x.abs()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(_round(x / scale, uniforms), -127, 127).to(torch.int8)
    return q, scale


def dequantize_blockwise(q, scale):
    l = q.shape[-1] if q.ndim else 1
    if q.ndim and scale.ndim == q.ndim and scale.shape[-1] * BLOCK == l:
        blocks = q.reshape(q.shape[:-1] + (scale.shape[-1], BLOCK))
        out = blocks.to(torch.float32) * scale[..., None]
        return out.reshape(q.shape)
    return q.to(torch.float32) * scale


# -- trees -------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.flatten`` order (dict keys sorted); a tuple or
    list is a node, as in the reference."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _unflatten(like, it):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return [_unflatten(t, it) for t in like]
    return next(it)


def tree_unflatten(like, leaves: list):
    """leaves (``tree_leaves`` order) in like's structure."""
    it = iter(leaves)
    out = _unflatten(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _up_to(params, tree) -> list:
    """tree's subtrees at params' leaf positions (``flatten_up_to``): an
    int8 moment (codes, scales) is one entry."""
    if isinstance(params, dict):
        if not isinstance(tree, dict) or set(tree) != set(params):
            raise ValueError("tree's keys differ from the parameters'")
        return [x for k in sorted(params) for x in _up_to(params[k], tree[k])]
    if isinstance(params, (list, tuple)):
        if len(tree) != len(params):
            raise ValueError("tree's lists differ from the parameters'")
        return [x for p, t in zip(params, tree) for x in _up_to(p, t)]
    return [tree]


# -- state -------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _moment_init(p, dtype: str):
    if dtype == "int8":
        return list(quantize_blockwise(torch.zeros(p.shape, device=p.device)))
    if dtype not in _DTYPES:
        raise ValueError(f"moment_dtype {dtype!r}: float32, bfloat16 or int8")
    return torch.zeros(p.shape, dtype=_DTYPES[dtype], device=p.device)


def init_opt_state(params, cfg: AdamWConfig):
    """{"step": int32 scalar, "m": tree, "v": tree}, each moment on its
    parameter's device (an int8 moment is [codes, scales]); the step
    counter stays on the host, so that reading it never waits for the
    device."""
    leaves = tree_leaves(params)
    return {
        "step": torch.zeros((), dtype=torch.int32),
        "m": tree_unflatten(params, [_moment_init(p, cfg.moment_dtype)
                                     for p in leaves]),
        "v": tree_unflatten(params, [_moment_init(p, cfg.moment_dtype)
                                     for p in leaves]),
    }


def _read_moment(mom, dtype: str, kind: str):
    if dtype == "int8":
        out = dequantize_blockwise(*mom)
        return out * out if kind == "v" else out
    return mom.to(torch.float32)


def _write_moment(mom, val, dtype: str, kind: str, uniforms=None):
    """val into mom, in place."""
    if dtype == "int8":
        if kind == "v":
            val = torch.sqrt(torch.clamp(val, min=0.0))
        q, s = quantize_blockwise(val, uniforms)
        mom[0].copy_(q)
        mom[1].copy_(s)
    else:
        mom.copy_(val)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32, summed leaf
    by leaf in tree order (a float32 tensor on the first leaf's device)."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        total = total + torch.sum(g.to(torch.float32) ** 2).to(total.device)
    return torch.sqrt(total)


def _leaf_seed(seed: int, step: int, i: int) -> int:
    return int(np.random.SeedSequence([seed, step, i]).generate_state(1)[0])


def draw_uniforms(seed: int, step: int, i: int, shape, device):
    """U[0, 1) float32 for leaf i at ``step``, from a generator seeded from
    (seed, step, i).  On the meta device (the dry-run's account, which
    needs shapes, not draws) the same draw without a generator, which
    meta cannot hold: an op the account counts as the card runs it."""
    if torch.device(device).type == "meta":
        return torch.rand(shape, dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(_leaf_seed(seed, step, i))
    return torch.rand(shape, generator=g, dtype=torch.float32, device=device)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig, *, seed: int = 0,
                  uniforms=None):
    """One AdamW step over the tree ``params`` with ``grads`` (same
    structure), updating the parameters and ``state`` in place.  Returns
    (params, state, metrics): metrics {"grad_norm", "lr"} as float32
    tensors, the norm before the clip.  uniforms: (step, i, shape) ->
    tensor, int8 m's rounding draws for leaf i (default
    ``draw_uniforms(seed, ...)``)."""
    step = int(state["step"]) + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip else 1.0)
    b1c = float(1 - _f32(cfg.b1) ** _f32(step))
    b2c = float(1 - _f32(cfg.b2) ** _f32(step))
    md = cfg.moment_dtype
    flat_p = tree_leaves(params)
    flat_g = _up_to(params, grads)
    flat_m = _up_to(params, state["m"])
    flat_v = _up_to(params, state["v"])
    for i, (p, g, m, v) in enumerate(zip(flat_p, flat_g, flat_m, flat_v,
                                         strict=True)):
        g = g.to(torch.float32) * clip
        m_f = cfg.b1 * _read_moment(m, md, "m") + (1 - cfg.b1) * g
        v_f = cfg.b2 * _read_moment(v, md, "v") + (1 - cfg.b2) * g * g
        del g
        upd = (m_f / b1c) / (torch.sqrt(v_f / b2c) + cfg.eps)
        upd = upd + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * upd)
        del upd
        u = None
        if md == "int8":
            u = (uniforms(step, i, tuple(p.shape)) if uniforms is not None
                 else draw_uniforms(seed, step, i, p.shape, p.device))
        _write_moment(m, m_f, md, "m", u)
        _write_moment(v, v_f, md, "v")
    state["step"].fill_(step)
    return params, state, {"grad_norm": gnorm,
                           "lr": torch.tensor(lr, dtype=torch.float32)}
