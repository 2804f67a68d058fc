"""LBH-Hash learning (paper §4) in PyTorch.

Greedy per-bit fitting of the target Gram matrix kS:

    min_{(u_j, v_j)}  || sum_j b_j b_j^T - k S ||_F^2 ,
    b_j = sgn((X u_j) . (X v_j))     (eq. 13)

solved one bit at a time against the residue R_{j-1} = kS - sum_{j'<j} b b^T
(eq. 14/15), via the sigmoid-smoothed surrogate

    g~(u, v) = - b~^T R_{j-1} b~ ,   b~_i = phi(u^T x_i x_i^T v)   (eq. 16/17)

with phi(x) = 2/(1+e^-x) - 1 = tanh(x/2), minimised by Nesterov-accelerated
gradient descent warm-started at BH random projections.

The gradient of g~ comes from autograd, as in the JAX package, but its
backward is the fused chain kernel (``kernels.ops.lbh_chain``: a CUDA
kernel on the card, its plain version on the CPU).  torch cannot replay
jax.random, so the warm start and the sample are inputs; the port's own
are seeded BH factors and a ``torch.Generator`` sample (``sample_rows``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.functions import LBHHash, _sgn, strict_fp32
from repro_torch.kernels import ops

# Rows of x_m whose |cos| row against x_all is held at once by
# auto_thresholds: 64 rows x 1.06M columns is 271 MB.
THRESHOLD_ROW_CHUNK = 64


# ---------------------------------------------------------------------------
# Similarity target S (eq. 12)
# ---------------------------------------------------------------------------

def _unit_rows(a: torch.Tensor) -> torch.Tensor:
    return a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True),
                           min=1e-12)


def abs_cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|cos| matrix between rows of a (m, d) and rows of b (n, d)."""
    with strict_fp32():
        return torch.abs(_unit_rows(a) @ _unit_rows(b).T)


def auto_thresholds(x_m: torch.Tensor, x_all: torch.Tensor,
                    frac: float = 0.05) -> tuple[float, float]:
    """The paper's 5% rule: C = |cos|(X_m, X_all); t1 = mean of the per-row
    top-frac values, t2 = mean of the per-row bottom-frac values.

    The JAX package sorts the whole (m, n) matrix; here it is built
    ``THRESHOLD_ROW_CHUNK`` rows at a time and only each row's two tails
    are taken (``torch.topk``), summed in float64, so the means differ from
    JAX's only in summation order.
    """
    an = _unit_rows(x_m)
    bn = _unit_rows(x_all)
    n = bn.shape[0]
    top = max(1, int(frac * n))
    lo_sum = torch.zeros((), dtype=torch.float64, device=x_m.device)
    hi_sum = torch.zeros((), dtype=torch.float64, device=x_m.device)
    for s in range(0, an.shape[0], THRESHOLD_ROW_CHUNK):
        with strict_fp32():
            c = torch.abs(an[s:s + THRESHOLD_ROW_CHUNK] @ bn.T)
        hi_sum += torch.topk(c, top, dim=1).values.sum(dtype=torch.float64)
        lo_sum += torch.topk(c, top, dim=1, largest=False).values.sum(
            dtype=torch.float64)
    count = an.shape[0] * top
    return float(hi_sum / count), float(lo_sum / count)


def similarity_matrix(x_m: torch.Tensor, t1: float,
                      t2: float) -> torch.Tensor:
    """S_{ii'} per eq. (12): +1 above t1, -1 below t2, else 2|cos|-1."""
    c = abs_cosine(x_m, x_m)
    s = 2.0 * c - 1.0
    s = torch.where(c >= t1, 1.0, s)
    return torch.where(c <= t2, -1.0, s)


# ---------------------------------------------------------------------------
# Per-bit surrogate optimisation
# ---------------------------------------------------------------------------

class SurrogateCost(torch.autograd.Function):
    """g~(u, v) = -b~^T R b~ (eq. 16) of the stacked uv = [u; v], with the
    eq.-18 gradient from the fused chain.  R must be symmetric (it is:
    kS - sum b b^T); the chain's 2 R b is autodiff's (R + R^T) b then."""

    @staticmethod
    def forward(ctx, uv, x_m, r):
        d = x_m.shape[1]
        with strict_fp32():
            p = x_m @ uv[:d]
            q = x_m @ uv[d:]
            b = torch.tanh(0.5 * p * q)
            cost = -(b @ (r @ b))
        ctx.save_for_backward(x_m, r, p, q)
        return cost

    @staticmethod
    def backward(ctx, grad_cost):
        x_m, r, p, q = ctx.saved_tensors
        sq, sp = ops.lbh_chain(p, q, r)
        with strict_fp32():
            g = -torch.cat([sq @ x_m, sp @ x_m])
        return grad_cost * g, None, None


def surrogate_cost(uv: torch.Tensor, x_m: torch.Tensor,
                   r: torch.Tensor) -> torch.Tensor:
    """g~(u, v) = -b~^T R b~ (eq. 16); uv is the stacked [u; v] vector."""
    return SurrogateCost.apply(uv, x_m, r)


def _nesterov_bit(u0, v0, x_m, r, steps: int, lr: float):
    """Nesterov's accelerated gradient on g~ for one bit (fixed R).

    Returns (u, v, costs (steps,)): the best iterate seen (g~ is
    nonconvex), chosen on the device with ``torch.where``, so the loop
    makes no host sync.  The momentum schedule t_k does not depend on the
    data; it runs in float32 on the host, as JAX's runs in float32.
    """
    uv0 = torch.cat([u0, v0])
    with torch.no_grad():
        best_c = surrogate_cost(uv0, x_m, r)
    x, x_prev, best = uv0, uv0, uv0
    t = np.float32(1.0)
    lr = np.float32(lr)
    costs = []
    for _ in range(steps):
        t_next = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        mu = (t - np.float32(1.0)) / t_next
        y = (x + float(mu) * (x - x_prev)).requires_grad_(True)
        (g,) = torch.autograd.grad(surrogate_cost(y, x_m, r), y)
        with torch.no_grad():
            x_new = y - float(lr) * g
            c = surrogate_cost(x_new, x_m, r)
            better = c < best_c
            best = torch.where(better, x_new, best)
            best_c = torch.where(better, c, best_c)
        costs.append(c)
        x, x_prev, t = x_new, x, t_next
    d = x_m.shape[1]
    costs = torch.stack(costs) if costs else best_c.new_empty((0,))
    return best[:d], best[d:], costs


@dataclasses.dataclass
class LBHResult:
    family: LBHHash
    t1: float
    t2: float
    bit_costs: torch.Tensor      # (k, steps) surrogate cost per bit
    residue_norms: torch.Tensor  # (k+1,) ||R_j||_F after each bit


def learn_lbh(x_m: torch.Tensor, k: int, u0: torch.Tensor, v0: torch.Tensor,
              *, t1: float | None = None, t2: float | None = None,
              x_all: torch.Tensor | None = None, steps: int = 150,
              lr: float = 0.03) -> LBHResult:
    """Learn k bilinear hash functions from m sampled points (paper §4).

    x_m: (m, d) float32 training sample; u0, v0: (d, k) warm-start factors
    (the JAX package draws them as its BH baseline from the same key; the
    port's own are ``functions.seeded_projections``).  If t1/t2 are None
    they come from the paper's 5% rule against x_all (or x_m itself).
    All tensors on one device; the per-bit loops make no host sync.
    """
    x_m = x_m.to(torch.float32)
    if t1 is None or t2 is None:
        t1, t2 = auto_thresholds(x_m, x_m if x_all is None else x_all)
    r = k * similarity_matrix(x_m, t1, t2)
    us, vs, costs = [], [], []
    rnorms = [torch.linalg.vector_norm(r)]
    # lr scaling: g~ gradients grow with m; normalise for stable steps.
    lr_eff = lr / x_m.shape[0]
    for j in range(k):
        u, v, cost_j = _nesterov_bit(u0[:, j], v0[:, j], x_m, r, steps,
                                     lr_eff)
        with strict_fp32():
            b = _sgn((x_m @ u) * (x_m @ v)).to(torch.float32)
        r = r - torch.outer(b, b)
        us.append(u)
        vs.append(v)
        costs.append(cost_j)
        rnorms.append(torch.linalg.vector_norm(r))
    fam = LBHHash(torch.stack(us, dim=1).contiguous(),
                  torch.stack(vs, dim=1).contiguous())
    return LBHResult(fam, t1, t2, torch.stack(costs), torch.stack(rnorms))


def sample_rows(n: int, m: int, seed: int) -> torch.Tensor:
    """m distinct row indices of n, drawn by a CPU ``torch.Generator``
    seeded with ``seed`` (so the sample does not depend on the device)."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randperm(n, generator=gen)[:m]
