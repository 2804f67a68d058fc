"""LBH-Hash learning (paper §4) in PyTorch.

Greedy per-bit fitting of the target Gram matrix kS:

    min_{(u_j, v_j)}  || sum_j b_j b_j^T - k S ||_F^2 ,
    b_j = sgn((X u_j) . (X v_j))     (eq. 13)

solved one bit at a time against the residue R_{j-1} = kS - sum_{j'<j} b b^T
(eq. 14/15), via the sigmoid-smoothed surrogate

    g~(u, v) = - b~^T R_{j-1} b~ ,   b~_i = phi(u^T x_i x_i^T v)   (eq. 16/17)

with phi(x) = 2/(1+e^-x) - 1 = tanh(x/2), minimised by Nesterov-accelerated
gradient descent warm-started at BH random projections.

On the CPU a bit's steps run eagerly, the gradient of g~ from autograd as
in the JAX package, its backward the fused chain (``kernels.ops.lbh_chain``:
the plain version there).  On the card they run as one CUDA graph
(``BitLoop``), the counterpart of the reference's ``jit`` of a
``lax.scan``: captured once per ``learn_lbh`` call and replayed once per
bit, its step body computing the same gradient explicitly
(``surrogate_grad``, with the chain kernel in the middle), so the graph
holds no autograd.  torch cannot replay jax.random, so the warm start and
the sample are inputs; the port's own are seeded BH factors and a
``torch.Generator`` sample (``sample_rows``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.functions import LBHHash, _sgn, strict_fp32
from repro_torch.kernels import _build, lbh_grad, ops

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

def _projections(uv, x_m):
    """(p, q) = (X u, X v) of the stacked uv = [u; v]."""
    d = x_m.shape[1]
    with strict_fp32():
        return x_m @ uv[:d], x_m @ uv[d:]


def _cost(uv, x_m, r):
    """(g~(uv), p, q): the surrogate (eq. 16) and its two projections."""
    p, q = _projections(uv, x_m)
    with strict_fp32():
        b = torch.tanh(0.5 * p * q)
        return -(b @ (r @ b)), p, q


class SurrogateCost(torch.autograd.Function):
    """g~(u, v) = -b~^T R b~ (eq. 16) of the stacked uv = [u; v], with the
    eq.-18 gradient from the fused chain.  R must be symmetric (it is:
    kS - sum b b^T); the chain's 2 R b is autodiff's (R + R^T) b then."""

    @staticmethod
    def forward(ctx, uv, x_m, r):
        cost, p, q = _cost(uv, x_m, r)
        ctx.save_for_backward(x_m, r, p, q)
        return cost

    @staticmethod
    def backward(ctx, grad_cost):
        x_m, r, p, q = ctx.saved_tensors
        return grad_cost * _chain_grad(x_m, r, p, q), None, None


def _chain_grad(x_m, r, p, q):
    """-[X^T (s q); X^T (s p)] (eq. 18) from the projections p, q."""
    sq, sp = ops.lbh_chain(p, q, r)
    with strict_fp32():
        return -torch.cat([sq @ x_m, sp @ x_m])


def surrogate_cost(uv: torch.Tensor, x_m: torch.Tensor,
                   r: torch.Tensor) -> torch.Tensor:
    """g~(u, v) = -b~^T R b~ (eq. 16); uv is the stacked [u; v] vector."""
    return SurrogateCost.apply(uv, x_m, r)


def surrogate_grad(uv: torch.Tensor, x_m: torch.Tensor,
                   r: torch.Tensor) -> torch.Tensor:
    """The gradient of g~ at uv, computed explicitly: what
    ``SurrogateCost.backward`` returns, the same operations in the same
    order, without autograd."""
    return _chain_grad(x_m, r, *_projections(uv, x_m))


def _momentum(steps: int) -> list[float]:
    """Nesterov's momentum mu_k = (t_k - 1) / t_{k+1} for each step, from
    t_0 = 1 in float32 on the host, as JAX's runs in float32.  It does not
    depend on the data."""
    t = np.float32(1.0)
    mus = []
    for _ in range(steps):
        t_next = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        mus.append(float((t - np.float32(1.0)) / t_next))
        t = t_next
    return mus


def nesterov_step(x, x_prev, mu: float, lr: float, best, best_c, x_m, r):
    """One step of the reference's scan body (JAX ``_nesterov_bit``'s
    ``body``) with the explicit gradient: returns (x_new, cost at x_new,
    best, best_c), the best iterate kept on the device."""
    y = x + mu * (x - x_prev)
    x_new = y - lr * surrogate_grad(y, x_m, r)
    c = _cost(x_new, x_m, r)[0]
    better = c < best_c
    return (x_new, c, torch.where(better, x_new, best),
            torch.where(better, c, best_c))


class BitLoop:
    """One bit's ``steps`` Nesterov steps on the card as one CUDA graph.

    Captured once (at construction) over static buffers: the warm start
    ``uv0``, the residue ``r`` (both copied in before each replay, so the
    caller's tensors are never written), the sample ``x_m`` (read in
    place: it must stay alive and unchanged), the momentum schedule and
    ``lr`` baked in.  ``run`` replays it and returns copies of the best
    iterate and the (steps,) costs.  One eager step on a side stream warms
    cuBLAS up first; its chain launch counts in
    ``lbh_chain.warmup_launches``, and each replay adds the graph's
    captured launches to ``lbh_chain.launches``.  A failed capture raises.
    ``BitLoop.captures`` counts the captures made (the port's counterpart
    of the reference's jit trace counter).
    """

    captures = 0

    def __init__(self, x_m: torch.Tensor, steps: int, lr: float):
        if x_m.device.type != "cuda":
            raise ValueError(f"BitLoop runs on a CUDA device, got "
                             f"{x_m.device}")
        m, d = x_m.shape
        self.x_m, self.d = x_m, d
        self.uv0 = torch.zeros(2 * d, dtype=torch.float32, device=x_m.device)
        self.r = torch.zeros((m, m), dtype=torch.float32, device=x_m.device)
        mus, lr = _momentum(steps), float(np.float32(lr))
        main = torch.cuda.current_stream(x_m.device)
        side = torch.cuda.Stream(x_m.device)
        side.wait_stream(main)
        self.graph = torch.cuda.CUDAGraph()
        captured = lbh_grad.lbh_chain.captured
        # capture_begin / capture_end rather than the torch.cuda.graph
        # context, which first collects garbage and empties the allocator's
        # cache (seconds in a process that holds a large heap); a capture
        # that only this thread's calls can break, so that other threads
        # (a serving front end) keep using the card meanwhile
        with torch.cuda.stream(side), torch.no_grad():
            with lbh_grad.warming_up():
                _loop(self.uv0, x_m, self.r, mus[:1], lr)
            side.synchronize()
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.best, self.costs = _loop(self.uv0, x_m, self.r, mus, lr)
            finally:
                self.graph.capture_end()
        main.wait_stream(side)
        self.chain_launches = lbh_grad.lbh_chain.captured - captured
        _build.count(BitLoop, "captures")

    def run(self, u0: torch.Tensor, v0: torch.Tensor, r: torch.Tensor):
        """(u, v, costs (steps,)) of one bit from warm start (u0, v0)
        against residue r: one replay."""
        with torch.no_grad():
            self.uv0[:self.d].copy_(u0)
            self.uv0[self.d:].copy_(v0)
            self.r.copy_(r)
        self.graph.replay()
        _build.count(lbh_grad.lbh_chain, n=self.chain_launches)
        best = self.best.clone()
        return best[:self.d], best[self.d:], self.costs.clone()


def _loop(uv0, x_m, r, mus, lr):
    """The steps of one bit (one per entry of mus) as straight-line
    device work: (best iterate, (len(mus),) costs)."""
    best_c = _cost(uv0, x_m, r)[0]
    x, x_prev, best = uv0, uv0, uv0
    costs = []
    for mu in mus:
        x_new, c, best, best_c = nesterov_step(x, x_prev, mu, lr, best,
                                               best_c, x_m, r)
        costs.append(c)
        x, x_prev = x_new, x
    return best, (torch.stack(costs) if costs else best_c.new_empty((0,)))


def _nesterov_bit(u0, v0, x_m, r, steps: int, lr: float,
                  loop: BitLoop | None = None):
    """Nesterov's accelerated gradient on g~ for one bit (fixed R).

    Returns (u, v, costs (steps,)): the best iterate seen (g~ is
    nonconvex), chosen on the device with ``torch.where``, so the loop
    makes no host sync.  With ``loop`` (a ``BitLoop`` captured for these
    x_m, steps and lr) the steps run as one replay of its graph; without,
    eagerly, the gradient from autograd.
    """
    if loop is not None:
        return loop.run(u0, v0, r)
    uv0 = torch.cat([u0, v0])
    with torch.no_grad():
        best_c = surrogate_cost(uv0, x_m, r)
    x, x_prev, best = uv0, uv0, uv0
    lr = float(np.float32(lr))
    costs = []
    for mu in _momentum(steps):
        y = (x + mu * (x - x_prev)).requires_grad_(True)
        (g,) = torch.autograd.grad(surrogate_cost(y, x_m, r), y)
        with torch.no_grad():
            x_new = y - lr * g
            c = surrogate_cost(x_new, x_m, r)
            better = c < best_c
            best = torch.where(better, x_new, best)
            best_c = torch.where(better, c, best_c)
        costs.append(c)
        x, x_prev = x_new, x
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
    All tensors on one device; the per-bit loops make no host sync.  On a
    CUDA device the k bits replay one ``BitLoop`` captured here.
    """
    x_m = x_m.to(torch.float32)
    if t1 is None or t2 is None:
        t1, t2 = auto_thresholds(x_m, x_m if x_all is None else x_all)
    r = k * similarity_matrix(x_m, t1, t2)
    us, vs, costs = [], [], []
    rnorms = [torch.linalg.vector_norm(r)]
    # lr scaling: g~ gradients grow with m; normalise for stable steps.
    lr_eff = lr / x_m.shape[0]
    loop = (BitLoop(x_m, steps, lr_eff) if x_m.device.type == "cuda" and k
            else None)
    for j in range(k):
        u, v, cost_j = _nesterov_bit(u0[:, j], v0[:, j], x_m, r, steps,
                                     lr_eff, loop)
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
