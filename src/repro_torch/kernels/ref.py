"""Plain oracles for the kernels, the near-zero bound that decides whether
two hash results may differ in a bit, the rounding bound of the LBH
gradient chain, and the limit the re-rank's float32 margins are held to."""
from __future__ import annotations

import torch

from repro_torch.core.functions import (bilinear_signs, seeded_projections,
                                        strict_fp32)
from repro_torch.utils.bits import hamming_packed, pack_signs


def bilinear_hash_ref(x, u, v):
    """Packed codes pack(sgn((X U) .* (X V))): (n, ceil(k/32)) int32."""
    return pack_signs(bilinear_signs(x, u, v))


def bilinear_hash_seeded_ref(x, seed: int, k: int):
    """Seed-generated packed codes: materialise the factors, then hash."""
    return bilinear_hash_ref(x, *seeded_projections(seed, x.shape[1], k,
                                                    x.device))


def lbh_chain_ref(p, q, r):
    """(s*q, s*p) with b = tanh(pq/2), s = (R b)(1 - b^2)."""
    b = torch.tanh(0.5 * p * q)
    with strict_fp32():
        rb = r @ b
    s = rb * (1.0 - b * b)
    return s * q, s * p


def lbh_grad_ref(x, u, v, r):
    """Full surrogate gradient (eq. 18): (-X^T(s*q), -X^T(s*p))."""
    with strict_fp32():
        p, q = x @ u, x @ v
        sq, sp = lbh_chain_ref(p, q, r)
        return -(sq @ x), -(sp @ x)


def lbh_chain_bound(p, q, r):
    """Per-element float32 rounding bounds of (s*q, s*p) between two
    evaluations of the chain on the same p, q, r.

    The m-term sum R b may run in any order: (m + 8)·2^-23·Σ_j |R_ij b_j|,
    the 8 covering a few ulp of tanh difference in each b_j; 1 - b_i^2
    then moves by at most 12·2^-23 absolute (through b_i), and each of the
    two products adds 2^-23 of its result.
    """
    m = p.shape[0]
    eps = 2.0 ** -23
    b = torch.tanh(0.5 * p * q)
    with strict_fp32():
        a = r.abs() @ b.abs()
        rb = (r @ b).abs()
    err_s = eps * ((m + 8) * a * (1.0 - b * b) + 12 * rb
                   + 2 * rb * (1.0 - b * b))
    s = rb * (1.0 - b * b)
    return (err_s * q.abs() + eps * (s * q).abs(),
            err_s * p.abs() + eps * (s * p).abs())


def hamming_distance_ref(codes, query):
    """(n,) int32 Hamming distances between packed rows and one query."""
    return hamming_packed(codes, query[None, :])


def sign_flip_ratios(x, factors, codes_a, codes_b) -> torch.Tensor:
    """How close to the sign boundary every differing hash bit sits.

    codes_a, codes_b: (G, n, W) int32 codes of x under the G tables whose
    (u, v) factor pairs are ``factors``.  For each bit where they differ
    (table g, row i, column c) the plain projections p = x_i . u_c and
    q = x_i . v_c are recomputed in float32 with their rounding bounds
    (d + 8)·2^-23·Σ_j |x_ij u_jc| (likewise for v): d terms of
    reduction-order rounding plus a few ulp of generator difference per
    factor.  Returns min(|p| / bound_p, |q| / bound_q) per differing bit;
    a bit may differ only where this is <= 1.
    """
    d = x.shape[1]
    diff = torch.bitwise_xor(codes_a, codes_b)
    where = diff.nonzero()                                  # (m, 3)
    words = diff[where[:, 0], where[:, 1], where[:, 2]]
    bits = (words[:, None] >> torch.arange(32, device=x.device)) & 1
    e, j = bits.nonzero(as_tuple=True)
    g, rows = where[e, 0], where[e, 1]
    cols = where[e, 2] * 32 + j
    ratios = torch.empty(e.shape[0], dtype=torch.float32, device=x.device)
    scale = (d + 8) * 2.0 ** -23
    for gi in torch.unique(g).tolist():
        sel = g == gi
        xr = x[rows[sel]]
        r = None
        for f in factors[gi]:
            terms = xr * f[:, cols[sel]].T                  # (m_g, d)
            ratio = terms.sum(dim=1).abs() / (scale * terms.abs().sum(dim=1))
            r = ratio if r is None else torch.minimum(r, ratio)
        ratios[sel] = r
    return ratios


def row_margins_limit(x, w, rows, valid, *, delta=None, split=None):
    """The exact margins of ``kernels.margins.row_margins``' slots and the
    limit a float32 evaluation of them is held to: (limit, margins), both
    (B, C) float64; an invalid slot's margin +inf and its limit 0.  delta
    and split as the kernel takes them.

    limit = 4 u sqrt(d) (rms + m), u = 2^-24, rms = sqrt(sum_j (x_j
    w_j)^2) / ||w||, m the margin.  A float32 sum of d terms that adds
    them one after another (the order with the largest error) errs by
    about u sqrt(d / 6) rms, so any float32 order lies some ten of its
    standard deviations inside; the m term covers ||w||'s rounding.  A
    product in TF32 or bf16 errs by ~2^-11 or ~2^-8 of rms, and a lost
    partial by a share of m: at d 26,215 a typical slot's TF32 error is
    about 2.5 times the limit, at d 385 some 30 times
    (``row_margins_lossy``)."""
    d = x.shape[1]
    nw = torch.linalg.vector_norm(w.double(), dim=1)
    limit, margins = [], []
    for q in range(rows.shape[0]):
        r = torch.where(valid[q], rows[q], 0)
        cx = x[r.clamp(max=x.shape[0] - 1)]
        if delta is not None:
            cd = delta[(r - split).clamp(0, delta.shape[0] - 1)]
            cx = torch.where((r < split)[:, None], cx, cd)
        t = cx.double() * w[q].double()
        m = t.sum(-1).abs() / nw[q]
        rms = t.square().sum(-1).sqrt() / nw[q]
        limit.append(torch.where(valid[q], 4 * 2.0 ** -24 * d ** 0.5
                                 * (rms + m), 0.0))
        margins.append(torch.where(valid[q], m, torch.inf))
    return torch.stack(limit), torch.stack(margins)


def row_margins_lossy(x, w, kind: str):
    """Inputs on which the exact kernel gives what a faulty one would give
    on x, w: ``tf32`` and ``bf16`` round both to that format (a product
    in it, summed in float32); ``lost_partial`` zeroes the terms of one
    row's first warp (d > 4,096: eight warps a row) or of its lane 0 (one
    warp a row), as a sum that dropped that partial."""
    if kind == "bf16":
        return x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
    if kind == "tf32":
        def tf32(t):      # round to nearest even at 10 mantissa bits
            i = t.contiguous().view(torch.int32)
            return ((i + 0x0FFF + ((i >> 13) & 1)) & -0x2000).view(
                torch.float32)
        return tf32(x), tf32(w)
    if kind != "lost_partial":
        raise ValueError(f"unknown kind {kind!r}")
    from repro_torch.kernels import contracts
    d = x.shape[1]
    j = torch.arange(d, device=x.device)
    lost = (j % 32 == 0 if d <= contracts.MARGINS_NARROW_MAX
            else j % (32 * contracts.MARGINS_WIDE_WARPS) < 32)
    x = x.clone()
    x[:, lost] = 0.0
    return x, w
