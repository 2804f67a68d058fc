"""Plain oracles for the kernels, the near-zero bound that decides whether
two hash results may differ in a bit, and the rounding bound of the LBH
gradient chain."""
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
