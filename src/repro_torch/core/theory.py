"""Closed-form collision probabilities and LSH exponents (paper §3.3, Fig. 2).

Distance measure: D(x, P_w) = alpha^2 where alpha = |theta(x, w) - pi/2|.
"r" below is a value of that squared angle, r in [0, (pi/2)^2].
"""
from __future__ import annotations

import numpy as np


def p_ah(alpha):
    """Eq. (3): Pr[h_A(w) = h_A(x)] = 1/4 - alpha^2 / pi^2."""
    alpha = np.asarray(alpha, dtype=np.float64)
    return 0.25 - alpha**2 / np.pi**2


def p_eh(alpha):
    """Eq. (5): Pr[h_E(w) = h_E(x)] = arccos(sin^2(alpha)) / pi."""
    alpha = np.asarray(alpha, dtype=np.float64)
    return np.arccos(np.clip(np.sin(alpha) ** 2, -1.0, 1.0)) / np.pi


def p_bh(alpha):
    """Lemma 1: Pr[h_B(P_w) = h_B(x)] = 1/2 - 2 alpha^2 / pi^2."""
    alpha = np.asarray(alpha, dtype=np.float64)
    return 0.5 - 2.0 * alpha**2 / np.pi**2


COLLISION = {"ah": p_ah, "eh": p_eh, "bh": p_bh}


def p1_p2(method: str, r, eps: float):
    """(p1, p2) of the (r, r(1+eps), p1, p2)-sensitive family (Thm. 1)."""
    f = COLLISION[method]
    r = np.asarray(r, dtype=np.float64)
    return f(np.sqrt(r)), f(np.sqrt(r * (1.0 + eps)))


def rho(method: str, r, eps: float = 3.0):
    """Query-time exponent rho = ln p1 / ln p2 (Thm. 2, Fig. 2b)."""
    p1, p2 = p1_p2(method, r, eps)
    return np.log(p1) / np.log(p2)


def query_cost_model(n: int, method: str, r, eps: float = 3.0):
    """Theorem 2 bookkeeping: (#tables n^rho, bits/table k = log_{1/p2} n)."""
    p1, p2 = p1_p2(method, r, eps)
    k = np.log(n) / np.log(1.0 / p2)
    tables = n ** (np.log(p1) / np.log(p2))
    return tables, k
