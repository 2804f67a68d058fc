"""A frozen copy of the seeded-BH projection generator.

A seeded bilinear-hash table denotes its (d, k) factors U, V by a 32-bit
seed: entry (row, col) of U (tag 0) or V (tag 1) is a Box-Muller normal of
two uint32 values from a murmur3 finalizer chain over the absolute
(row, col) position.  Table t of an index built with seed s has the seed
``table_seed(s, t)``.  The integer stream is exact; the float tail is
float32 log / sqrt / cos, as the hashing kernel computes it.

uint32 values are held zero-extended in int64, and every multiply by a
32-bit constant is split into 16-bit halves, so no product leaves int64.
"""
from __future__ import annotations

import torch

GOLD = 0x9E3779B9       # per-matrix seed spacing
FNV = 0x01000193        # decorrelates the row counter
M32 = 0xFFFFFFFF
TWO_PI_F32 = 6.2831854820251465   # float32(2 pi)


def mul32(h, c: int):
    """(h * c) mod 2^32 for h in [0, 2^32) (int64 tensor or int)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & M32


def fmix32(h):
    """murmur3's 32-bit finalizer."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def table_seed(seed: int, t: int) -> int:
    """The 32-bit seed of table t of an index built with ``seed``."""
    return fmix32((fmix32(int(seed) & M32) + t) & M32)


def gaussian(seed: int, tag: int, rows: torch.Tensor,
             cols: torch.Tensor) -> torch.Tensor:
    """N(0, 1) float32 values at absolute (row, col) positions of matrix
    ``tag`` (0 = U, 1 = V) of the table with 32-bit ``seed``."""
    s = fmix32((int(seed) + tag * GOLD) & M32)
    h = fmix32(s ^ mul32(rows.to(torch.int64), FNV))
    h = fmix32(h ^ cols.to(torch.int64))
    b1, b2 = fmix32(h ^ 0x632BE59B), fmix32(h ^ 0x2545F491)
    scale = 2.0 ** -24
    u1 = ((b1 >> 8).to(torch.float32) + 0.5) * scale
    u2 = ((b2 >> 8).to(torch.float32) + 0.5) * scale
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI_F32 * u2)


def factors(seed: int, d: int, k: int, device) -> tuple:
    """The (d, k) float32 U, V of the table with 32-bit ``seed``."""
    rows = torch.arange(d, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(k, dtype=torch.int64, device=device)[None, :]
    return gaussian(seed, 0, rows, cols), gaussian(seed, 1, rows, cols)
