"""Bilinear hyperplane hash families (paper §3) in PyTorch.

Same conventions as the JAX package: ``hash_database(X)`` codes database
points, ``hash_query(W)`` codes hyperplane normals with the query-side
flip h(P_w) = -h(w); signs are int8 in {-1, +1} with sgn(0) = +1.

BH-Hash (the paper's contribution, eq. 6/7):
    h(z) = sgn(u^T z z^T v) = sgn((u.z)(v.z))

A SeededBHHash is built from its 32-bit seed through the counter-based
generator below; BHHash and LBHHash take their factors as given tensors
(LBH factors are learned by ``core.learning.learn_lbh``).  The AH and EH
baselines draw from an explicit ``torch.Generator``: jax.random streams
cannot be replayed in torch, so a family drawn by the JAX package is
carried in (``repro_torch.interop``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.utils.bits import flip_packed, pack_signs
from repro_torch.utils.device import resolve_device


def _sgn(x: torch.Tensor) -> torch.Tensor:
    """sign with sgn(0) = +1, as int8."""
    return torch.where(x >= 0, 1, -1).to(torch.int8)


@contextlib.contextmanager
def strict_fp32():
    """Run CUDA float32 matmuls in full IEEE float32 (TF32 off), restoring
    the caller's setting afterwards: TF32 keeps ~10 mantissa bits and
    would flip hash bits far from the sign boundary."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Seed-generated projections: deterministic counter-based N(0, 1)
# ---------------------------------------------------------------------------
#
# The generator is the JAX package's, bit-exact in its integer stream: a
# murmur3 finalizer chain over absolute (row, col) indices, then one
# Box-Muller branch.  The uint32 values are held zero-extended in int64 and
# every multiply by a 32-bit constant is split into 16-bit halves, so no
# product leaves the int64 range (a plain int64 product of two uint32 values
# can overflow).  The float tail uses torch's float32 log/cos, which differ
# from XLA's by a few ulp: the integer stream is exact, the Gaussians agree
# within a stated ulp bound.

_GOLD = 0x9E3779B9       # 2^32 / golden ratio — per-matrix seed spacing
_FNV = 0x01000193        # FNV prime — decorrelates the row counter pre-mix
_M32 = 0xFFFFFFFF
TWO_PI_F32 = 6.2831854820251465   # float32(2*pi), the kernels' constant


def _mul32(h, c: int):
    """(h * c) mod 2^32 for h in [0, 2^32) held in int64 (or a python int)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """murmur3 32-bit finalizer on zero-extended uint32 values (int64 tensor
    or python int); returns values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def seeded_bits(seed: int, tag: int, rows: torch.Tensor, cols: torch.Tensor):
    """The two uint32 streams (b1, b2) behind ``seeded_gaussian`` as int64
    tensors in [0, 2^32): the part of the generator that is bit-exact."""
    s = _fmix32((int(seed) + tag * _GOLD) & _M32)
    rows = rows.to(torch.int64)
    cols = cols.to(torch.int64)
    h = _fmix32(s ^ _mul32(rows, _FNV))
    h = _fmix32(h ^ cols)
    return _fmix32(h ^ 0x632BE59B), _fmix32(h ^ 0x2545F491)


def table_seed(seed: int, t: int) -> int:
    """The 32-bit seed of table t of an index built with ``seed``."""
    return _fmix32((_fmix32(int(seed) & _M32) + t) & _M32)


def seeded_gaussian(seed: int, tag: int, rows: torch.Tensor,
                    cols: torch.Tensor) -> torch.Tensor:
    """Deterministic N(0, 1) float32 values at absolute (row, col) positions.

    seed: uint32 python int; tag: which matrix of the family (0 = U, 1 = V);
    rows/cols: broadcastable integer index tensors.  Uniforms are mapped to
    (0, 1) as (bits>>8 + 0.5) * 2^-24 in float32, so log never sees 0.
    """
    b1, b2 = seeded_bits(seed, tag, rows, cols)
    scale = 2.0 ** -24
    u1 = ((b1 >> 8).to(torch.float32) + 0.5) * scale
    u2 = ((b2 >> 8).to(torch.float32) + 0.5) * scale
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(TWO_PI_F32 * u2)


def seeded_projections(seed: int, d: int, k: int, device="cpu"):
    """The (d, k) float32 U, V factors a seed denotes — the values the CUDA
    kernel regenerates tile by tile from the same arithmetic."""
    rows = torch.arange(d, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(k, dtype=torch.int64, device=device)[None, :]
    return (seeded_gaussian(seed, 0, rows, cols),
            seeded_gaussian(seed, 1, rows, cols))


def bilinear_signs(x: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """sgn((X u_j)(X v_j)) for each point/bit.  x: (n, d); u, v: (d, k)."""
    with strict_fp32():
        return _sgn((x @ u) * (x @ v))


# ---------------------------------------------------------------------------
# BH-Hash (bilinear, eq. 6) and its seeded / learned variants
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BHHash:
    """Randomized Bilinear-Hyperplane Hash family B (eq. 7), from given
    (d, k) float32 factors."""

    u: torch.Tensor  # (d, k)
    v: torch.Tensor  # (d, k)

    @property
    def k(self) -> int:
        return self.u.shape[1]

    @property
    def device(self) -> torch.device:
        return self.u.device

    def signs_database(self, x):
        return bilinear_signs(x, self.u, self.v)

    def signs_query(self, w):
        return -bilinear_signs(w, self.u, self.v)  # h(P_w) = -h(w)

    def hash_database(self, x):
        return pack_signs(self.signs_database(x))

    def hash_query(self, w):
        return pack_signs(self.signs_query(w))


@dataclasses.dataclass(frozen=True)
class SeededBHHash(BHHash):
    """BH family whose factors are generated from a 32-bit seed.

    u/v are materialised once (2·d·k floats) so the plain paths and the
    probe tables work unchanged; the kernel path regenerates them on the
    card from ``seed`` and never reads them.
    """

    seed: int = 0

    @classmethod
    def create(cls, seed: int, d: int, k: int,
               device="cuda") -> "SeededBHHash":
        seed = int(seed) & _M32
        u, v = seeded_projections(seed, d, k, resolve_device(device))
        return cls(u, v, seed)


@dataclasses.dataclass(frozen=True)
class LBHHash(BHHash):
    """Compact learned bilinear hashing (paper §4).

    Identical evaluation path to BHHash; only the factors differ (learned
    by ``repro_torch.core.learning.learn_lbh``)."""


def _normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    """N(0, 1) float32 draws from ``generator`` (a CPU generator, so a
    seed gives the same values whatever the device), moved to device."""
    return torch.randn(shape, generator=generator).to(device)


# ---------------------------------------------------------------------------
# AH-Hash (Jain et al. 2010; eq. 2) — baseline
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AHHash:
    """Angle-Hyperplane Hash: two bits per (u, v) pair.

    k is the *total* number of bits and must be even; there are k/2
    (u, v) pairs.  The paper uses 2x the bits of BH/EH for fairness.
    """

    u: torch.Tensor  # (d, k//2)
    v: torch.Tensor  # (d, k//2)

    @classmethod
    def create(cls, generator: torch.Generator, d: int, k: int,
               device="cuda") -> "AHHash":
        if k % 2:
            raise ValueError(f"AH-Hash emits bit pairs; k must be even, "
                             f"got {k}")
        dev = resolve_device(device)
        return cls(_normal(generator, (d, k // 2), dev),
                   _normal(generator, (d, k // 2), dev))

    @property
    def k(self) -> int:
        return 2 * self.u.shape[1]

    @property
    def device(self) -> torch.device:
        return self.u.device

    @staticmethod
    def _interleave(a, b):
        # [sgn(u1.z), sgn(v1.z), sgn(u2.z), ...] per the 2-bit structure
        return torch.stack([a, b], dim=-1).reshape(a.shape[0], -1)

    def signs_database(self, z):
        with strict_fp32():
            return self._interleave(_sgn(z @ self.u), _sgn(z @ self.v))

    def signs_query(self, w):
        with strict_fp32():
            return self._interleave(_sgn(w @ self.u), _sgn(-(w @ self.v)))

    def hash_database(self, z):
        return pack_signs(self.signs_database(z))

    def hash_query(self, w):
        return pack_signs(self.signs_query(w))


# ---------------------------------------------------------------------------
# EH-Hash (Jain et al. 2010; eq. 4) — baseline
# ---------------------------------------------------------------------------

# Rows of z evaluated at once by EHHash: bounds the (rows, d) intermediate
# of each projection (the JAX package's one einsum would hold n·k·d floats,
# 32 GB at n = 1.06M).
EH_ROW_CHUNK = 65536


@dataclasses.dataclass(frozen=True)
class EHHash:
    """Embedding-Hyperplane Hash: sgn(U . vec(z z^T)).

    Each of the k projections is kept as a d x d matrix M_j and evaluated
    as z^T M_j z, the same inner product without the d^2 embedding.
    ``dims`` is the paper's dimension-sampling speed-up: project onto a
    random subset of coordinates first.
    """

    mats: torch.Tensor  # (k, d_eff, d_eff)
    dims: torch.Tensor | None = None  # optional (d_sub,) sampled coordinates

    @classmethod
    def create(cls, generator: torch.Generator, d: int, k: int,
               sample_dims: int | None = None, device="cuda") -> "EHHash":
        dev = resolve_device(device)
        d_eff = sample_dims or d
        mats = _normal(generator, (k, d_eff, d_eff), dev)
        dims = None
        if sample_dims is not None:
            dims = torch.randperm(d, generator=generator)[:sample_dims].to(
                dev)
        return cls(mats, dims)

    @property
    def k(self) -> int:
        return self.mats.shape[0]

    @property
    def device(self) -> torch.device:
        return self.mats.device

    def _scores(self, z):
        """(n, k) float32 z^T M_j z, one projection and one row chunk at a
        time."""
        if self.dims is not None:
            z = z[:, self.dims]
        out = torch.empty((z.shape[0], self.k), dtype=torch.float32,
                          device=z.device)
        with strict_fp32():
            for s in range(0, z.shape[0], EH_ROW_CHUNK):
                zc = z[s:s + EH_ROW_CHUNK]
                for j in range(self.k):
                    out[s:s + EH_ROW_CHUNK, j] = ((zc @ self.mats[j])
                                                  * zc).sum(dim=1)
        return out

    def signs_database(self, z):
        return _sgn(self._scores(z))

    def signs_query(self, w):
        return _sgn(-self._scores(w))

    def hash_database(self, z):
        return pack_signs(self.signs_database(z))

    def hash_query(self, w):
        return pack_signs(self.signs_query(w))


FAMILIES = {"ah": AHHash, "eh": EHHash, "bh": BHHash, "lbh": LBHHash}


def query_lookup_code(family, w):
    """Packed code to *look up* in a table built from hash_database codes
    (the query-side code already includes the sign flip)."""
    return family.hash_query(w)


def flip_database_code(packed, k: int):
    """Equivalent formulation of the paper's step (1): bitwise NOT of H(w)
    computed database-style."""
    return flip_packed(packed, k)
