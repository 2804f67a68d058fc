"""Public wrappers around the kernels: input normalisation, block geometry
and the second-stage merge.  The device of the tensors picks the route:
CUDA tensors launch the hand-written kernels, CPU tensors take their plain
versions; the merge is the same PyTorch code on both.
"""
from __future__ import annotations

import torch

from repro_torch.core.functions import strict_fp32
from repro_torch.core.search import (DIST_SENTINEL, _pad_topk,
                                     env_cand_pack, env_fused_select,
                                     lex_smallest)
from repro_torch.kernels import _build
from repro_torch.kernels import bilinear_hash as _bh
from repro_torch.kernels import hamming as _hm
from repro_torch.kernels import lbh_grad as _lbh
from repro_torch.kernels.bilinear_hash import \
    bilinear_hash_seeded as _bilinear_hash_seeded
from repro_torch.kernels.hamming import (cand_encoding, hamming_distance,
                                         hamming_distance_batch,
                                         hamming_topk_fused,
                                         hamming_topk_hist,
                                         hamming_topk_hist_dma)

SUBLANE = 8   # row-block sizes are multiples of 8, as in the JAX package


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _block_rows(n: int, block_n: int) -> int:
    """Row-block size for an n-row scan: at most block_n, at least
    min(n, 256), rounded up to a multiple of 8 (the JAX package's
    geometry, so block-local outputs line up with its kernel's)."""
    bn = min(block_n, max(256, n))
    return -(-bn // SUBLANE) * SUBLANE


def load_libraries() -> None:
    """Build every kernel library not built yet (one nvcc per source, all
    started together) and load it, so that no first use falls inside a
    caller's deadline.  Raises as a failed build does."""
    libs = {_bh.LIBRARY: _bh._SIGNATURES,
            _bh.FACTORS_LIBRARY: _bh._FACTORS_SIGNATURES,
            _lbh.LIBRARY: _lbh._SIGNATURES, **_hm._SIGNATURES}
    _build.build(list(libs))
    for name, signatures in libs.items():
        _build.load(name, signatures)


def bilinear_hash(x, u, v) -> torch.Tensor:
    """Packed BH/LBH codes from materialised factors.

    x: (n, d); u, v: (d, k).  Returns (n, ceil(k/32)) int32 carrying
    uint32 bits, pad bits past k set to 0: the JAX wrapper's output
    without its block padding (the kernel takes any n, d, k).
    """
    return _bh.bilinear_hash(_f32(x), _f32(u), _f32(v))


def bilinear_hash_seeded_grouped(x, seeds, k: int) -> torch.Tensor:
    """Packed seed-generated BH codes for G tables in one launch.

    x: (n, d) shared by all tables; seeds: G uint32 seeds (python ints or a
    1-D tensor).  Returns (G, n, ceil(k/32)) int32 carrying uint32 bits;
    the bits past k are 0 (the kernel masks them, the plain version packs
    only k signs).
    """
    if torch.is_tensor(seeds):
        seeds = seeds.tolist()
    return _bilinear_hash_seeded(_f32(x), [int(s) for s in seeds], k)


def bilinear_hash_seeded(x, seed, k: int) -> torch.Tensor:
    """Single-table seed-generated hash: (n, ceil(k/32)) int32 codes
    carrying uint32 bits, group 0 of ``bilinear_hash_seeded_grouped`` with
    the one seed."""
    return bilinear_hash_seeded_grouped(x, [int(seed)], k)[0]


def hamming_distances(codes, query, *, block_n: int = 2048):
    """(n,) int32 Hamming distances between packed code rows codes (n, W)
    int32 and one packed query (W,).  Any n: the kernel masks the tail, so
    nothing is padded; block_n is the JAX signature's and changes nothing
    here (the kernel's blocks are 256 rows)."""
    return hamming_distance(codes.contiguous(), query.contiguous())


def hamming_distances_batch(codes, queries, *, block_n: int = 2048):
    """(B, n) int32 Hamming distances between one code table codes (n, W)
    int32 and B packed queries (B, W), row b for query b; the kernel writes
    this layout itself.  block_n as in ``hamming_distances``."""
    return hamming_distance_batch(codes.contiguous(), queries.contiguous())


def hamming_topk_grouped(codes, queries, l: int, *, block_n: int = 4096,
                         select: str | None = None, dma: bool = False,
                         active=None, pack: str | None = None):
    """Fused smallest-l scan over G stacked code groups, one kernel launch.

    codes: (G, n, W) int32 — G sub-tables over the same row space;
    queries: (G, B, W) int32 — group g's queries meet group g's codes only.
    Returns (dists (G, B, l), ids (G, B, l)) int32 sorted ascending by
    (distance, id), ties to the lowest id; slots with no live row carry
    (DIST_SENTINEL, -1).  active: optional (n,) bool liveness shared by all
    groups.  pack: the kernel's candidate emission width (``"16"``,
    ``"8"``, ``"none"``; None reads REPRO_CAND_PACK); every pack is
    bit-identical after the merge.  select: ``"hist"`` (histogram select,
    ``hamming_topk_hist``) or ``"argmin"`` (the JAX package's l rounds of
    masked argmin, here the same select emitted in distance order,
    ``hamming_topk_fused``); None reads REPRO_FUSED_SELECT.  dma=True routes
    the hist select through the pipelined kernel
    (``hamming_topk_hist_dma``); argmin ignores it, as in the JAX package.
    All are bit-identical after the merge.
    """
    if env_fused_select(select) == "argmin":
        scan = hamming_topk_fused
    else:
        scan = hamming_topk_hist_dma if dma else hamming_topk_hist
    pack = env_cand_pack(pack)
    g, n, w = codes.shape
    b = queries.shape[1]
    bn = _block_rows(n, block_n)
    l_k = min(l, bn)    # a block holds bn rows; l_k = bn already emits all
    act = None if active is None else active.to(torch.int32).contiguous()
    cd, ci = scan(codes.contiguous(), queries.contiguous(), l_k, bn, act,
                  pack)
    grid_n = cd.shape[1]
    # widen: the pack sentinel maps back to DIST_SENTINEL (real distances
    # sit strictly below it — cand_encoding guards) and block-local ids get
    # their block's base.  Sentinel slots keep a garbage id until the
    # final where() turns it into -1.
    _, _, d_sent = cand_encoding(pack, w, bn)
    cd = cd.to(torch.int32)
    cd = torch.where(cd == d_sent, DIST_SENTINEL, cd)
    base = torch.arange(grid_n, dtype=torch.int32, device=codes.device) * bn
    ci = ci.to(torch.int32) + base.view(1, grid_n, 1, 1)
    # second-stage merge over grid·l_k candidates per (group, query):
    # lexicographic (distance, id), exactly the order of a full top-l
    cd = cd.permute(0, 2, 1, 3).reshape(g, b, grid_n * l_k)
    ci = ci.permute(0, 2, 1, 3).reshape(g, b, grid_n * l_k)
    cd, ci = _pad_topk(*lex_smallest(cd, ci, l), l)
    return cd, torch.where(cd >= DIST_SENTINEL, -1, ci)


def hamming_topk(codes, query, l: int, *, block_n: int = 4096,
                 select: str | None = None, pack: str | None = None):
    """Smallest-l Hamming matches of one query: (dists (l,), ids (l,)),
    through the fused scan (G = B = 1); ties to the lowest id, slots past
    n carry (DIST_SENTINEL, -1).  codes: (n, W) int32; query: (W,)."""
    d, i = hamming_topk_grouped(codes[None], query[None, None, :], l,
                                block_n=block_n, select=select, pack=pack)
    return d[0, 0], i[0, 0]


def hamming_topk_batch(codes, queries, l: int, *, block_n: int = 4096,
                       select: str | None = None, pack: str | None = None):
    """Smallest-l matches for B queries over one code table (G = 1):
    (dists (B, l), ids (B, l))."""
    d, i = hamming_topk_grouped(codes[None], queries[None], l,
                                block_n=block_n, select=select, pack=pack)
    return d[0], i[0]


def lbh_chain(p, q, r):
    """(s*q, s*p) of the fused LBH chain; any m (no padding)."""
    return _lbh.lbh_chain(_f32(p), _f32(q), _f32(r))


def lbh_grad(x, u, v, r):
    """Full eq.-18 gradient (-X^T(s*q), -X^T(s*p)) with the fused chain in
    the middle; the two projections and the two X^T products are
    strict-fp32 matmuls, as the JAX package leaves them to XLA."""
    with strict_fp32():
        p, q = x @ u, x @ v
        sq, sp = lbh_chain(p, q, r)
        return -(sq @ x), -(sp @ x)
