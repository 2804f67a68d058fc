"""Public wrappers around the kernels: input normalisation, block geometry
and the second-stage merge.  The device of the tensors picks the route:
CUDA tensors launch the hand-written kernels, CPU tensors take their plain
versions; the merge is the same PyTorch code on both.
"""
from __future__ import annotations

import torch

from repro_torch.core.search import (DIST_SENTINEL, _grouped_topk_lax,
                                     _pad_topk, env_cand_pack,
                                     env_fused_select, lex_smallest)
from repro_torch.kernels.bilinear_hash import bilinear_hash_seeded
from repro_torch.kernels.hamming import cand_encoding, hamming_topk_hist

SUBLANE = 8   # row-block sizes are multiples of 8, as in the JAX package


def _block_rows(n: int, block_n: int) -> int:
    """Row-block size for an n-row scan: at most block_n, at least
    min(n, 256), rounded up to a multiple of 8 (the JAX package's
    geometry, so block-local outputs line up with its kernel's)."""
    bn = min(block_n, max(256, n))
    return -(-bn // SUBLANE) * SUBLANE


def bilinear_hash_seeded_grouped(x, seeds, k: int) -> torch.Tensor:
    """Packed seed-generated BH codes for G tables in one launch.

    x: (n, d) shared by all tables; seeds: G uint32 seeds (python ints or a
    1-D tensor).  Returns (G, n, ceil(k/32)) int32 carrying uint32 bits;
    the bits past k are 0 (the kernel masks them, the plain version packs
    only k signs).
    """
    if torch.is_tensor(seeds):
        seeds = seeds.tolist()
    x = x.to(torch.float32).contiguous()
    return bilinear_hash_seeded(x, [int(s) for s in seeds], k)


def hamming_topk_grouped(codes, queries, l: int, *, block_n: int = 4096,
                         select: str | None = None, active=None,
                         pack: str | None = None):
    """Fused smallest-l scan over G stacked code groups, one kernel launch.

    codes: (G, n, W) int32 — G sub-tables over the same row space;
    queries: (G, B, W) int32 — group g's queries meet group g's codes only.
    Returns (dists (G, B, l), ids (G, B, l)) int32 sorted ascending by
    (distance, id), ties to the lowest id; slots with no live row carry
    (DIST_SENTINEL, -1).  active: optional (n,) bool liveness shared by all
    groups.  pack: the kernel's candidate emission width (``"16"``,
    ``"8"``, ``"none"``; None reads REPRO_CAND_PACK); every pack is
    bit-identical after the merge.

    select="argmin" (the JAX package's l-round masked-argmin kernel) is not
    ported yet: CUDA tensors raise, CPU tensors take the plain stable-sort
    selection, which the argmin kernel matches bit for bit.
    """
    select = env_fused_select(select)
    pack = env_cand_pack(pack)
    if select == "argmin":
        if codes.device.type != "cpu":
            raise NotImplementedError(
                "select='argmin' needs hamming_topk_fused_kernel, which is "
                "not ported yet (ROADMAP, queue 2); use select='hist'")
        return _grouped_topk_lax(codes, queries, l, active)
    g, n, w = codes.shape
    b = queries.shape[1]
    bn = _block_rows(n, block_n)
    l_k = min(l, bn)    # a block holds bn rows; l_k = bn already emits all
    act = None if active is None else active.to(torch.int32).contiguous()
    cd, ci = hamming_topk_hist(codes.contiguous(), queries.contiguous(), l_k,
                               bn, act, pack)
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
