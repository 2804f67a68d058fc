"""Device-side Hamming search and exact-margin re-rank, single device.

Plain PyTorch: these functions run on whatever device their tensors live
on and launch no hand-written kernel (the fused scan kernel is reached
through ``repro_torch.kernels.ops``).  The sharded scan of the JAX package
(``shard_map``, ``mesh=``) is not ported in this slice.

Tie contract shared with the JAX package: top-l by (distance, id)
ascending, ties to the lowest id, impossible slots (l > n, masked rows)
as (DIST_SENTINEL, -1).  ``jax.lax.top_k`` breaks ties to the lowest
index and ``torch.topk`` promises no order, so every selection here is a
stable ``torch.sort`` or a sort on a unique composite key.
"""
from __future__ import annotations

import os

import torch

from repro_torch.utils.bits import hamming_packed

# Fill distance for masked rows and impossible top-k slots (l > n): far
# above any real Hamming distance (<= 32·W) but negatable in int32.  The
# kernels' wrappers (kernels.hamming) share it.
DIST_SENTINEL = 0x3FFFFFFF


def env_fused_select(select: str | None = None) -> str:
    """Resolve the fused-scan selection algorithm: ``"hist"`` (default,
    counting-sort select) or ``"argmin"`` (the legacy selection).  Explicit
    arguments win; otherwise ``REPRO_FUSED_SELECT`` moves the default.
    Both give bit-identical results."""
    if select is not None:
        if select not in ("hist", "argmin"):
            raise ValueError(f"fused_select must be 'hist' or 'argmin', "
                             f"got {select!r}")
        return select
    env = os.environ.get("REPRO_FUSED_SELECT", "").strip().lower()
    return env if env in ("hist", "argmin") else "hist"


def env_cand_pack(pack: str | None = None) -> str:
    """Resolve the fused-scan candidate emission width: ``"16"`` (default,
    int16 pairs), ``"8"`` (uint8 distances + int16 ids, only while
    32·W < 255) or ``"none"`` (int32).  Explicit arguments win; otherwise
    ``REPRO_CAND_PACK`` moves the default.  Every pack is bit-identical
    after the widening merge."""
    if pack is not None:
        if pack not in ("none", "16", "8"):
            raise ValueError(f"cand_pack must be 'none', '16' or '8', "
                             f"got {pack!r}")
        return pack
    env = os.environ.get("REPRO_CAND_PACK", "").strip().lower()
    return env if env in ("none", "16", "8") else "16"


def _pad_topk(dists: torch.Tensor, ids: torch.Tensor, l: int):
    """Pad the trailing top-k axis out to l slots with (DIST_SENTINEL, -1)."""
    have = dists.shape[-1]
    if have >= l:
        return dists, ids
    pad = (0, l - have)
    return (torch.nn.functional.pad(dists, pad, value=DIST_SENTINEL),
            torch.nn.functional.pad(ids, pad, value=-1))


def lex_smallest(dists: torch.Tensor, ids: torch.Tensor, l: int):
    """The l smallest (distance, id) pairs along the last axis, sorted
    lexicographically.  dists in [0, DIST_SENTINEL], ids in [-1, 2^31):
    one int64 key (distance high, id + 1 low) makes the order total, so
    equal keys are equal pairs and the sort's own tie order is moot."""
    key = (dists.to(torch.int64) << 32) | (ids.to(torch.int64) + 1)
    key = torch.sort(key, dim=-1).values[..., :l]
    return (key >> 32).to(torch.int32), ((key & 0xFFFFFFFF) - 1).to(
        torch.int32)


def hamming_topk_grouped(codes, queries, l: int, select: str | None = None,
                         active=None, pack: str | None = None):
    """Grouped scan, plain PyTorch: group g's queries vs group g's codes.

    codes (G, n, W) int32, queries (G, B, W) int32 -> (dists (G, B, l),
    ids (G, B, l)) int32, sorted ascending by (distance, id); tails past
    the live rows carry (DIST_SENTINEL, -1).  active: optional (n,) bool
    liveness shared by all groups.  pack is accepted for call-site
    symmetry with the kernel path and ignored (no block emission here).
    """
    del pack
    if env_fused_select(select) == "hist":
        return hamming_topk_grouped_hist(codes, queries, l, active)
    return _grouped_topk_lax(codes, queries, l, active)


def _masked_distances(codes, queries, active):
    d = hamming_packed(codes[:, None, :, :], queries[:, :, None, :])  # G,B,n
    if active is not None:
        d = torch.where(active.to(torch.bool)[None, None, :], d,
                        DIST_SENTINEL)
    return d


def _grouped_topk_lax(codes, queries, l: int, active=None):
    """Legacy grouped selection: full distance matrix + stable sort (the
    port of the lax.top_k path; ties to the lowest index)."""
    n = codes.shape[1]
    d = _masked_distances(codes, queries, active)
    d, idx = torch.sort(d, dim=-1, stable=True)
    d, idx = d[..., :min(l, n)], idx[..., :min(l, n)].to(torch.int32)
    d, i = _pad_topk(d, idx, l)
    if active is not None:
        i = torch.where(d >= DIST_SENTINEL, -1, i)
    return d, i


def hamming_topk_grouped_hist(codes, queries, l: int, active=None):
    """Plain reference of the two-pass histogram (counting-sort) select,
    over the whole row axis at once: bisect the distance CDF to the
    per-query cutoff radius r, keep rows with d < r plus the lowest-index
    ties at r, and lex-sort only those min(l, n) survivors."""
    g, n, w = codes.shape
    b = queries.shape[1]
    dev = codes.device
    d = _masked_distances(codes, queries, active)
    t = min(l, n)
    max_dist = 32 * w
    lo = torch.zeros((g, b, 1), dtype=torch.int32, device=dev)
    hi = torch.full((g, b, 1), max_dist, dtype=torch.int32, device=dev)
    for _ in range(max(1, max_dist.bit_length())):
        mid = (lo + hi) >> 1
        ge = (d <= mid).sum(dim=2, keepdim=True) >= t
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    r = hi
    less = (d < r).sum(dim=2, keepdim=True)
    tie = d == r
    tie_rank = torch.cumsum(tie, dim=2) - 1
    keep = (d < r) | (tie & (tie_rank < (t - less)))
    # slot in [0, t) for kept rows (row order); t is the discard slot
    slot = torch.where(keep, torch.cumsum(keep, dim=2) - 1, t)
    ids = torch.arange(n, dtype=torch.int32, device=dev).expand(g, b, n)
    out_d = torch.full((g, b, t + 1), DIST_SENTINEL, dtype=torch.int32,
                       device=dev)
    out_i = torch.full((g, b, t + 1), -1, dtype=torch.int32, device=dev)
    out_d.scatter_(2, slot, d)
    out_i.scatter_(2, slot, ids)
    out_d, out_i = out_d[..., :t], out_i[..., :t]
    # rows that were never filled keep (DIST_SENTINEL, -1)
    out_d, out_i = lex_smallest(out_d, out_i, t)
    return _pad_topk(out_d, out_i, l)


def _margins(x, w_batch, rows):
    """|w.x| / ||w|| for the gathered rows: multiply + reduce over d (not a
    matmul), so a row's margin does not depend on the batch around it."""
    cx = x[rows]                                          # (B, C, d)
    m = torch.abs(torch.sum(cx * w_batch[:, None, :], dim=-1))
    return m / torch.clamp(torch.linalg.vector_norm(w_batch, dim=1,
                                                    keepdim=True), min=1e-12)


def margin_rerank_batch(x, w_batch, candidates, valid, l: int):
    """Batched exact re-rank: (margins (B, l), ids (B, l)) ascending by
    margin, ties to the lowest candidate position; invalid slots rank last
    with margin +inf and keep their padded id."""
    m = torch.where(valid, _margins(x, w_batch, candidates), torch.inf)
    m, sel = torch.sort(m, dim=1, stable=True)
    sel = sel[:, :min(l, candidates.shape[1])]
    return m[:, :sel.shape[1]], torch.gather(candidates, 1, sel)


def margin_batch(x, w_batch, candidates, valid):
    """Per-candidate exact margins with no selection: (B, C) float32,
    +inf at invalid slots (candidates there may be -1: they are clamped
    for the gather)."""
    rows = torch.clamp(candidates, 0, x.shape[0] - 1)
    return torch.where(valid, _margins(x, w_batch, rows), torch.inf)
