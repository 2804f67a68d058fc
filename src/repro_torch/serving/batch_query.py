"""Vectorised batched query path for the multi-table index.

1. hashing — all L tables' codes at once: seeded BH families through one
   grouped hash-kernel launch, other BH/LBH families through one stacked
   strict-fp32 ``torch.matmul`` (the work the JAX package leaves to XLA),
   AH/EH families one table at a time;
2. candidate unions and padding for the probe path (host numpy);
3. re-rank — one gather + batched reduce over the padded candidate matrix
   (core.search.margin_rerank_batch).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.functions import (BHHash, SeededBHHash, _sgn,
                                        strict_fp32)
from repro_torch.core.search import margin_rerank_batch
from repro_torch.kernels import ops
from repro_torch.utils.bits import flip_packed, pack_signs
from repro_torch.utils.device import as_float_tensor

PAD_MULTIPLE = 128  # candidate-matrix padding quantum (few distinct shapes)


def _stackable(families) -> bool:
    return (all(isinstance(f, BHHash) for f in families)
            and len({tuple(f.u.shape) for f in families}) == 1)


def _seed_stackable(families) -> bool:
    """True when every table is a SeededBHHash over the same (d, k): the
    whole list hashes through ONE grouped seeded-kernel launch."""
    return (all(type(f) is SeededBHHash for f in families)
            and len({tuple(f.u.shape) for f in families}) == 1)


def _database_codes(families, pts: torch.Tensor) -> torch.Tensor:
    """(L, n, W) database-style codes of pts for every table."""
    if _seed_stackable(families):
        return ops.bilinear_hash_seeded_grouped(
            pts, [f.seed for f in families], families[0].k)
    if _stackable(families):
        u = torch.stack([f.u for f in families])
        v = torch.stack([f.v for f in families])
        with strict_fp32():
            return pack_signs(_sgn(torch.matmul(pts, u)
                                   * torch.matmul(pts, v)))
    return torch.stack([f.hash_database(pts) for f in families])


def hash_queries_all(families, w) -> torch.Tensor:
    """Query-side codes for all tables: (L, B, W) int32 on the families'
    device.  For bilinear families the query flip h(P_w) = -h(w) is the
    packed-bit complement of the database-style code (sgn(0) = +1 pairs
    prod >= 0 with prod < 0); AH flips only its v bits and EH negates its
    scores, so other families hash their queries themselves."""
    w = as_float_tensor(w, families[0].device)
    if _stackable(families):
        return flip_packed(_database_codes(families, w), families[0].k)
    return torch.stack([f.hash_query(w) for f in families])


def hash_database_all(families, x) -> torch.Tensor:
    """Database-side codes for all tables: (L, n, W) int32 on the
    families' device."""
    return _database_codes(families, as_float_tensor(x, families[0].device))


def hash_database_here(families, x: torch.Tensor) -> torch.Tensor:
    """Database-side codes for all tables of rows x, on x's own device:
    (L, n, W) int32.  Seeded BH families only, whose factors come from
    their seeds wherever the rows are; other families raise
    NotImplementedError."""
    if not _seed_stackable(families):
        raise NotImplementedError(
            "hashing rows on their own device needs seeded BH families "
            "(method 'bh', seeded_projections=True) of one shape")
    return _database_codes(families, x)


def union_candidates(per_table: list[np.ndarray]) -> np.ndarray:
    """Union of per-table candidate id lists, first occurrence order."""
    arrs = [a for a in per_table if a.size]
    if not arrs:
        return np.empty((0,), dtype=np.int64)
    cat = np.concatenate(arrs)
    _, first = np.unique(cat, return_index=True)
    return cat[np.sort(first)]


def pad_candidates(cands: list[np.ndarray]):
    """Ragged candidate lists -> (ids (B, C), valid (B, C)) with C padded to
    PAD_MULTIPLE."""
    b = len(cands)
    cmax = max((c.size for c in cands), default=0)
    c_pad = max(PAD_MULTIPLE, -(-cmax // PAD_MULTIPLE) * PAD_MULTIPLE)
    ids = np.zeros((b, c_pad), dtype=np.int64)
    valid = np.zeros((b, c_pad), dtype=bool)
    for i, c in enumerate(cands):
        ids[i, :c.size] = c
        valid[i, :c.size] = True
    return ids, valid


def batched_rerank(x: torch.Tensor, w, cands: list[np.ndarray], l: int = 1,
                   mask=None):
    """Exact-margin re-rank of B ragged candidate lists in one device call.

    x: (n, d) database tensor; w: (B, d) normals; mask: optional (n,) bool —
    candidates outside it are ignored.  Returns (ids (B, l) int64, margins
    (B, l) float32, nonempty (B,) bool) as numpy; slots without a valid
    candidate hold id -1 / margin +inf.
    """
    ids, valid = pad_candidates(cands)
    if mask is not None:
        valid &= np.asarray(mask, bool)[ids]
    nonempty = valid.any(axis=1)
    dev = x.device
    margins, top = margin_rerank_batch(
        x, as_float_tensor(w, dev), torch.from_numpy(ids).to(dev),
        torch.from_numpy(valid).to(dev), l)
    margins = margins.cpu().numpy()
    top = top.cpu().numpy().astype(np.int64)
    top[~np.isfinite(margins)] = -1
    return top, margins, nonempty
