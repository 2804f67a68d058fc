"""Plain reference of a multi-table seeded-BH hyperplane query over rows
held as shards, one shard a device.

The semantics of ``hyperplane.HyperplaneReference`` over the
concatenation of the shards' valid rows (a row's id is its place there):
each table's l rows smallest in (distance, id), their union, and the
least margin, ties to the lowest id, in float64 (the reference) or TF32
(the control).  Shard s holds rows [s R, s R + its valid rows); each
shard's codes are worked out on its own device, in chunks of
``hyperplane.CHUNK_BYTES``, by a ``HyperplaneReference`` over its rows, and
a row's margin on the device that holds it.  A table's top-l is found
from the shards' counts of each distance (the l-th row's distance, and
how many rows at it the top-l takes, lowest ids first), so no device
holds a key for every row.  It imports nothing of the program under
test.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.hyperplane import (CHUNK_BYTES, PRECISIONS,
                                            HyperplaneReference, _operand)

_KEY_SHIFT = 32
QUERY_CHUNK = 8     # queries whose distances a shard works out together


class MeshHyperplaneReference:
    """The answers of a multi-table seeded-BH index over sharded rows.

    parts: (R, d) float32 rows a shard, each on its device; n: the true
    row count (rows from n on are padding); seeds: the tables' 32-bit
    seeds; k: bits a table."""

    def __init__(self, parts, n: int, seeds, k: int,
                 precision: str = "float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{precision!r}")
        rows = parts[0].shape[0]
        self.n, self.rows, self.k = int(n), rows, int(k)
        self.tables = len(seeds)
        self.precision = precision
        self.device = parts[0].device
        # (first id, reference over the shard's valid rows)
        self.shards = []
        for s, x in enumerate(parts):
            valid = min(max(self.n - s * rows, 0), rows)
            if valid:
                self.shards.append((s * rows, HyperplaneReference(
                    x[:valid], seeds, k, precision)))

    def table_topl(self, w: torch.Tensor, l: int) -> torch.Tensor:
        """(L, Q, l) int64 ids of each table's l rows smallest in
        (distance, id), -1 past the rows, sorted that way.  For each query
        and table: each shard's distances and their counts; from the
        summed counts the distance D of the l-th row and how many rows at
        D it takes; then every row below D and the lowest-id rows at D,
        shard after shard.  The queries go QUERY_CHUNK at a time, each
        shard's work on its own device, and the host waits once a shard
        for a chunk's counts."""
        q = w.shape[0]
        wsig = self.shards[0][1].signs(w)       # (L, Q, k), on shard 0
        out = torch.full((self.tables, q, l), -1, dtype=torch.int64,
                         device=self.device)
        l_k = min(l, self.n)
        bins = self.k + 1
        for t in range(self.tables):
            for q0 in range(0, q, QUERY_CHUNK):
                qc = min(QUERY_CHUNK, q - q0)
                dists, counts = [], []
                for _, ref in self.shards:
                    ws = wsig[t, q0:q0 + qc].to(ref.device)
                    agree = ((self.k + ws @ ref.row_signs[t].T) / 2).to(
                        torch.int16)                # (qc, rows)
                    dists.append(agree)
                    off = (torch.arange(qc, dtype=torch.int16,
                                        device=ref.device) * bins)[:, None]
                    counts.append(torch.bincount(
                        (agree + off).flatten(), minlength=qc * bins
                    ).view(qc, bins).cpu().numpy())
                for j in range(qc):
                    total = sum(c[j] for c in counts)
                    cut = int(np.searchsorted(np.cumsum(total), l_k))
                    ties = l_k - int(total[:cut].sum())
                    keys = []
                    for (first, ref), agree, c in zip(self.shards, dists,
                                                      counts):
                        at = min(ties, int(c[j, cut]))
                        ties -= at
                        a = agree[j]
                        rows = torch.cat([
                            torch.nonzero_static(a < cut, size=int(
                                c[j, :cut].sum()))[:, 0],
                            torch.nonzero_static(a == cut, size=at)[:, 0]])
                        keys.append(((a[rows].to(torch.int64) << _KEY_SHIFT)
                                     + rows + first).to(self.device))
                    key = torch.sort(torch.cat(keys)).values
                    out[t, q0 + j, :l_k] = key & ((1 << _KEY_SHIFT) - 1)
        return out

    def unions(self, w: torch.Tensor, l: int) -> list[np.ndarray]:
        """Each query's candidates: the sorted union of its tables'
        ``table_topl`` ids."""
        top = self.table_topl(w, l).permute(1, 0, 2).reshape(w.shape[0], -1)
        return [torch.unique(r[r >= 0]).cpu().numpy() for r in top]

    def margins(self, w: torch.Tensor, ids) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
        """(margins, scales), each (Q, C) float64 on the first shard's
        device: |w_q.x| / ||w_q|| of rows ``ids`` (Q, C) and the rounding
        scale sum_i |w_qi x_i| / ||w_q||, computed in this reference's
        precision, each row's on the device that holds it.  ids must be
        rows (0 <= id < n)."""
        ids = torch.as_tensor(np.asarray(ids, np.int64)).to(self.device)
        m_out = torch.full(ids.shape, torch.nan, dtype=torch.float64,
                           device=self.device)
        s_out = m_out.clone()
        for first, ref in self.shards:
            inside = (ids >= first) & (ids < first + ref.x.shape[0])
            qi, ci = inside.nonzero(as_tuple=True)
            if qi.numel() == 0:
                continue
            m, s = _pair_margins(ref, w.to(ref.device), qi.to(ref.device),
                                 (ids[qi, ci] - first).to(ref.device))
            m_out[qi, ci] = m.to(self.device, torch.float64)
            s_out[qi, ci] = s.to(self.device, torch.float64)
        return m_out, s_out

    def answer(self, w: torch.Tensor, l: int):
        """What an index computed in this precision answers: (ids (Q,),
        margins (Q,) float32, unions), the least margin over each union,
        ties to the lowest id; id -1 and margin +inf for an empty union.
        Run at ``"tf32"`` this is the control that takes the program's
        place."""
        unions = self.unions(w, l)
        ids = np.full(len(unions), -1, np.int64)
        margins = np.full(len(unions), np.inf, np.float32)
        for qi, u in enumerate(unions):
            if u.size == 0:
                continue
            m, _ = self.margins(w[qi:qi + 1], u[None, :])
            j = int(torch.argmin(m[0]).item())
            ids[qi] = u[j]
            margins[qi] = float(m[0, j])
        return ids, margins, unions


def _pair_margins(ref, w: torch.Tensor, qi: torch.Tensor,
                  rows: torch.Tensor):
    """(margins, scales) (E,) of row rows[e] of ``ref``'s rows against
    normal w[qi[e]], in ``ref``'s precision: ``HyperplaneReference.
    margins``' arithmetic, pair by pair, in chunks of CHUNK_BYTES."""
    d = ref.x.shape[1]
    step = max(1, CHUNK_BYTES // (max(d, 1) * 8))
    m_out, s_out = [], []
    for s in range(0, rows.shape[0], step):
        wc = _operand(w[qi[s:s + step]], ref.precision)
        xc = _operand(ref.x[rows[s:s + step]], ref.precision)
        prod = xc * wc
        norm = torch.linalg.vector_norm(wc, dim=1)
        m_out.append(prod.sum(-1).abs() / norm)
        s_out.append(prod.abs().sum(-1) / norm)
    return torch.cat(m_out), torch.cat(s_out)
