"""The comparison that decides ``correct`` in a cell whose rows are
sharded over several devices: the program's answers held to the plain
reference over the same shards
(``reference.hyperplane_mesh.MeshHyperplaneReference``).

The numbers of ``check`` (``unanswered``, ``margin_err``,
``cand_mismatch``, ``rerank_gap``), each worked out as there, and one
more: ``cand_id_share``, over the sampled queries, the largest share of
a query's candidate set that the program and the reference do not share,
|U xor U_ref| / |U_ref|.  At tens of millions of rows a sound run's union
misses the reference's by a row or two in most queries (float32 and
float64 split a code bit within rounding of zero, and the cutoff's ties
hold hundreds of thousands of rows), so ``cand_mismatch`` here counts
only the sampled queries whose union differs by more than UNION_SLACK of
the reference's ids: a row or two of rounding passes, a lower precision's
thousands do not.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

CHUNK = 32   # sampled queries whose unions are worked out together
# the share of a union's ids that may differ before it counts as a
# mismatch: the largest a sound run read on four H100s over ten seeds,
# 2.56e-5 (a dozen of 468,947), rounded up
UNION_SLACK = 3e-5


def margin_err(ref, w: torch.Tensor, rows: np.ndarray,
               margins: np.ndarray) -> float:
    """Max |m - m64| / s over queries w (A, d) answered with rows (A,)
    and reported margins (A,)."""
    if rows.size == 0:
        return 0.0
    m64, s64 = ref.margins(w, rows[:, None])
    got = torch.from_numpy(np.asarray(margins, np.float64)).to(m64.device)
    err = (got - m64[:, 0]).abs() / torch.clamp(s64[:, 0], min=1e-300)
    return float(err.max().item())


def _shared(a: np.ndarray, b: np.ndarray) -> int:
    """How many ids two sorted arrays of distinct ids share."""
    if a.size == 0 or b.size == 0:
        return 0
    at = np.minimum(np.searchsorted(b, a), b.size - 1)
    return int((b[at] == a).sum())


def sample_numbers(ref, w: torch.Tensor, l: int, ans: np.ndarray,
                   unions: list[np.ndarray]) -> dict:
    """``cand_mismatch``, ``cand_id_share`` and ``rerank_gap`` of sampled
    queries w (Q, d) answered with rows ans (Q,) from candidate sets
    ``unions``."""
    want = ref.unions(w, l)
    mismatch, share = 0, 0.0
    got = [np.unique(u) for u in unions]
    for g, r in zip(got, want):
        if not np.array_equal(g, r):
            diff = (g.size + r.size - 2 * _shared(g, r)) / max(r.size, 1)
            mismatch += diff > UNION_SLACK
            share = max(share, diff)
    # each answered query's answer, then its candidates, padded with the
    # answer (which moves no minimum)
    rows = [qi for qi, g in enumerate(got) if g.size and int(ans[qi]) >= 0]
    gap = 0.0
    if rows:
        width = 1 + max(got[qi].size for qi in rows)
        ids = np.empty((len(rows), width), np.int64)
        for i, qi in enumerate(rows):
            ids[i] = ans[qi]
            ids[i, 1:1 + got[qi].size] = got[qi]
        m64, s64 = ref.margins(w[torch.as_tensor(rows, device=w.device)],
                               ids)
        g = (m64[:, 0] - m64[:, 1:].min(dim=1).values) / torch.clamp(
            s64[:, 0], min=1e-300)
        gap = max(0.0, float(g.max().item()))
    return {"cand_mismatch": mismatch, "cand_id_share": share,
            "rerank_gap": gap}


def _log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def judge(ref, l: int, answers, sample, log=_log) -> dict:
    """``margin_err`` over ``answers`` = (w (A, d), rows (A,), margins
    (A,)), and the sample's numbers over ``sample`` = (w (Q, d), rows
    (Q,), unions: Q arrays of candidate ids); w on the reference's
    device, rows numpy.  ``log`` takes a line of each part's seconds."""
    w, rows, margins = answers
    t = time.perf_counter()
    out = {"margin_err": margin_err(ref, w, rows, margins)}
    log(f"check: margin_err over {rows.size} answers "
        f"{time.perf_counter() - t:.3f} s")
    w, rows, unions = sample
    mism, share, gap = 0, 0.0, 0.0
    t = time.perf_counter()
    for s in range(0, len(unions), CHUNK):
        got = sample_numbers(ref, w[s:s + CHUNK], l, rows[s:s + CHUNK],
                             unions[s:s + CHUNK])
        mism += got["cand_mismatch"]
        share = max(share, got["cand_id_share"])
        gap = max(gap, got["rerank_gap"])
    log(f"check: the sample's {len(unions)} queries "
        f"{time.perf_counter() - t:.3f} s")
    out["cand_mismatch"] = mism / max(len(unions), 1)
    out["cand_id_share"] = share
    out["rerank_gap"] = gap
    return out
