"""The comparison that decides ``correct``: the program's answers held to
the plain reference (``perfbench.reference``), number by number, each
against its limit from the cell's file.

The numbers (the smaller the better; each is 0 for a perfect answer):

- ``unanswered``: queries of the run with no answer (an error, or an id
  outside the rows).  Exact: limit 0.
- ``margin_err``: over every answered query, |m - m64| / s, the gap of
  the margin the program reports for its answer from the float64 margin
  of the same row, in units of the rounding scale s = sum |w_i x_i| /
  ||w|| of that dot product.
- ``cand_mismatch``: over a seeded sample of queries, the share whose
  candidate set (the union of the tables' top-l) differs from the
  reference's: it holds the codes of rows and queries, each table's
  (distance, id) top-l and the union.
- ``rerank_gap``: over the sample, (m64(answer) - min over the program's
  candidates of m64) / s: how far the answer misses the least-margin
  candidate it was given.

``judge`` works out the last three; a run (``entries/``) and the control
(``tools/control.py``) both call it.
"""
from __future__ import annotations

import numpy as np
import torch

EXACT = ("unanswered",)
CHUNK = 64   # sampled queries judged together


def margin_err(ref, w: torch.Tensor, rows: torch.Tensor,
               margins: np.ndarray) -> float:
    """Max |m - m64| / s over queries w (A, d) answered with rows (A,)
    and reported margins (A,)."""
    if rows.numel() == 0:
        return 0.0
    m64, s64 = ref.margins(w, rows[:, None])
    got = torch.from_numpy(np.asarray(margins, np.float64)).to(m64.device)
    err = (got - m64[:, 0]).abs() / torch.clamp(s64[:, 0], min=1e-300)
    return float(err.max().item())


def sample_numbers(ref, w: torch.Tensor, l: int, ans_rows: torch.Tensor,
                   unions: list[np.ndarray]) -> dict:
    """``cand_mismatch`` and ``rerank_gap`` of sampled queries w (Q, d)
    whose answers are rows ans_rows (Q,) and candidate sets ``unions``."""
    want = ref.unions(w, l)
    mismatch = sum(not np.array_equal(np.unique(g), r)
                   for g, r in zip(unions, want))
    gap = 0.0
    for qi, u in enumerate(unions):
        if u.size == 0 or int(ans_rows[qi]) < 0:
            continue
        rows = torch.from_numpy(np.asarray(u, np.int64)).to(ref.device)
        both = torch.cat([ans_rows[qi:qi + 1].to(ref.device), rows])
        m64, s64 = ref.margins(w[qi:qi + 1], both[None, :])
        g = (m64[0, 0] - m64[0, 1:].min()) / torch.clamp(s64[0, 0],
                                                          min=1e-300)
        gap = max(gap, float(g.item()))
    return {"cand_mismatch": mismatch / max(len(unions), 1),
            "rerank_gap": gap}


def judge(ref, l: int, answers, sample) -> dict:
    """``margin_err`` over ``answers`` = (w (A, d), rows (A,), margins
    (A,)), and ``cand_mismatch``, ``rerank_gap`` over ``sample`` = (w (Q,
    d), rows (Q,), unions: Q arrays of candidate ids), rows on the
    reference's device."""
    w, rows, margins = answers
    out = {"margin_err": margin_err(ref, w, rows, margins)}
    w, rows, unions = sample
    mism, gap = 0.0, 0.0
    for s in range(0, len(unions), CHUNK):
        got = sample_numbers(ref, w[s:s + CHUNK], l, rows[s:s + CHUNK],
                             unions[s:s + CHUNK])
        mism += got["cand_mismatch"] * len(unions[s:s + CHUNK])
        gap = max(gap, got["rerank_gap"])
    out["cand_mismatch"] = mism / max(len(unions), 1)
    out["rerank_gap"] = gap
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit (exact ones under 0)."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = 0 if name in EXACT else limits[name]
        ok &= bool(value <= limit)
        out[name] = {"value": value, "limit": limit}
    return ok, out
