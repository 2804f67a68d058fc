"""Plain reference of a multi-table seeded-BH hyperplane query.

For a hyperplane normal w and rows x (a row's id is its position), table
t of an index with seed s answers as follows (Liu et al., ICML 2012, eq. 6-7):

1. factors U_t, V_t = ``generator.factors(table_seed(s, t), d, k)``;
2. a row's bit j is (x.u_j)(x.v_j) >= 0, the normal's likewise, and the
   query's code is the normal's code flipped, so the Hamming distance of
   row and query is the number of bits on which the row and the normal
   agree;
3. the table's candidates are the l rows smallest in (distance, id);
4. the query's candidates are the union over tables, and its answer the
   candidate of least margin |w.x| / ||w|| (ties to the lowest id).

``precision`` sets the arithmetic of the projections and margins:
``"float64"`` is the reference; ``"tf32"`` rounds every float32 operand
to TF32's 10 mantissa bits and accumulates in float32 (what a float32
matmul with TF32 on computes): the control, one precision below the
configuration's strict float32.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench.reference import generator

PRECISIONS = ("float64", "tf32")
_KEY_SHIFT = 32
CHUNK_BYTES = 1 << 28


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 explicit
    mantissa bits, ties to even); finite inputs only."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@contextlib.contextmanager
def _strict_fp32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _operand(a: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float64":
        return a.to(torch.float64)
    if precision == "tf32":
        return round_tf32(a)
    raise ValueError(f"precision must be one of {PRECISIONS}, got "
                     f"{precision!r}")


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    with _strict_fp32():
        return _operand(a, precision) @ _operand(b, precision)


def _rows_per_chunk(d: int, itemsize: int = 8) -> int:
    return max(1, CHUNK_BYTES // (max(d, 1) * itemsize))


class HyperplaneReference:
    """The answers of a multi-table seeded-BH index over rows x.

    x: (n, d) float32 rows (any device); seeds: the tables' 32-bit seeds;
    k: bits a table."""

    def __init__(self, x: torch.Tensor, seeds, k: int,
                 precision: str = "float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{precision!r}")
        self.x = x
        self.device = x.device
        self.k = int(k)
        self.tables = len(seeds)
        self.precision = precision
        self.ids = torch.arange(x.shape[0], device=self.device)
        us, vs = zip(*(generator.factors(int(s), x.shape[1], self.k,
                                         self.device) for s in seeds))
        self.u = torch.cat(us, dim=1)    # (d, L k)
        self.v = torch.cat(vs, dim=1)
        self.row_signs = self.signs(x)   # (L, n, k) float32 in {-1, +1}

    def signs(self, z: torch.Tensor) -> torch.Tensor:
        """(L, m, k) float32 signs of the database-style code of rows z:
        +1 where (z.u)(z.v) >= 0."""
        out = torch.empty((self.tables, z.shape[0], self.k),
                          dtype=torch.float32, device=self.device)
        step = _rows_per_chunk(z.shape[1])
        for s in range(0, z.shape[0], step):
            zc = z[s:s + step].to(self.device)
            prod = (matmul(zc, self.u, self.precision)
                    * matmul(zc, self.v, self.precision))
            sg = torch.where(prod >= 0, 1.0, -1.0).to(torch.float32)
            out[:, s:s + step] = sg.view(-1, self.tables, self.k
                                         ).permute(1, 0, 2)
        return out

    def table_topl(self, w: torch.Tensor, l: int,
                   chunk: int = 64) -> torch.Tensor:
        """(L, Q, l) int64 ids of each table's l rows smallest in
        (distance, id), -1 past the rows."""
        q = w.shape[0]
        wsig = self.signs(w)             # (L, Q, k)
        out = torch.full((self.tables, q, l), -1, dtype=torch.int64,
                         device=self.device)
        l_k = min(l, self.x.shape[0])
        for t in range(self.tables):
            for s in range(0, q, chunk):
                # agreements of the normal's and the row's signs: the
                # distance to the flipped query code; +-1 sums are exact
                agree = ((self.k + wsig[t, s:s + chunk]
                          @ self.row_signs[t].T) / 2).to(torch.int64)
                key = (agree << _KEY_SHIFT) + self.ids[None, :]
                top = torch.topk(key, l_k, dim=1, largest=False,
                                 sorted=True).values
                out[t, s:s + chunk, :l_k] = top & ((1 << _KEY_SHIFT) - 1)
        return out

    def unions(self, w: torch.Tensor, l: int) -> list[np.ndarray]:
        """Each query's candidates: the sorted union of its tables'
        ``table_topl`` ids."""
        top = self.table_topl(w, l).permute(1, 0, 2).reshape(
            w.shape[0], -1).cpu().numpy()
        return [np.unique(r[r >= 0]) for r in top]

    def margins(self, w: torch.Tensor, rows: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(margins, scales), each (Q, C): |w.x| / ||w|| of rows x[rows]
        and the rounding scale
        sum_i |w_i x_i| / ||w||, in this reference's precision."""
        d = self.x.shape[1]
        step = max(1, _rows_per_chunk(d) // max(rows.shape[1], 1))
        m_out, s_out = [], []
        for s in range(0, w.shape[0], step):
            wc = _operand(w[s:s + step].to(self.device), self.precision)
            xc = _operand(self.x[rows[s:s + step].to(self.device)],
                          self.precision)
            prod = xc * wc[:, None, :]
            norm = torch.linalg.vector_norm(wc, dim=1, keepdim=True)
            m_out.append(prod.sum(-1).abs() / norm)
            s_out.append(prod.abs().sum(-1) / norm)
        return torch.cat(m_out), torch.cat(s_out)

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
            rows = torch.from_numpy(u[None, :]).to(self.device)
            m, _ = self.margins(w[qi:qi + 1], rows)
            j = int(torch.argmin(m[0]).item())
            ids[qi] = u[j]
            margins[qi] = float(m[0, j])
        return ids, margins, unions
