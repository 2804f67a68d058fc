"""L independent bilinear-hash tables with union-of-candidates lookup and
dynamic insert/delete, in PyTorch.

Ids are stable across mutations: ``insert`` assigns fresh ids, ``delete``
tombstones rows out of every table, and ``compact`` physically drops them
while a stable-id remap keeps every outstanding id resolving.  Host state
(the bucket tables, the per-table codes, the feature rows) is numpy; the
features and the stacked live codes live on the index's device for the
hash, scan and re-rank.

Table families: with ``method="bh"`` (seeded) table t hashes with
``SeededBHHash`` from ``functions.table_seed(config.seed, t)``.  The JAX
package derives its seeds from jax.random keys, which torch cannot
reproduce; to serve a JAX-built index, carry its families and state
across with ``repro_torch.interop``.  The row-sharded scan (``mesh=``) is
not ported in this slice.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import functions as F
from repro_torch.core.indexer import IndexConfig, QueryResult
from repro_torch.core.search import (DIST_SENTINEL, margin_batch,
                                     margin_rerank_batch)
from repro_torch.core.tables import SingleHashTable, keys_of
from repro_torch.kernels import ops
from repro_torch.serving import batch_query as bq
from repro_torch.utils.bits import from_numpy_u32, to_numpy_u32
from repro_torch.utils.device import resolve_device

_NO_MESH = ("the row-sharded scan (mesh=) is not ported yet "
            "(ROADMAP, queue 1 item 9)")


@dataclasses.dataclass
class BatchQueryResult:
    ids: np.ndarray          # (B,) argmin-margin candidate per query (or -1)
    margins: np.ndarray      # (B,) f32
    nonempty: np.ndarray     # (B,) bool — any candidate survived the lookup?
    candidates: list[np.ndarray]  # per-query short-lists (union over tables)
    lookup_s: float
    rerank_s: float
    table_hits: np.ndarray   # (L,) per-table yield: probe path = bucket
                             # candidates found; scan path = scanned top-l
                             # slots holding a live row
    ids_topk: np.ndarray | None = None      # (B, l) when queried with l > 1
    margins_topk: np.ndarray | None = None  # (B, l), +inf past the valid set


class MultiTableIndex:
    """Union-of-candidates index over L compact bilinear-hash tables."""

    def __init__(self, config: IndexConfig, tables: int | None = None,
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.num_tables = int(tables if tables is not None else config.tables)
        if self.num_tables < 1:
            raise ValueError(f"need at least one table, got {self.num_tables}")
        self.families: list = []
        self.tables: list[SingleHashTable] = []
        self.codes: list[np.ndarray] = []   # per-table (rows, W) uint32, host
        self.x_np: np.ndarray | None = None  # (rows, d) host copy
        self.active: np.ndarray | None = None  # (rows,) bool tombstone mask
        # row -> stable id (strictly increasing, so row-order ties are
        # id-order ties) and stable id -> row (-1 once compacted away)
        self.ids_np: np.ndarray | None = None
        self._row_of: np.ndarray | None = None
        self._next_id = 0
        self.compactions = 0
        self.version = 0        # bumped on fit/insert/delete/compact
        self.fit_s = 0.0
        self.device_uploads = 0        # host->device transfers of index state
        self.scan_state_rebuilds = 0   # stacked-code scan layouts rebuilt
        self.compaction_steps = 0
        self._x_dev = None
        self._codes_dev = None        # (L, n_live, W) stacked live codes
        self._live_rows: np.ndarray | None = None
        self._live_rows_dev = None

    # -- build ---------------------------------------------------------------

    def _make_family(self, t: int, d: int):
        cfg = self.config
        if cfg.method != "bh":
            raise NotImplementedError(
                f"method {cfg.method!r}: its families are learned by the JAX "
                f"package; pass them in (fit(x, families=...), see "
                f"repro_torch.interop)")
        if not cfg.seeded_projections:
            raise NotImplementedError(
                "method 'bh' with seeded_projections=False: its factors are "
                "drawn by the JAX package; pass them in (fit(x, families=...),"
                " see repro_torch.interop.families_from_numpy)")
        return F.SeededBHHash.create(F.table_seed(cfg.seed, t), d, cfg.bits,
                                     self.device)

    def fit(self, x, families=None) -> "MultiTableIndex":
        """Hash every row of x into the L tables and build them.  families:
        optional per-table hash families (default: from the config)."""
        t0 = time.perf_counter()
        x_dev = bq.as_float_tensor(x, self.device)
        if families is None:
            families = [self._make_family(t, x_dev.shape[1])
                        for t in range(self.num_tables)]
        codes_all = to_numpy_u32(bq.hash_database_all(families, x_dev))
        n = x_dev.shape[0]
        x_host = x if isinstance(x, np.ndarray) else x_dev.cpu().numpy()
        self.restore(families, x_host, list(codes_all),
                     np.ones(n, dtype=bool), np.arange(n, dtype=np.int64), n)
        self._x_dev = x_dev
        self.device_uploads += 1
        self.fit_s = time.perf_counter() - t0
        return self

    def restore(self, families, x, codes, active, ids_np,
                next_id: int) -> "MultiTableIndex":
        """Adopt a complete index state without hashing: the families, the
        (rows, d) features, the per-table (rows, W) uint32 codes, the
        tombstone mask, the row -> stable id map and the id high-water mark.
        The bucket tables are rebuilt over the live rows."""
        if len(families) != self.num_tables or len(codes) != self.num_tables:
            raise ValueError(f"expected {self.num_tables} families and code "
                             f"tables, got {len(families)} and {len(codes)}")
        self.families = list(families)
        self.codes = [np.ascontiguousarray(c, dtype=np.uint32) for c in codes]
        self.x_np = np.require(x, dtype=np.float32, requirements=["C", "W"])
        self.active = np.array(active, dtype=bool)
        self.ids_np = np.array(ids_np, dtype=np.int64)
        live = np.flatnonzero(self.active)
        self.tables = [SingleHashTable(c[live], self.config.bits, ids=live)
                       for c in self.codes]
        self._next_id = int(next_id)
        self._row_of = np.full(self._next_id, -1, dtype=np.int64)
        self._row_of[self.ids_np] = np.arange(self.ids_np.size,
                                              dtype=np.int64)
        self._invalidate()
        self.version += 1
        return self

    def _invalidate(self, keep_x: bool = False) -> None:
        """Drop the device-resident state derived from rows/codes.
        keep_x: the feature rows are unchanged (tombstone-only delete)."""
        if not keep_x:
            self._x_dev = None
        self._codes_dev = None
        self._live_rows = None
        self._live_rows_dev = None

    def _require_fit(self, op: str) -> None:
        if self.x_np is None:
            raise RuntimeError(
                f"MultiTableIndex.{op} before fit(): build the index with "
                f"fit(x) before mutating or querying it")

    @property
    def n(self) -> int:
        """Live (non-deleted) row count."""
        return int(self.active.sum())

    @property
    def x(self) -> torch.Tensor:
        if self._x_dev is None:
            self._x_dev = torch.from_numpy(self.x_np).to(self.device)
            self.device_uploads += 1
        return self._x_dev

    # -- stable-id translation -----------------------------------------------

    def rows_to_ids(self, rows: np.ndarray) -> np.ndarray:
        """Internal row numbers -> stable external ids (-1 passes through)."""
        rows = np.asarray(rows, dtype=np.int64)
        out = np.full(rows.shape, -1, dtype=np.int64)
        m = rows >= 0
        out[m] = self.ids_np[rows[m]]
        return out

    def ids_to_rows(self, ids: np.ndarray) -> np.ndarray:
        """Stable ids -> current rows.  Never-assigned and compacted-away
        ids raise KeyError; tombstoned-but-not-compacted ids still resolve."""
        self._require_fit("ids_to_rows")
        ids = np.asarray(ids, dtype=np.int64)
        n_ids = self._row_of.shape[0]
        if ids.size and (ids.min() < 0 or ids.max() >= n_ids):
            raise KeyError(f"unknown ids (never assigned): "
                           f"{ids[(ids < 0) | (ids >= n_ids)][:8]}")
        rows = self._row_of[ids]
        if (rows < 0).any():
            raise KeyError(f"ids compacted away: {ids[rows < 0][:8]}")
        return rows

    def mask_to_rows(self, mask) -> np.ndarray | None:
        """Stable-id-space bool mask -> row-space mask."""
        if mask is None:
            return None
        return np.asarray(mask, dtype=bool)[self.ids_np]

    # -- dynamic updates -----------------------------------------------------

    def insert(self, x_new) -> np.ndarray:
        """Append rows to every table; returns the assigned stable ids."""
        self._require_fit("insert")
        x_new = np.atleast_2d(np.asarray(x_new, np.float32))
        if x_new.shape[0] == 0:
            return np.empty((0,), dtype=np.int64)
        new_codes = to_numpy_u32(bq.hash_database_all(self.families, x_new))
        start = self.x_np.shape[0]
        rows = np.arange(start, start + x_new.shape[0], dtype=np.int64)
        ids = np.arange(self._next_id, self._next_id + x_new.shape[0],
                        dtype=np.int64)
        for t in range(self.num_tables):
            self.tables[t].insert(new_codes[t], rows)
            self.codes[t] = np.concatenate([self.codes[t], new_codes[t]])
        self.x_np = np.concatenate([self.x_np, x_new])
        self.active = np.concatenate(
            [self.active, np.ones(x_new.shape[0], dtype=bool)])
        self.ids_np = np.concatenate([self.ids_np, ids])
        self._row_of = np.concatenate([self._row_of, rows])
        self._next_id += x_new.shape[0]
        self._invalidate()
        self.version += 1
        return ids

    def delete(self, ids) -> None:
        """Tombstone rows out of every table (ids stay stable).  An empty
        delete is a no-op and does not bump ``version``.  Past
        ``config.compact_threshold`` dead fraction the index compacts."""
        self._require_fit("delete")
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        if ids.size == 0:
            return
        if np.unique(ids).size != ids.size:
            raise KeyError("duplicate ids in delete")
        rows = self.ids_to_rows(ids)
        if not self.active[rows].all():
            raise KeyError("delete of already-deleted or unknown id")
        for t in range(self.num_tables):
            self.tables[t].delete(rows)
        self.active[rows] = False
        self._invalidate(keep_x=True)
        self.version += 1
        thresh = self.config.compact_threshold
        dead = self.active.size - int(self.active.sum())
        if thresh is not None and dead > thresh * self.active.size:
            self.compact()

    def compact(self) -> np.ndarray:
        """Physically drop tombstoned rows and refresh the stable-id remap.
        Returns the surviving stable ids; no-op when nothing is dead."""
        self._require_fit("compact")
        if self.active.all():
            return self.ids_np.copy()
        live = np.flatnonzero(self.active)
        self.codes = [c[live] for c in self.codes]
        self.x_np = self.x_np[live]
        self.ids_np = self.ids_np[live]
        self.active = np.ones(live.size, dtype=bool)
        self.tables = [SingleHashTable(c, self.config.bits)
                       for c in self.codes]
        self._row_of = np.full(self._next_id, -1, dtype=np.int64)
        self._row_of[self.ids_np] = np.arange(live.size, dtype=np.int64)
        self._invalidate()
        self.version += 1
        self.compactions += 1
        self.compaction_steps += 1
        return self.ids_np.copy()

    # -- probe path ----------------------------------------------------------

    def lookup_batch(self, w, qcodes: np.ndarray | None = None
                     ) -> tuple[list[np.ndarray], np.ndarray, float]:
        """Hash + multi-probe for B hyperplanes at once.

        qcodes: optional precomputed (L, B, W) uint32 query codes.  Returns
        (per-query unioned candidate lists IN ROW SPACE, per-table hit
        counts, elapsed seconds)."""
        self._require_fit("lookup_batch")
        cfg = self.config
        w = np.atleast_2d(np.asarray(w, np.float32))
        t0 = time.perf_counter()
        if qcodes is None:
            qcodes = to_numpy_u32(bq.hash_queries_all(self.families, w))
        hits = np.zeros(self.num_tables, dtype=np.int64)
        per_query: list[list[np.ndarray]] = [[] for _ in range(w.shape[0])]
        for t, table in enumerate(self.tables):
            found = table.lookup_many(keys_of(qcodes[t]), cfg.radius,
                                      cfg.max_candidates, cfg.min_candidates)
            for b, cand in enumerate(found):
                per_query[b].append(cand)
                hits[t] += cand.size
        cands = [bq.union_candidates(per) for per in per_query]
        if cfg.max_candidates is not None:
            cands = [c[:cfg.max_candidates] for c in cands]
        return cands, hits, time.perf_counter() - t0

    def rerank_rows(self, w, cands: list[np.ndarray], l: int = 1,
                    mask_rows=None):
        """Exact-margin re-rank of B ragged ROW-space candidate lists."""
        return bq.batched_rerank(self.x, w, cands, l, mask_rows)

    def query_batch(self, w, mask=None, l: int = 1) -> BatchQueryResult:
        """Answer B hyperplane queries through the probe tables.  mask:
        optional bool mask over stable-id space restricting answers."""
        cands, hits, lookup_s = self.lookup_batch(w)
        w = np.atleast_2d(np.asarray(w, np.float32))
        t0 = time.perf_counter()
        ids, margins, nonempty = self.rerank_rows(w, cands, l,
                                                  self.mask_to_rows(mask))
        ids = self.rows_to_ids(ids)
        cands = [self.rows_to_ids(c) for c in cands]
        rerank_s = time.perf_counter() - t0
        return BatchQueryResult(ids[:, 0], margins[:, 0], nonempty, cands,
                                lookup_s, rerank_s, hits,
                                ids_topk=ids if l > 1 else None,
                                margins_topk=margins if l > 1 else None)

    def query(self, w) -> QueryResult:
        """Single-query path (same machinery, B=1)."""
        res = self.query_batch(np.asarray(w, np.float32)[None, :])
        return QueryResult(int(res.ids[0]), float(res.margins[0]),
                           res.candidates[0], bool(res.nonempty[0]),
                           res.lookup_s, res.rerank_s)

    # -- scan path -----------------------------------------------------------

    def _scan_state(self):
        """Device-resident stacked live codes (L, n_live, W) and the
        live-row map, rebuilt only after a mutation."""
        if self._codes_dev is None:
            self.scan_state_rebuilds += 1
            self.device_uploads += 1
            self._live_rows = np.flatnonzero(self.active)
            stacked = np.stack([c[self._live_rows] for c in self.codes])
            self._codes_dev = from_numpy_u32(stacked, self.device)
            self._live_rows_dev = torch.from_numpy(self._live_rows).to(
                self.device)
        return self._codes_dev, self._live_rows_dev

    def _scan(self, w, l: int):
        """Per-table top-l over the live codes: (dists, live-row idx), each
        (L, B, l) int32 on the device — one hash launch and one fused scan
        launch for all L tables."""
        codes_dev, _ = self._scan_state()
        qcodes = bq.hash_queries_all(self.families, w)
        return ops.hamming_topk_grouped(codes_dev, qcodes, l,
                                        select=self.config.fused_select,
                                        pack=self.config.cand_pack)

    def query_scan_batch(self, w, l: int = 16, topk: int = 1, mask=None,
                         mesh=None) -> BatchQueryResult:
        """Device-side batched scan: ONE fused Hamming kernel launch for all
        L tables and B queries, then union/dedup and exact margin re-rank,
        all on the device.

        ``l`` is the per-table scan depth (recall), ``topk`` the number of
        answers; ids_topk/margins_topk are set when topk > 1 (impossible
        slots: id -1 / margin +inf).  mask: optional bool mask over stable-id
        space restricting answers.  All reported ids are stable ids.
        """
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        self._require_fit("query_scan_batch")
        w = np.atleast_2d(np.asarray(w, np.float32))
        b = w.shape[0]
        t0 = time.perf_counter()
        if not self.active.any():
            ids_pad = np.full((b, topk), -1, np.int64)
            m_pad = np.full((b, topk), np.inf, np.float32)
            return BatchQueryResult(
                np.full(b, -1, np.int64), np.full(b, np.inf, np.float32),
                np.zeros(b, dtype=bool),
                [np.empty(0, np.int64) for _ in range(b)],
                time.perf_counter() - t0, 0.0,
                np.zeros(self.num_tables, dtype=np.int64),
                ids_topk=ids_pad if topk > 1 else None,
                margins_topk=m_pad if topk > 1 else None)
        _, idx = self._scan(w, l)
        return self.answer_from_scan(w, idx, topk, mask, t0)

    def answer_from_scan(self, w, idx: torch.Tensor, topk: int = 1,
                         mask=None, t0: float | None = None
                         ) -> BatchQueryResult:
        """The second half of ``query_scan_batch``: union, dedup and exact
        re-rank of a per-table scan result idx (L, B, l) of live-row
        positions (-1 = empty slot), on the device.  t0: when the query
        started (default now), for the lookup timing."""
        if t0 is None:
            t0 = time.perf_counter()
        w = np.atleast_2d(np.asarray(w, np.float32))
        b = w.shape[0]
        _, live_rows_dev = self._scan_state()
        n_live = self._live_rows.shape[0]
        # per query, sort the L·l live-row ids and invalidate repeats and
        # empty (-1) slots
        flat = idx.permute(1, 0, 2).reshape(b, -1)
        flat = torch.sort(flat, dim=1).values
        uniq = flat >= 0
        uniq[:, 1:] &= flat[:, 1:] != flat[:, :-1]
        grows = live_rows_dev[torch.clamp(flat, 0, n_live - 1).long()]
        # mask narrows answers and re-rank, not the reported short-lists
        mask_rows = self.mask_to_rows(mask)
        valid = uniq if mask_rows is None else (
            uniq & torch.from_numpy(mask_rows).to(self.device)[grows])
        lookup_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        margins, top = margin_rerank_batch(
            self.x, bq.as_float_tensor(w, self.device), grows, valid, topk)
        margins = margins.cpu().numpy()
        top = top.cpu().numpy().astype(np.int64)
        top[~np.isfinite(margins)] = -1
        if margins.shape[1] < topk:   # topk > L*l candidates: pad, not clip
            padw = ((0, 0), (0, topk - margins.shape[1]))
            margins = np.pad(margins, padw, constant_values=np.inf)
            top = np.pad(top, padw, constant_values=-1)
        top = self.rows_to_ids(top)
        hits = (idx >= 0).sum(dim=(1, 2)).cpu().numpy().astype(np.int64)
        grows_np = grows.cpu().numpy()
        uniq_np, valid_np = uniq.cpu().numpy(), valid.cpu().numpy()
        cands = [self.rows_to_ids(grows_np[i, uniq_np[i]]) for i in range(b)]
        rerank_s = time.perf_counter() - t0
        return BatchQueryResult(
            top[:, 0], margins[:, 0], valid_np.any(axis=1), cands,
            lookup_s, rerank_s, hits,
            ids_topk=top if topk > 1 else None,
            margins_topk=margins if topk > 1 else None)

    def scan_table_topk(self, w, l: int = 16, mesh=None
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Per-table Hamming top-l surfaced before the merge, in stable-id
        space: host (dists (L, B, l) int32, ids (L, B, l) int64), each list
        sorted by (distance, stable id) with (DIST_SENTINEL, -1) sentinels."""
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        self._require_fit("scan_table_topk")
        w = np.atleast_2d(np.asarray(w, np.float32))
        b = w.shape[0]
        if not self.active.any():
            return (np.full((self.num_tables, b, l), DIST_SENTINEL,
                            np.int32),
                    np.full((self.num_tables, b, l), -1, np.int64))
        dists, idx = self._scan(w, l)
        idx_np = idx.cpu().numpy().astype(np.int64)
        n_live = self._live_rows.shape[0]
        grows = self._live_rows[np.clip(idx_np, 0, n_live - 1)]
        ids = np.where(idx_np >= 0, self.ids_np[grows], -1)
        return dists.cpu().numpy(), ids

    def candidate_margins(self, w, cand_ids: np.ndarray) -> np.ndarray:
        """Exact margins for an externally chosen candidate set, by stable
        id: (B, C) float32, +inf at padding (-1) or ids that no longer
        resolve."""
        self._require_fit("candidate_margins")
        w = np.atleast_2d(np.asarray(w, np.float32))
        cand_ids = np.asarray(cand_ids, dtype=np.int64)
        known = (cand_ids >= 0) & (cand_ids < self._next_id)
        rows = np.zeros(cand_ids.shape, dtype=np.int64)
        rows[known] = self._row_of[cand_ids[known]]
        valid = known & (rows >= 0)
        rows[~valid] = 0
        m = margin_batch(self.x, bq.as_float_tensor(w, self.device),
                         torch.from_numpy(rows).to(self.device),
                         torch.from_numpy(valid).to(self.device))
        return m.cpu().numpy()

    def stats(self) -> dict:
        per_table = [t.stats() for t in self.tables]
        rows = self.active.size if self.active is not None else 0
        return {
            "tables": self.num_tables,
            "n": self.n if self.active is not None else 0,
            "rows": rows,
            "dead_fraction": 1.0 - self.n / rows if rows else 0.0,
            "compactions": self.compactions,
            "bits": self.config.bits,
            "version": self.version,
            "device": str(self.device),
            "device_uploads": self.device_uploads,
            "scan_state_rebuilds": self.scan_state_rebuilds,
            "compaction_steps": self.compaction_steps,
            "per_table": per_table,
            "buckets_total": int(sum(s["buckets"] for s in per_table)),
        }
