"""L independent bilinear-hash tables with union-of-candidates lookup and
dynamic insert/delete, in PyTorch.

Ids are stable across mutations: ``insert`` assigns fresh ids, ``delete``
tombstones rows out of every table, and ``compact`` physically drops them
while a stable-id remap keeps every outstanding id resolving.  Host state
(the bucket tables, the per-table codes, the feature rows) is numpy; the
features and the stacked live codes live on the index's device for the
hash, scan and re-rank.

Table families come from ``core.indexer.make_family``: table t derives
its family from ``functions.table_seed(config.seed, t)`` (seeded BH; AH
and EH drawn from a generator with that seed; LBH learned on the index's
device, warm-started at the seeded BH factors).  The JAX package derives
its families from jax.random keys, which torch cannot reproduce; to serve
a JAX-built index, carry its families and state across with
``repro_torch.interop``.  The scan path also runs row-sharded over a
``utils.mesh.Mesh`` (``mesh=``, ``core.search.hamming_topk_grouped_sharded``)
with answers identical to the single-device scan.  An index fit from row
shards (``fit_sharded``) keeps its feature rows, codes and id maps on the
mesh's devices, no whole copy anywhere, and answers through the scan path
by the cutoff exchange (``core.search.cutoff_exchange``), each shard
re-ranking its own candidates; it takes no mutation and has no probe
path.
``serving.lsm.LSMMultiTableIndex`` overrides the build, mutation,
lookup, re-rank and scan methods here for streaming ingest, and answers
its scans through this module's ``answer_slots``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.indexer import IndexConfig, QueryResult, make_family
from repro_torch.core.search import (DIST_SENTINEL, cutoff_exchange,
                                     hamming_topk_grouped_sharded,
                                     margin_batch, margin_rerank_batch,
                                     shard_rows)
from repro_torch.core.tables import SingleHashTable, keys_of
from repro_torch.kernels import ops
from repro_torch.kernels.candidates import candidate_lists
from repro_torch.kernels.shard_select import shard_histogram, shard_select
from repro_torch.serving import batch_query as bq
from repro_torch.utils import trace
from repro_torch.utils.bits import from_numpy_u32, to_numpy_u32
from repro_torch.utils.device import resolve_device
from repro_torch.utils.mesh import shard_count


@dataclasses.dataclass
class BatchQueryResult:
    ids: np.ndarray          # (B,) argmin-margin candidate per query (or -1)
    margins: np.ndarray      # (B,) f32
    nonempty: np.ndarray     # (B,) bool — any candidate survived the lookup?
    candidates: list[np.ndarray]  # per-query short-lists (union over tables)
    lookup_s: float          # probe path; 0 on either index's scan path
    rerank_s: float          # (its spans time it: ``utils.trace``)
    table_hits: np.ndarray   # (L,) per-table yield: probe path = bucket
                             # candidates found; scan path = scanned top-l
                             # slots holding a live row
    ids_topk: np.ndarray | None = None      # (B, l) when queried with l > 1
    margins_topk: np.ndarray | None = None  # (B, l), +inf past the valid set
    # a ShardReplicaRouter's answers: the fraction of live rows scanned, and
    # whether it fell short of 1 (a single index always covers every row)
    coverage: float = 1.0
    degraded: bool = False


def _read_back(device: torch.device, *ts: torch.Tensor) -> list[np.ndarray]:
    """One blocking device-to-host read of ``ts``, counted as one of
    ``reads`` in the open span, which then marks ``first_read`` and takes
    the trace anchor.  On CUDA each tensor is copied without blocking into
    a fresh pinned block of the caching host allocator, then the stream is
    waited for once; the arrays returned keep their blocks alive, so no
    later read writes into them.  So a kept array, or a view of it, holds
    its whole block of page-locked memory until it is dropped; the
    allocator rounds a block up to a power of two and keeps a freed one
    for later reads."""
    trace.add("reads", 1)
    if device.type == "cuda":
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in ts]
        for h, t in zip(host, ts):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(device).synchronize()
    else:
        host = [t.cpu() for t in ts]
    trace.mark("first_read")
    trace.anchor()
    return [h.numpy() for h in host]


def _cross(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """t on ``device``, copied without blocking the host where it is
    elsewhere; the bytes that cross count into the open span's
    ``exchange_bytes``."""
    if t.device == device:
        return t
    trace.add("exchange_bytes", t.numel() * t.element_size())
    return t.to(device, non_blocking=True)


def _scan_answers(margins: np.ndarray, ids: np.ndarray, hits: np.ndarray,
                  lists: np.ndarray, c: int, topk: int) -> BatchQueryResult:
    """The host's part of a scan path's read-back: the answers from the
    least margins (B, k) and the stable ids beside them (only a finite
    margin names an answer), padded to topk where k < topk (topk > L·l:
    pad, not clip); each query's candidate list a view of lists (B, c + 2)
    (its ids, then the count, then whether any slot was valid).  Counts
    ``candidates`` into the open span."""
    ids = np.where(np.isfinite(margins), ids, -1)
    if margins.shape[1] < topk:
        padw = ((0, 0), (0, topk - margins.shape[1]))
        margins = np.pad(margins, padw, constant_values=np.inf)
        ids = np.pad(ids, padw, constant_values=-1)
    counts = lists[:, c].tolist()
    trace.add("candidates", sum(counts))
    return BatchQueryResult(
        ids[:, 0], margins[:, 0], lists[:, c + 1] != 0,
        [lists[i, :k] for i, k in enumerate(counts)], 0.0, 0.0, hits,
        ids_topk=ids if topk > 1 else None,
        margins_topk=margins if topk > 1 else None)


def empty_answer(b: int, topk: int, tables: int) -> BatchQueryResult:
    """The scan path's answer for b queries to an index with no live row."""
    ids_pad = np.full((b, topk), -1, np.int64)
    m_pad = np.full((b, topk), np.inf, np.float32)
    return BatchQueryResult(
        np.full(b, -1, np.int64), np.full(b, np.inf, np.float32),
        np.zeros(b, dtype=bool), [np.empty(0, np.int64) for _ in range(b)],
        0.0, 0.0, np.zeros(tables, dtype=np.int64),
        ids_topk=ids_pad if topk > 1 else None,
        margins_topk=m_pad if topk > 1 else None)


def answer_slots(w, idx: torch.Tensor, topk: int, mask, device, id_map,
                 row_ids: np.ndarray, rerank, row_of=None
                 ) -> BatchQueryResult:
    """``MultiTableIndex.answer_from_scan`` for both indexes' single-device
    scans, over positions idx (L, B, l), -1 in an empty slot.  Each index
    gives what differs: row_of (n,) a position's row on the device (None:
    the position is the row), id_map (n,) its stable id on the device,
    row_ids the host's row -> stable id array (mask is over ids), and
    rerank(w_dev, rows, valid, topk) -> (margins, rows) over its features."""
    w = np.atleast_2d(np.asarray(w, np.float32))
    b = w.shape[0]
    n = id_map.shape[0]
    with trace.span("index.union", entry=True, exit=True) as union:
        # per query, sort the L·l positions and invalidate repeats and
        # empty (-1) slots
        flat = idx.permute(1, 0, 2).reshape(b, -1)
        flat = torch.sort(flat, dim=1).values
        uniq = flat >= 0
        uniq[:, 1:] &= flat[:, 1:] != flat[:, :-1]
        grows = torch.clamp(flat, 0, n - 1).long()
        if row_of is not None:
            grows = row_of[grows]
        # mask narrows answers and re-rank, not the reported short-lists
        valid = uniq if mask is None else (uniq & torch.from_numpy(
            np.asarray(mask, dtype=bool)[row_ids]).to(device)[grows])
        hits = (idx >= 0).sum(dim=(1, 2))
        # (B, L·l + 2): the unique candidates as stable ids, then the
        # count and whether any slot is valid
        lists = candidate_lists(flat, valid, id_map)
    with trace.span("index.rerank", entry=union, exit=True) as ranked:
        margins, top = rerank(bq.as_float_tensor(w, device), grows, valid,
                              topk)
    # its entry, the re-rank's exit, follows all of the batch's device work
    with trace.span("index.readback", entry=ranked):
        margins, top, hits, lists = _read_back(device, margins, top, hits,
                                               lists)
        # top holds rows, the padding's too
        return _scan_answers(margins, row_ids[top], hits, lists,
                             flat.shape[1], topk)


def _shard_mask(mask_rows: np.ndarray, start: int, valid: int, rows: int,
                device) -> torch.Tensor:
    """A shard's (rows,) slice of a row-space mask, False past its valid
    rows, on its device."""
    part = np.zeros(rows, dtype=bool)
    part[:valid] = mask_rows[start:start + valid]
    return torch.from_numpy(part).to(device)


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
        # stacked live codes (L, n_live, W), or their per-shard layout
        # over a mesh; _scan_key says which: None or (mesh, axis)
        self._codes_dev = None
        self._scan_key = None
        self._live_rows: np.ndarray | None = None
        self._live_rows_dev = None
        self._ids_dev = None    # stable ids of the live rows, int64
        # fit_sharded: the rows (R, d), codes (G, R, W) and stable ids (R,)
        # of each shard on its device, the mesh and its axis
        self._x_parts = None
        self._codes_parts = None
        self._ids_parts = None
        self.mesh = None
        self.shard_axis = None

    # -- build ---------------------------------------------------------------

    def fit(self, x, families=None) -> "MultiTableIndex":
        """Hash every row of x into the L tables and build them.  families:
        optional per-table hash families (default: from the config)."""
        t0 = time.perf_counter()
        x_dev = bq.as_float_tensor(x, self.device)
        if families is None:
            families = [make_family(self.config, x_dev, t)
                        for t in range(self.num_tables)]
        codes_all = to_numpy_u32(bq.hash_database_all(families, x_dev))
        n = x_dev.shape[0]
        x_host = x if isinstance(x, np.ndarray) else x_dev.cpu().numpy()
        self.restore(families, x_host, list(codes_all),
                     np.ones(n, dtype=bool), np.arange(n, dtype=np.int64), n)
        self._keep_fit_features(x_dev)
        self.fit_s = time.perf_counter() - t0
        return self

    def _keep_fit_features(self, x_dev: torch.Tensor) -> None:
        """Keep the features fit() put on the device: the monolithic
        re-rank gathers from them (the LSM index keeps its own padded
        segments instead)."""
        self._x_dev = x_dev
        self.device_uploads += 1

    def restore(self, families, x, codes, active, ids_np,
                next_id: int) -> "MultiTableIndex":
        """Adopt a complete index state without hashing: the families, the
        (rows, d) features, the per-table (rows, W) uint32 codes, the
        tombstone mask, the row -> stable id map and the id high-water mark.
        The bucket tables are rebuilt over the live rows."""
        if len(families) != self.num_tables or len(codes) != self.num_tables:
            raise ValueError(f"expected {self.num_tables} families and code "
                             f"tables, got {len(families)} and {len(codes)}")
        self._x_parts = self._codes_parts = self._ids_parts = None
        self.mesh = self.shard_axis = None
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

    def fit_sharded(self, parts, mesh, n: int | None = None,
                    axis: str = "data") -> "MultiTableIndex":
        """Build the index over rows that already sit as shards on a mesh's
        devices, keeping no whole copy of them on any device and none on
        the host.

        parts: one (R, d) float32 tensor a shard, on ``mesh.devices[s]`` in
        shard order: shard s holds rows [s R, (s + 1) R), the contiguous
        range ``core.search.shard_rows`` gives it; stable id = row.  n: the
        true row count (default S R); the rows from n on are padding (the
        tail of the last shards) and never candidates.  Each shard's rows
        are hashed on their own device by the config's families, which
        must be seeded BH, and its codes and stable ids stay there with its
        rows.

        The index answers through the scan path alone
        (``query_scan_batch`` with ``mesh`` None or this mesh, or a
        ``HashQueryService`` in scan mode): each shard selects its share of
        every table's top-l by the cutoff exchange and re-ranks its own
        candidates; the answers, candidate lists and hits equal the
        single-device index's over the same rows.  Mutations, the probe
        path, ``scan_table_topk`` and ``candidate_margins`` raise
        NotImplementedError."""
        t0 = time.perf_counter()
        shards = shard_count(mesh, axis)
        parts = tuple(parts)
        if len(parts) != shards:
            raise ValueError(f"{len(parts)} row shards for a mesh axis of "
                             f"{shards}")
        rows, d = parts[0].shape if parts[0].dim() == 2 else (0, 0)
        for part, dev in zip(parts, mesh.devices):
            if (part.dim() != 2 or tuple(part.shape) != (rows, d)
                    or part.dtype != torch.float32 or part.device != dev):
                raise ValueError(
                    f"each shard must be a ({rows}, {d}) float32 tensor on "
                    f"its mesh device; got {part.dtype} "
                    f"{tuple(part.shape)} on {part.device} for {dev}")
        n = shards * rows if n is None else int(n)
        if not 1 <= n <= shards * rows:
            raise ValueError(f"n = {n} rows do not fit {shards} shards of "
                             f"{rows}")
        if self.config.method != "bh" or not self.config.seeded_projections:
            raise NotImplementedError(
                "fit_sharded hashes each shard on its own device and needs "
                "seeded BH families (method 'bh', seeded_projections=True)")
        meta = torch.empty((0, d), dtype=torch.float32, device=self.device)
        families = [make_family(self.config, meta, t)
                    for t in range(self.num_tables)]
        codes = tuple(bq.hash_database_here(families, part).contiguous()
                      for part in parts)
        self._invalidate()
        self.families = list(families)
        self.x_np = None
        self.codes, self.tables = [], []
        self.active = np.ones(n, dtype=bool)
        self.ids_np = np.arange(n, dtype=np.int64)
        self._row_of = self.ids_np.copy()
        self._next_id = n
        self._x_parts, self._codes_parts = parts, codes
        self._ids_parts = tuple(
            torch.arange(s * rows, (s + 1) * rows, dtype=torch.int64,
                         device=dev) for s, dev in enumerate(mesh.devices))
        self.mesh, self.shard_axis = mesh, axis
        self.version += 1
        self.fit_s = time.perf_counter() - t0
        return self

    def _whole_rows(self, op: str) -> None:
        """Raise for what an index fit from row shards cannot do."""
        if self._x_parts is not None:
            raise NotImplementedError(
                f"MultiTableIndex.{op} on an index fit from row shards "
                f"(fit_sharded): its rows stay on the mesh's devices and it "
                f"answers through the scan path alone; insert, delete, "
                f"compact, the probe path, scan_table_topk and "
                f"candidate_margins need an index fit on whole rows (fit)")

    def _invalidate(self, keep_x: bool = False) -> None:
        """Drop the device-resident state derived from rows/codes.
        keep_x: the feature rows are unchanged (tombstone-only delete)."""
        if not keep_x:
            self._x_dev = None
        self._codes_dev = None
        self._live_rows = None
        self._live_rows_dev = None
        self._ids_dev = None

    def _require_fit(self, op: str) -> None:
        if self.x_np is None and self._x_parts is None:
            raise RuntimeError(
                f"MultiTableIndex.{op} before fit(): build the index with "
                f"fit(x) before mutating or querying it")

    @property
    def n(self) -> int:
        """Live (non-deleted) row count."""
        return int(self.active.sum())

    @property
    def x(self) -> torch.Tensor:
        self._whole_rows("x")
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
        self._whole_rows("insert")
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
        self._whole_rows("delete")
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
        self._whole_rows("compact")
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
        self._whole_rows("lookup_batch")
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
        self._whole_rows("rerank_rows")
        return bq.batched_rerank(self.x, w, cands, l, mask_rows)

    def query_batch(self, w, mask=None, l: int = 1) -> BatchQueryResult:
        """Answer B hyperplane queries through the probe tables.  mask:
        optional bool mask over stable-id space restricting answers."""
        self._whole_rows("query_batch")
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

    def _scan_state(self, mesh=None, axis: str = "data"):
        """Device-resident live codes for the scan and the live-row map,
        rebuilt only after a mutation or when the layout changes: the
        stacked (L, n_live, W) codes on the index's device, or with a mesh
        their per-shard layout (``core.search.shard_rows``: padded
        host-side to the shard count, each shard's row range on its
        device).  The live-row map and the live rows' stable ids
        (``_ids_dev``) stay on the index's device."""
        key = None if mesh is None else (mesh, axis)
        if self._codes_dev is None or self._scan_key != key:
            self.scan_state_rebuilds += 1
            self.device_uploads += 1
            self._live_rows = np.flatnonzero(self.active)
            stacked = np.stack([c[self._live_rows] for c in self.codes])
            self._codes_dev = (from_numpy_u32(stacked, self.device)
                               if mesh is None
                               else shard_rows(stacked, mesh, axis))
            self._live_rows_dev = torch.from_numpy(self._live_rows).to(
                self.device)
            self._ids_dev = torch.from_numpy(
                self.ids_np[self._live_rows]).to(self.device)
            self._scan_key = key
        return self._codes_dev, self._live_rows_dev

    def _scan(self, w, l: int, mesh=None, axis: str = "data"):
        """Per-table top-l over the live codes: (dists, live-row idx), each
        (L, B, l) int32 on the index's device: one hash launch, then one
        fused scan launch for all L tables, or with a mesh one per shard
        (``core.search.hamming_topk_grouped_sharded``)."""
        codes_dev, _ = self._scan_state(mesh, axis)
        with trace.span("index.hash"):
            qcodes = bq.hash_queries_all(self.families, w)
        cfg = self.config
        if mesh is None:
            with trace.span("index.scan"):
                blocks = ops.hamming_scan_blocks(codes_dev, qcodes, l,
                                                 select=cfg.fused_select,
                                                 pack=cfg.cand_pack)
            with trace.span("index.merge", entry=True, exit=True):
                return ops.merge_scan_blocks(blocks, l)
        return hamming_topk_grouped_sharded(
            codes_dev, qcodes, l, mesh, axis,
            n_valid=self._live_rows.shape[0], select=cfg.fused_select,
            pack=cfg.cand_pack)

    def query_scan_batch(self, w, l: int = 16, topk: int = 1, mask=None,
                         mesh=None, shard_axis: str = "data"
                         ) -> BatchQueryResult:
        """Device-side batched scan: ONE fused Hamming kernel launch for all
        L tables and B queries, then union/dedup and exact margin re-rank,
        all on the device.

        ``l`` is the per-table scan depth (recall), ``topk`` the number of
        answers; ids_topk/margins_topk are set when topk > 1 (impossible
        slots: id -1 / margin +inf).  mask: optional bool mask over stable-id
        space restricting answers.  All reported ids are stable ids.

        mesh: a ``utils.mesh.Mesh``; the live codes are then row-sharded
        over its ``shard_axis`` and each shard runs one scan launch on its
        device; answers identical to the single-device scan.  The layout
        is cached per (mesh, axis): reuse the mesh across calls.
        """
        if mesh is not None:
            shard_count(mesh, shard_axis)
        self._require_fit("query_scan_batch")
        if self._x_parts is not None:
            if mesh is not None and (mesh, shard_axis) != (self.mesh,
                                                           self.shard_axis):
                raise ValueError(f"this index's rows are sharded over "
                                 f"{self.mesh} along {self.shard_axis!r}, "
                                 f"not {mesh} along {shard_axis!r}")
            return self._scan_sharded_rows(w, l, topk, mask)
        w = np.atleast_2d(np.asarray(w, np.float32))
        if not self.active.any():
            return empty_answer(w.shape[0], topk, self.num_tables)
        _, idx = self._scan(w, l, mesh, shard_axis)
        return self.answer_from_scan(w, idx, topk, mask)

    def answer_from_scan(self, w, idx: torch.Tensor, topk: int = 1,
                         mask=None) -> BatchQueryResult:
        """The second half of ``query_scan_batch``: union, dedup and exact
        re-rank of a per-table scan result idx (L, B, l) of live-row
        positions (-1 = empty slot), on the device, where the union also
        builds each query's candidate list in stable-id space
        (``kernels.candidates``); the answers then cross to the host in
        one read, and each list is a view of it.  On CUDA the arrays
        returned are views of pinned host blocks (``_read_back``): a caller
        that keeps one query's list keeps the batch's block of lists
        pinned.  The scan path keeps no
        host timers (``lookup_s`` and ``rerank_s`` are 0): its stages are
        the spans ``index.union``, ``index.rerank`` and ``index.readback``
        (counts ``reads``, one per blocking read, and ``candidates``, the
        unique candidates of the batch's queries; mark ``first_read``)."""
        self._whole_rows("answer_from_scan")
        if self._codes_dev is None:
            self._scan_state()
        return answer_slots(
            w, idx, topk, mask, self.device, self._ids_dev, self.ids_np,
            lambda w_dev, rows, valid, k: margin_rerank_batch(
                self.x, w_dev, rows, valid, k),
            row_of=self._live_rows_dev)     # any layout's: same rows

    def _scan_sharded_rows(self, w, l: int, topk: int, mask
                           ) -> BatchQueryResult:
        """``query_scan_batch`` of an index fit from row shards: the cutoff
        exchange, then each shard's re-rank of its own candidates.

        On the index's device the queries are hashed and sent to the
        shards (span ``index.exchange``); each shard's distances and their
        histogram (``index.shard_select`` on its device) come back, the
        cutoffs and each shard's share go out, and the index's device
        reads the shards' widths (``index.exchange``: one blocking read);
        each shard selects its rows in ascending order and unites its
        tables' (``index.shard_select``), re-ranks them and builds their
        candidate lists (``index.shard_rerank``); the shards' B least
        margins and their lists cross to the index's device
        (``index.exchange``), where the lists are laid end to end in shard
        order, which is stable-id order (``index.union``), the least
        margins merged, ties to the lowest id (``index.rerank``), and the
        answers read back at once (``index.readback``).  The exchange spans
        count ``exchange_bytes``, what crosses between two devices; the
        second shard-select spans count ``candidates``, the rows a shard
        selected over its tables."""
        w = np.atleast_2d(np.asarray(w, np.float32))
        b = w.shape[0]
        dev0, devs = self.device, self.mesh.devices
        rows, n = self._x_parts[0].shape[0], self.ids_np.shape[0]
        g = self.num_tables
        c = g * l               # a query's union slots, as on one device
        k = min(topk, c)
        valid_rows = [min(max(n - s * rows, 0), rows)
                      for s in range(len(devs))]
        mask_rows = self.mask_to_rows(mask)
        with trace.span("index.hash"):
            qcodes = bq.hash_queries_all(self.families, w)
            w_dev = bq.as_float_tensor(w, dev0)
        with trace.span("index.exchange", entry=True, exit=True,
                        device=dev0):
            q_parts = [_cross(qcodes.contiguous(), dev) for dev in devs]
            w_parts = [_cross(w_dev, dev) for dev in devs]
        blocks, hists = [], []
        for s, dev in enumerate(devs):
            with trace.span("index.shard_select", entry=True, exit=True,
                            device=dev):
                h, blk = shard_histogram(self._codes_parts[s], q_parts[s],
                                         valid_rows[s])
                hists.append(h)
                blocks.append(blk)
        with trace.span("index.exchange", entry=True, exit=True,
                        device=dev0):
            cut, take, counts = cutoff_exchange(
                torch.stack([_cross(h, dev0) for h in hists]), min(l, n))
            cuts = [_cross(cut, dev).contiguous() for dev in devs]
            takes = [_cross(take[s], dev).contiguous()
                     for s, dev in enumerate(devs)]
            (counts,) = _read_back(dev0, counts)
        widths = counts.sum(axis=1).max(axis=1).tolist()
        unions = []
        for s, dev in enumerate(devs):
            with trace.span("index.shard_select", entry=True, exit=True,
                            device=dev):
                trace.add("candidates", int(counts[s].sum()))
                slots = shard_select(self._codes_parts[s], q_parts[s],
                                     valid_rows[s], blocks[s], cuts[s],
                                     takes[s], widths[s])
                blocks[s] = None
                hits = (slots < rows).sum(dim=(1, 2))
                flat = slots.permute(1, 0, 2).reshape(b, -1)
                if g > 1:   # the real slots first, ascending
                    flat = torch.sort(flat, dim=1).values[:, :widths[s]]
                unions.append((flat, hits))
        found = []
        for s, dev in enumerate(devs):
            with trace.span("index.shard_rerank", entry=True, exit=True,
                            device=dev):
                flat, hits = unions[s]
                uniq = flat < rows
                uniq[:, 1:] &= flat[:, 1:] != flat[:, :-1]
                local = torch.clamp(flat, max=rows - 1).long()
                valid = uniq if mask_rows is None else (uniq & _shard_mask(
                    mask_rows, s * rows, valid_rows[s], rows, dev)[local])
                m, top = margin_rerank_batch(self._x_parts[s], w_parts[s],
                                             local, valid, k)
                top = self._ids_parts[s][top]
                if m.shape[1] < k:
                    m = torch.nn.functional.pad(m, (0, k - m.shape[1]),
                                                value=torch.inf)
                    top = torch.nn.functional.pad(top, (0, k - top.shape[1]),
                                                  value=-1)
                lists = candidate_lists(
                    torch.where(uniq, flat, -1).contiguous(),
                    valid.contiguous(), self._ids_parts[s])
                found.append((m, top, lists, hits))
        with trace.span("index.exchange", entry=True, exit=True,
                        device=dev0):
            found = [tuple(_cross(t, dev0) for t in f) for f in found]
        with trace.span("index.union", entry=True, exit=True,
                        device=dev0) as union:
            out = torch.full((b, c + 3), -1, dtype=torch.int64, device=dev0)
            cnts = torch.stack([f[2][:, f[2].shape[1] - 2] for f in found])
            offs = torch.cumsum(cnts, 0) - cnts
            for s, (_, _, lists, _) in enumerate(found):
                width = lists.shape[1] - 2
                if width == 0:
                    continue
                j = torch.arange(width, device=dev0)[None, :]
                dest = torch.where(j < cnts[s][:, None],
                                   offs[s][:, None] + j, c + 2)
                out.scatter_(1, dest, lists[:, :width])
            out[:, c] = cnts.sum(0)
            out[:, c + 1] = torch.stack([f[2][:, -1] for f in found]).amax(0)
            hits = torch.stack([f[3] for f in found]).sum(0)
        with trace.span("index.rerank", entry=union, exit=True,
                        device=dev0) as rerank:
            m_all = torch.cat([f[0] for f in found], dim=1)
            m_all, order = torch.sort(m_all, dim=1, stable=True)
            margins = m_all[:, :k]
            top = torch.gather(torch.cat([f[1] for f in found], dim=1), 1,
                               order[:, :k])
        with trace.span("index.readback", entry=rerank):
            margins, top, hits, lists = _read_back(dev0, margins, top, hits,
                                                   out)
            # every shard's work of the batch preceded what was just read
            for dev in devs:
                trace.anchor(dev)
            return _scan_answers(margins, top, hits, lists, c, topk)

    def scan_table_topk(self, w, l: int = 16, mesh=None,
                        shard_axis: str = "data"
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Per-table Hamming top-l surfaced before the merge, in stable-id
        space: host (dists (L, B, l) int32, ids (L, B, l) int64), each list
        sorted by (distance, stable id) with (DIST_SENTINEL, -1) sentinels.
        mesh / shard_axis: the row-sharded scan, as in query_scan_batch."""
        if mesh is not None:
            shard_count(mesh, shard_axis)
        self._require_fit("scan_table_topk")
        self._whole_rows("scan_table_topk")
        w = np.atleast_2d(np.asarray(w, np.float32))
        b = w.shape[0]
        if not self.active.any():
            return (np.full((self.num_tables, b, l), DIST_SENTINEL,
                            np.int32),
                    np.full((self.num_tables, b, l), -1, np.int64))
        dists, idx = self._scan(w, l, mesh, shard_axis)
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
        self._whole_rows("candidate_margins")
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
