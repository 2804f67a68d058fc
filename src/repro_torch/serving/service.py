"""Micro-batching query service over a MultiTableIndex.

Callers enqueue work (``submit``) and the service answers everything
pending as one batched device pass (``flush``), or hand it a whole batch
(``query_batch``) and it chunks by ``max_batch``.

Two interchangeable backends (``mode``):

- ``"probe"`` (default) — host hash-table multi-probe, with an LRU cache
  at the query-code level: two hyperplanes with the same L codes probe the
  same buckets, so the cached value is the unioned candidate list.  The
  exact-margin re-rank always runs.  The cache is dropped whenever the
  index mutates (``index.version``) and bypassed when a row mask is given.
- ``"scan"`` — the device-resident fused top-k Hamming scan
  (``MultiTableIndex.query_scan_batch``): one hash launch and one scan
  launch for all L tables and the whole micro-batch, no candidate cache.

The JAX package's online refresh (``refresh``, ``RefreshManager``) and the
row-sharded scan (``mesh=``) come with later slices of the port.
"""
from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np

from repro_torch.core.indexer import QueryResult
from repro_torch.serving import batch_query as bq
from repro_torch.serving.multi_table import _NO_MESH, MultiTableIndex
from repro_torch.utils.bits import to_numpy_u32


class HashQueryService:
    """Batched front end with micro-batching, candidate cache and counters."""

    def __init__(self, index: MultiTableIndex, max_batch: int | None = None,
                 cache_size: int = 1024, mode: str = "probe",
                 scan_l: int = 16, mesh=None):
        if mode not in ("probe", "scan"):
            raise ValueError(f"mode must be 'probe' or 'scan', got {mode!r}")
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        self.index = index
        self.mode = mode
        self.scan_l = int(scan_l)
        self.max_batch = int(max_batch if max_batch is not None
                             else index.config.batch)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        self.cache_size = int(cache_size)
        self._cache: OrderedDict[bytes, np.ndarray] = OrderedDict()
        self._cache_version = index.version
        self._pending: list[np.ndarray] = []
        # counters
        self.requests = 0
        self.batches = 0
        self.cache_hits = 0
        self.busy_s = 0.0
        self.lookup_s = 0.0
        self.rerank_s = 0.0
        self.latencies_s: list[float] = []
        self.inserts = 0
        self.inserted_rows = 0
        self.deletes = 0
        self.deleted_rows = 0

    # -- writes --------------------------------------------------------------

    def insert(self, x_new) -> np.ndarray:
        """Forward a streaming insert; returns the assigned stable ids.  The
        candidate cache self-invalidates on the version bump."""
        ids = self.index.insert(x_new)
        self.inserts += 1
        self.inserted_rows += int(ids.size)
        return ids

    def delete(self, ids) -> None:
        """Forward a streaming delete (tombstone) to the index."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        self.index.delete(ids)
        self.deletes += 1
        self.deleted_rows += int(ids.size)

    # -- micro-batching ------------------------------------------------------

    def submit(self, w) -> int:
        """Enqueue one hyperplane query; returns its ticket (flush order)."""
        self._pending.append(np.asarray(w, np.float32).reshape(-1))
        return len(self._pending) - 1

    @property
    def pending(self) -> int:
        return len(self._pending)

    def flush(self) -> list[QueryResult]:
        """Answer everything pending as one batch, in submit order."""
        if not self._pending:
            return []
        ws = np.stack(self._pending)
        self._pending = []
        return self.query_batch(ws)

    def query(self, w) -> QueryResult:
        ticket = self.submit(w)
        return self.flush()[ticket]

    # -- batched path --------------------------------------------------------

    def query_batch(self, ws, mask=None) -> list[QueryResult]:
        """Answer B queries, chunked by ``max_batch``; results in order."""
        ws = np.atleast_2d(np.asarray(ws, np.float32))
        out: list[QueryResult] = []
        for s in range(0, ws.shape[0], self.max_batch):
            out.extend(self._answer(ws[s:s + self.max_batch], mask))
        return out

    def _cache_get(self, key: bytes) -> np.ndarray | None:
        if self._cache_version != self.index.version:
            self._cache.clear()
            self._cache_version = self.index.version
            return None
        cand = self._cache.get(key)
        if cand is not None:
            self._cache.move_to_end(key)
        return cand

    def _cache_put(self, key: bytes, cand: np.ndarray) -> None:
        self._cache[key] = cand
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    def _record(self, b: int, elapsed: float, lookup_s: float,
                rerank_s: float) -> None:
        self.requests += b
        self.batches += 1
        self.busy_s += elapsed
        self.lookup_s += lookup_s
        self.rerank_s += rerank_s
        self.latencies_s.append(elapsed)

    def _answer(self, ws: np.ndarray, mask) -> list[QueryResult]:
        if self.mode == "scan":
            return self._answer_scan(ws, mask)
        t_start = time.perf_counter()
        b = ws.shape[0]
        use_cache = mask is None and self.cache_size > 0
        qcodes = to_numpy_u32(bq.hash_queries_all(self.index.families, ws))
        keys = [qcodes[:, i, :].tobytes() for i in range(b)]
        cands: list[np.ndarray | None] = [None] * b
        miss_rows = []
        for i, key in enumerate(keys):
            hit = self._cache_get(key) if use_cache else None
            if hit is None:
                miss_rows.append(i)
            else:
                cands[i] = hit
                self.cache_hits += 1
        lookup_s = 0.0
        if miss_rows:
            found, _, lookup_s = self.index.lookup_batch(
                ws[miss_rows], qcodes=qcodes[:, miss_rows, :])
            for i, cand in zip(miss_rows, found):
                cands[i] = cand
                if use_cache:
                    self._cache_put(keys[i], cand)

        t0 = time.perf_counter()
        ids, margins, nonempty = self.index.rerank_rows(
            ws, cands, 1, self.index.mask_to_rows(mask))
        ids = self.index.rows_to_ids(ids)
        cands = [self.index.rows_to_ids(c) for c in cands]
        rerank_s = time.perf_counter() - t0
        self._record(b, time.perf_counter() - t_start, lookup_s, rerank_s)
        return [QueryResult(int(ids[i, 0]), float(margins[i, 0]), cands[i],
                            bool(nonempty[i]), lookup_s / b, rerank_s / b)
                for i in range(b)]

    def _answer_scan(self, ws: np.ndarray, mask) -> list[QueryResult]:
        """Fused-scan backend: one grouped scan launch per micro-batch."""
        t_start = time.perf_counter()
        b = ws.shape[0]
        res = self.index.query_scan_batch(ws, l=self.scan_l, mask=mask)
        self._record(b, time.perf_counter() - t_start, res.lookup_s,
                     res.rerank_s)
        return [QueryResult(int(res.ids[i]), float(res.margins[i]),
                            res.candidates[i], bool(res.nonempty[i]),
                            res.lookup_s / b, res.rerank_s / b)
                for i in range(b)]

    # -- counters ------------------------------------------------------------

    def stats(self) -> dict:
        lat = np.asarray(self.latencies_s) if self.latencies_s else np.zeros(1)
        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_batch": self.requests / max(self.batches, 1),
            "cache_hits": self.cache_hits,
            "cache_hit_rate": self.cache_hits / max(self.requests, 1),
            "cache_entries": len(self._cache),
            "qps": self.requests / max(self.busy_s, 1e-12),
            "mean_batch_latency_ms": 1e3 * float(lat.mean()),
            "p95_batch_latency_ms": 1e3 * float(np.quantile(lat, 0.95)),
            "lookup_s": self.lookup_s,
            "rerank_s": self.rerank_s,
            "index_version": self.index.version,
            "inserts": self.inserts,
            "inserted_rows": self.inserted_rows,
            "deletes": self.deletes,
            "deleted_rows": self.deleted_rows,
            "index_device_uploads": self.index.device_uploads,
            "index_scan_state_rebuilds": self.index.scan_state_rebuilds,
            "index_compaction_steps": self.index.compaction_steps,
            "index_compactions": self.index.compactions,
        }
