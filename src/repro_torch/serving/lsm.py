"""LSM-style delta index: streaming ingest over an immutable base segment.

``MultiTableIndex`` is monolithic: every ``insert`` concatenates the whole
host state and drops the device scan state, so the next scan query
re-uploads the full stacked (L, n, W) codes, and ``compact()`` stops the
world.  ``LSMMultiTableIndex`` splits one contiguous row space into two
segments:

- **base**, rows ``[0, base_len)``, immutable: its stacked codes, liveness
  and features are uploaded once per compaction cycle, padded to a sticky
  power-of-two row bucket (a swap never shrinks it, so the device
  allocations keep their size), and scanned by the fused scan kernel.
  Deletes never touch it: they tombstone rows (the ``active`` mask).
- **delta**, rows ``[base_len, rows)``, mutable: append-only host buffers
  with geometric growth absorb inserts; the small delta re-uploads after a
  mutation and is scanned by plain PyTorch
  (``core.search.hamming_topk_grouped``) while below
  ``IndexConfig.lsm_delta_fused_rows`` rows, by the scan kernel past it.

Queries scan both segments with the liveness mask inside selection and
merge through the lexicographic (distance, id) contract
(``core.search.merge_topk_segments``): answers are identical to a fresh
monolithic index over the same live rows, tie order and l > n sentinels
included.  That holds because row order always equals stable-id order
(base rows keep their relative order across compactions; delta ids are
assigned later, hence larger).  The merged top-l is answered as the
monolithic index answers its scan (``multi_table.answer_slots``: kernel
9's lists from a device row -> stable id map, the segmented re-rank, one
read-back a micro-batch, the spans ``index.union`` / ``rerank`` /
``readback``).

Incremental compaction: past the delta / dead-fraction thresholds the
index freezes the delta and folds base + frozen delta into a new base,
``IndexConfig.lsm_step_rows`` source rows per step under the lock,
piggybacked on index calls (``lsm_auto``) or driven by
``start_compactor()``'s thread; inserts keep landing in the live delta
meanwhile.  The new base then crosses to the device OFF the lock, and one
bounded step swaps the segments: pointer flips plus O(live delta) copies,
with a liveness re-check so rows deleted mid-compaction stay tombstoned.
The probe tables are keyed by stable id, so compaction never rebuilds
them.

Online refresh (``serving.refresh``) builds a private shadow index over the
live rows with re-learned families (``_install``, ``_append_rows``) and
grafts its whole segment state into this object by pointer flips
(``_adopt_refresh``): ``generation`` counts those swaps.  Every consumer
snapshots the families together with the device state under one lock
hold, and ``insert`` re-hashes when a swap landed while it hashed, so no
answer and no row mixes two generations.

With ``mesh=`` the base segment's scan runs row-sharded
(``core.search.hamming_topk_grouped_sharded``) over a layout cached per
(base version, mesh, axis).  The sharded scan cannot take the liveness
mask, so it scans ``l + #tombstones`` deep (rounded up to a power of two,
at most the segment) and ``core.search.drop_tombstones_topk`` keeps the
live top-l; the small delta stays on one device.  Answers are identical
to the single-device scan's.
"""
from __future__ import annotations

import functools
import threading
import time

import numpy as np
import torch

from repro_torch.core import search
from repro_torch.core.indexer import IndexConfig
from repro_torch.core.search import (DIST_SENTINEL, drop_tombstones_topk,
                                     hamming_topk_grouped_sharded,
                                     margin_batch, margin_batch_segmented,
                                     margin_rerank_batch,
                                     margin_rerank_segmented,
                                     merge_topk_segments, shard_rows)
from repro_torch.core.tables import SingleHashTable
from repro_torch.kernels import ops
from repro_torch.serving import batch_query as bq
from repro_torch.serving.multi_table import (BatchQueryResult,
                                             MultiTableIndex, answer_slots,
                                             empty_answer)
from repro_torch.utils.bits import to_numpy_u32
from repro_torch.utils.mesh import shard_count

_MIN_CAP = 64   # floor of every power-of-two buffer / device row bucket
# bucket entries of a retired generation's probe tables freed between two
# yields of the interpreter (``release``)
_RELEASE_SLICE = 20_000


def _pow2_at_least(v: int, floor: int = 1) -> int:
    p = max(int(floor), 1)
    while p < v:
        p *= 2
    return p


def release(retired: dict) -> None:
    """Free a generation that ``_adopt_refresh`` replaced, after the
    caller has let go of the index lock: its probe tables a slice of
    buckets at a time, yielding the interpreter between slices (millions
    of bucket arrays freed in one statement would hold every other thread
    for most of a second), then its buffers."""
    for table in retired.pop("tables"):
        for entries in (table.buckets, table._id_key or {}):
            while entries:
                for _ in range(min(_RELEASE_SLICE, len(entries))):
                    entries.popitem()
                time.sleep(0)
    retired.clear()


class _Compaction:
    """In-flight incremental compaction: source snapshot + target buffers.

    ``src_*`` are the buffers as of ``begin_compaction``: rows [0, src_len)
    (base + frozen delta) are immutable there, so the copy loop reads them
    between steps even if insert growth swaps the index's buffers for
    larger ones.  ``src_active`` may then be stale; that only keeps a row
    deleted mid-compaction, and the swap re-checks liveness against the
    current mask.  ``bcap`` is the base row bucket at begin: only swaps
    move it, and one compaction runs at a time.
    """
    __slots__ = ("src_codes", "src_x", "src_ids", "src_active", "src_len",
                 "tgt_codes", "tgt_x", "tgt_ids", "new_row_of", "bcap",
                 "pos", "out", "uploading")

    def __init__(self, src_codes, src_x, src_ids, src_active, src_len,
                 tgt_codes, tgt_x, tgt_ids, new_row_of, bcap):
        self.src_codes = src_codes
        self.src_x = src_x
        self.src_ids = src_ids
        self.src_active = src_active
        self.src_len = src_len
        self.tgt_codes = tgt_codes
        self.tgt_x = tgt_x
        self.tgt_ids = tgt_ids
        self.new_row_of = new_row_of
        self.bcap = bcap
        self.pos = 0        # next source row to examine
        self.out = 0        # rows copied into the target so far
        self.uploading = False


class LSMMultiTableIndex(MultiTableIndex):
    """MultiTableIndex with an immutable base + mutable delta (see the
    module docstring).  Same query/insert/delete/compact API and stable-id
    contract; answers identical to the monolithic index's."""

    # Lock discipline (checked by the JAX package's static lint, which
    # walks every module under src/): each attribute below is read or
    # written only while holding the mapped lock.  Helpers that rely on
    # the caller's lock say so with a "lock held by caller" comment.
    _GUARDED_BY = {
        # segment geometry + growable host buffers
        "_rows": "_lock", "_base_len": "_lock", "_frozen_len": "_lock",
        "_codes_buf": "_lock", "_x_buf": "_lock", "_ids_buf": "_lock",
        "_active_buf": "_lock", "_row_of_buf": "_lock", "_bcap": "_lock",
        # segment versions
        "_base_version": "_lock", "_base_mask_version": "_lock",
        "_delta_version": "_lock",
        # device caches keyed by those versions
        "_base_codes_dev": "_lock", "_base_codes_key": "_lock",
        "_base_active_dev": "_lock", "_base_active_key": "_lock",
        "_base_x_dev": "_lock", "_base_x_key": "_lock",
        "_delta_codes_dev": "_lock", "_delta_x_dev": "_lock",
        "_delta_active_dev": "_lock", "_delta_key": "_lock",
        "_x_dev": "_lock", "_x_dev_key": "_lock",
        "_id_map_dev": "_lock", "_id_map_key": "_lock",
        # compaction state, counters, hash families and probe tables
        "_c": "_lock", "delta_uploads": "_lock",
        "families": "_lock", "tables": "_lock",
        # refresh lifecycle: codes hashed off the lock must pair with the
        # generation whose state they meet (insert, _scan_segments)
        "generation": "_lock", "refreshes": "_lock",
    }

    def __init__(self, config: IndexConfig, tables: int | None = None,
                 device="cuda"):
        super().__init__(config, tables, device)
        self._lock = threading.RLock()
        # delta device shapes never shrink below the compaction trigger
        # floor, so a fill -> compact cycle reuses a few allocation sizes
        self._delta_floor = _pow2_at_least(
            max(_MIN_CAP, int(config.lsm_delta_min)))
        self._bcap = _MIN_CAP       # sticky base row bucket
        # [0, base) immutable base; [base, base + frozen) frozen delta
        # (only while a compaction runs); [base + frozen, rows) live delta
        self._rows = 0
        self._base_len = 0
        self._frozen_len = 0
        # growable host buffers; the parent's attributes (codes / x_np /
        # active / ids_np / _row_of) are views of their prefixes
        self._codes_buf: np.ndarray | None = None   # (L, cap, W) uint32
        self._x_buf: np.ndarray | None = None       # (cap, d) f32
        self._ids_buf: np.ndarray | None = None     # (cap,) i64
        self._active_buf: np.ndarray | None = None  # (cap,) bool
        self._row_of_buf: np.ndarray | None = None  # (id_cap,) i64
        # the base changes at a swap; its mask on base deletes; the delta
        # on every insert and delta delete
        self._base_version = 0
        self._base_mask_version = 0
        self._delta_version = 0
        self._base_codes_dev = None
        self._base_codes_key = None
        self._base_active_dev = None
        self._base_active_key = None
        self._base_x_dev = None
        self._base_x_key = None
        self._delta_codes_dev = None
        self._delta_x_dev = None
        self._delta_active_dev = None
        self._delta_key = None
        self._id_map_dev = self._id_map_key = None   # row -> stable id
        self._x_dev_key = None          # the full-copy `x` property
        self._c: _Compaction | None = None
        self._compactor: threading.Thread | None = None
        self._compactor_stop = threading.Event()
        self.delta_uploads = 0   # small per-mutation transfers, not the base
        self.generation = 0      # refresh swaps adopted (_adopt_refresh)
        self.refreshes = 0

    # -- build ---------------------------------------------------------------

    def _keep_fit_features(self, x_dev: torch.Tensor) -> None:
        """The segments upload their own padded features on first use."""

    def restore(self, families, x, codes, active, ids_np,
                next_id: int) -> "LSMMultiTableIndex":
        """Adopt a complete index state as the base segment (the delta
        starts empty): the families, the (rows, d) features, the per-table
        (rows, W) uint32 codes, the tombstone mask, the row -> stable id map
        (ascending) and the id high-water mark.  The probe tables are built
        over the live rows, keyed by stable id.  ``fit`` lands here too."""
        if len(families) != self.num_tables or len(codes) != self.num_tables:
            raise ValueError(f"expected {self.num_tables} families and code "
                             f"tables, got {len(families)} and {len(codes)}")
        self._install(x, families, ids=ids_np, next_id=next_id,
                      codes=codes, active=active)
        return self

    def _install(self, x, families, ids=None, next_id: int | None = None,
                 bcap_floor: int = _MIN_CAP, codes=None,
                 active=None) -> None:
        """Build the whole segment state from scratch: rows [0, n) of x
        become the immutable base, the delta starts empty.  ids: the rows'
        stable ids (ascending; default 0..n-1); next_id: the id high-water
        mark (default past the last id); bcap_floor: the least base row
        bucket.  codes / active: the (L, n, W) uint32 codes and the
        tombstone mask when the caller has them (default: hash x under
        families; every row live).  A refresh shadow passes the live rows'
        existing stable ids, the live index's high-water mark and its
        sticky base bucket, so the swapped-in device state keeps its
        allocation sizes."""
        x = np.require(x, dtype=np.float32, requirements=["C"])
        n, d = x.shape
        if ids is None:
            ids = np.arange(n, dtype=np.int64)
        ids = np.asarray(ids, dtype=np.int64)
        active = (np.ones(n, bool) if active is None
                  else np.asarray(active, dtype=bool))
        if ids.shape != (n,) or active.shape != (n,):
            raise ValueError(f"ids and active must have shape ({n},)")
        if n and not (np.diff(ids) > 0).all():
            raise ValueError("stable ids must ascend with rows")
        hi = int(next_id if next_id is not None
                 else (ids[-1] + 1 if n else 0))
        if codes is None:
            codes = to_numpy_u32(bq.hash_database_all(families, x))
        codes = np.stack([np.asarray(c, dtype=np.uint32) for c in codes])
        cap = _pow2_at_least(n, _MIN_CAP)
        live = np.flatnonzero(active)
        tables = [SingleHashTable(codes[t, live], self.config.bits,
                                  ids=ids[live])
                  for t in range(self.num_tables)]
        with self._lock:
            self._codes_buf = np.zeros((self.num_tables, cap, codes.shape[2]),
                                       np.uint32)
            self._codes_buf[:, :n] = codes
            self._x_buf = np.zeros((cap, d), np.float32)
            self._x_buf[:n] = x
            self._ids_buf = np.zeros(cap, np.int64)
            self._ids_buf[:n] = ids
            self._active_buf = np.zeros(cap, bool)
            self._active_buf[:n] = active
            self._next_id = hi
            self._row_of_buf = np.full(_pow2_at_least(hi, _MIN_CAP), -1,
                                       np.int64)
            self._row_of_buf[ids] = np.arange(n)
            self._rows, self._base_len, self._frozen_len = n, n, 0
            self._bcap = _pow2_at_least(n, max(_MIN_CAP, int(bcap_floor)))
            self._c = None
            self.compactions = 0
            self.families = list(families)
            self._refresh_views()
            self.tables = tables
            self._base_version += 1
            self._base_mask_version += 1
            self._delta_version += 1
            self.version += 1

    def _refresh_views(self) -> None:
        """Re-point the parent's attributes at the buffer prefixes.  Views,
        not copies: ``self.active[rows] = False`` lands in the buffer, and
        the inherited helpers (rows_to_ids, ids_to_rows, mask_to_rows, n)
        work unchanged."""
        # lock held by caller
        r = self._rows
        self.codes = [self._codes_buf[t, :r] for t in range(self.num_tables)]
        self.x_np = self._x_buf[:r]
        self.active = self._active_buf[:r]
        self.ids_np = self._ids_buf[:r]
        self._row_of = self._row_of_buf[:self._next_id]

    def _grow_rows(self, need: int) -> None:
        # lock held by caller
        if need <= self._x_buf.shape[0]:
            return
        cap = _pow2_at_least(need, _MIN_CAP)
        r = self._rows
        codes = np.zeros((self.num_tables, cap, self._codes_buf.shape[2]),
                         np.uint32)
        codes[:, :r] = self._codes_buf[:, :r]
        x = np.zeros((cap, self._x_buf.shape[1]), np.float32)
        x[:r] = self._x_buf[:r]
        ids = np.zeros(cap, np.int64)
        ids[:r] = self._ids_buf[:r]
        act = np.zeros(cap, bool)
        act[:r] = self._active_buf[:r]
        self._codes_buf, self._x_buf = codes, x
        self._ids_buf, self._active_buf = ids, act

    def _grow_ids(self, need: int) -> None:
        # lock held by caller
        if need <= self._row_of_buf.shape[0]:
            return
        row_of = np.full(_pow2_at_least(need, _MIN_CAP), -1, np.int64)
        row_of[:self._next_id] = self._row_of_buf[:self._next_id]
        self._row_of_buf = row_of

    def _padded(self, a: np.ndarray, rows: int, axis: int = 0
                ) -> torch.Tensor:
        """Device copy of host array a, zero-padded along axis to rows
        (uint32 codes travel as their int32 bit carrier)."""
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        src = torch.from_numpy(a)
        shape = list(a.shape)
        shape[axis] = rows
        out = torch.zeros(shape, dtype=src.dtype, device=self.device)
        out.narrow(axis, 0, a.shape[axis]).copy_(src)
        return out

    # -- the full-copy `x` (not the serving path) ----------------------------

    @property
    def x(self) -> torch.Tensor:
        # the mutators never drop the parent's cached copy, so key it by
        # version; serving re-ranks gather from the segments instead
        with self._lock:
            if self._x_dev is None or self._x_dev_key != self.version:
                self._x_dev = self._padded(self.x_np, self.x_np.shape[0])
                self._x_dev_key = self.version
                self.device_uploads += 1
            return self._x_dev

    # -- dynamic updates -----------------------------------------------------

    def insert(self, x_new) -> np.ndarray:
        """Append rows to the live delta; returns the assigned stable ids.
        Amortised O(rows inserted): no concatenate, and the base's device
        state is untouched (only the small delta re-uploads)."""
        self._require_fit("insert")
        x_new = np.atleast_2d(np.asarray(x_new, np.float32))
        k = x_new.shape[0]
        if k == 0:
            return np.empty((0,), dtype=np.int64)
        # hash off the lock against a (families, generation) snapshot; a
        # refresh swap that lands meanwhile would file old-generation codes
        # under the new tables, so the (rare) loser hashes again
        while True:
            with self._lock:
                fams, gen = self.families, self.generation
            new_codes = to_numpy_u32(bq.hash_database_all(fams, x_new))
            with self._lock:
                if self.generation == gen:
                    ids = self._append_rows(x_new, new_codes)
                    break
        self._maybe_compact()
        return ids

    def _append_rows(self, x_new: np.ndarray, new_codes: np.ndarray,
                     ids: np.ndarray | None = None) -> np.ndarray:
        """Append pre-hashed rows to the live delta.  ids: fresh ones past
        the high-water mark (default, ``insert``) or the existing stable
        ids of the rows a refresh's catch-up mirrors into its shadow
        (ascending, past every id already here)."""
        k = x_new.shape[0]
        if k == 0:
            return np.empty((0,), dtype=np.int64)
        with self._lock:
            r0 = self._rows
            if ids is None:
                ids = np.arange(self._next_id, self._next_id + k,
                                dtype=np.int64)
            else:
                ids = np.asarray(ids, dtype=np.int64)
                if not (int(ids[0]) >= self._next_id
                        and bool((np.diff(ids) > 0).all())):
                    raise ValueError("appended ids must ascend past the "
                                     "high-water mark (row order = id order)")
            self._grow_rows(r0 + k)
            self._grow_ids(int(ids[-1]) + 1)
            self._codes_buf[:, r0:r0 + k] = new_codes
            self._x_buf[r0:r0 + k] = x_new
            self._ids_buf[r0:r0 + k] = ids
            self._active_buf[r0:r0 + k] = True
            self._row_of_buf[ids] = np.arange(r0, r0 + k, dtype=np.int64)
            self._next_id = max(self._next_id, int(ids[-1]) + 1)
            self._rows = r0 + k
            self._refresh_views()
            for t in range(self.num_tables):
                self.tables[t].insert(new_codes[t], ids)
            self._delta_version += 1
            self.version += 1
        return ids

    def delete(self, ids) -> None:
        """Tombstone rows: they stay in place until the next compaction
        folds them out; the scan masks them inside selection."""
        self._require_fit("delete")
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        if ids.size == 0:
            return
        if np.unique(ids).size != ids.size:
            raise KeyError("duplicate ids in delete")
        with self._lock:
            rows = self.ids_to_rows(ids)
            if not self.active[rows].all():
                raise KeyError("delete of already-deleted or unknown id")
            for t in range(self.num_tables):
                self.tables[t].delete(ids)
            self.active[rows] = False
            if (rows < self._base_len).any():
                self._base_mask_version += 1
            if (rows >= self._base_len).any():
                self._delta_version += 1
            self.version += 1
        self._maybe_compact()

    # -- incremental compaction ----------------------------------------------

    def _should_begin(self) -> bool:
        # lock held by caller
        if self.x_np is None or self._rows == 0:
            return False
        cfg = self.config
        delta = self._rows - self._base_len
        if delta >= max(cfg.lsm_delta_min,
                        int(cfg.lsm_delta_threshold * max(self._base_len, 1))):
            return True
        if cfg.compact_threshold is None:
            return False
        dead = self._rows - int(self._active_buf[:self._rows].sum())
        return dead > cfg.compact_threshold * self._rows

    def begin_compaction(self) -> bool:
        """Freeze the delta and set up the fold of base + frozen delta into
        a new base.  False when there is nothing to fold (no delta, no
        tombstones) or a compaction is already in flight."""
        with self._lock:
            if self._c is not None:
                return False
            src_len = self._rows
            if src_len == 0 or (self._base_len == src_len
                                and bool(self._active_buf[:src_len].all())):
                return False
            self._frozen_len = self._rows - self._base_len
            w, d = self._codes_buf.shape[2], self._x_buf.shape[1]
            # headroom past src_len: the live delta appended at the swap
            # usually fits without growing the target
            cap = _pow2_at_least(src_len + max(src_len // 4, _MIN_CAP),
                                 _MIN_CAP)
            self._c = _Compaction(
                src_codes=self._codes_buf, src_x=self._x_buf,
                src_ids=self._ids_buf, src_active=self._active_buf,
                src_len=src_len,
                tgt_codes=np.zeros((self.num_tables, cap, w), np.uint32),
                tgt_x=np.zeros((cap, d), np.float32),
                tgt_ids=np.zeros(cap, np.int64),
                new_row_of=np.full(max(self._next_id, 1), -1, np.int64),
                bcap=self._bcap)
            return True

    def compaction_step(self, max_rows: int | None = None) -> int:
        """Run one bounded unit of compaction work; returns the source rows
        examined (copy phase), 1 (upload + swap), or 0 (nothing in flight,
        or another caller owns the upload).  The copy and swap phases hold
        the lock for O(step) work, the pause a concurrent query can see;
        the one O(n) device upload between them runs off the lock."""
        with self._lock:
            c = self._c
            if c is None:
                return 0
            if c.pos < c.src_len:
                step = int(max_rows if max_rows is not None
                           else self.config.lsm_step_rows)
                lo = c.pos
                hi = min(lo + max(step, 1), c.src_len)
                live = np.flatnonzero(c.src_active[lo:hi]) + lo
                k = live.size
                if k:
                    o = c.out
                    c.tgt_codes[:, o:o + k] = c.src_codes[:, live]
                    c.tgt_x[o:o + k] = c.src_x[live]
                    ids = c.src_ids[live]
                    c.tgt_ids[o:o + k] = ids
                    c.new_row_of[ids] = np.arange(o, o + k, dtype=np.int64)
                    c.out = o + k
                c.pos = hi
                self.compaction_steps += 1
                return hi - lo
            if c.uploading:
                return 0
            c.uploading = True
        # the copy is complete: rows [0, c.out) of the target are final, so
        # the new base crosses to the device without blocking mutators
        try:
            dev_codes, dev_x = self._upload_new_base(c)
        except BaseException:
            with self._lock:
                c.uploading = False
            raise
        with self._lock:
            if self._c is not c:    # a restore() replaced the whole state
                return 0
            self._finish_swap(c, dev_codes, dev_x)
            self.compaction_steps += 1
        return 1

    def _upload_new_base(self, c: _Compaction):
        """The new base's codes and features on the device, padded to the
        sticky row bucket (at least the current one)."""
        n_new = c.out
        bcap = max(c.bcap, _pow2_at_least(n_new, _MIN_CAP))
        return (self._padded(c.tgt_codes[:, :n_new], bcap, axis=1),
                self._padded(c.tgt_x[:n_new], bcap))

    def _finish_swap(self, c: _Compaction, dev_codes, dev_x) -> None:
        # lock held by caller.  O(live delta) copies + pointer flips.
        live_lo = self._base_len + self._frozen_len
        live_len = self._rows - live_lo
        n_new = c.out
        need = n_new + live_len
        if c.tgt_x.shape[0] < need:
            cap = _pow2_at_least(need, _MIN_CAP)
            codes = np.zeros((self.num_tables, cap, c.tgt_codes.shape[2]),
                             np.uint32)
            codes[:, :n_new] = c.tgt_codes[:, :n_new]
            x = np.zeros((cap, c.tgt_x.shape[1]), np.float32)
            x[:n_new] = c.tgt_x[:n_new]
            ids = np.zeros(cap, np.int64)
            ids[:n_new] = c.tgt_ids[:n_new]
            c.tgt_codes, c.tgt_x, c.tgt_ids = codes, x, ids
        # the live delta tail stays the delta, renumbered after the new base
        c.tgt_codes[:, n_new:need] = self._codes_buf[:, live_lo:self._rows]
        c.tgt_x[n_new:need] = self._x_buf[live_lo:self._rows]
        live_ids = self._ids_buf[live_lo:self._rows].copy()
        c.tgt_ids[n_new:need] = live_ids
        active = np.zeros(c.tgt_x.shape[0], bool)
        if n_new:
            # liveness re-check against the CURRENT mask: rows deleted while
            # the copy ran (possibly from a stale snapshot) stay tombstoned
            # in the new base and fold out next cycle
            old_rows = self._row_of[c.tgt_ids[:n_new]]
            active[:n_new] = self._active_buf[old_rows]
        active[n_new:need] = self._active_buf[live_lo:self._rows]
        row_of = c.new_row_of
        if row_of.shape[0] < self._next_id:
            grown = np.full(_pow2_at_least(self._next_id, _MIN_CAP), -1,
                            np.int64)
            grown[:row_of.shape[0]] = row_of
            row_of = grown
        row_of[live_ids] = np.arange(n_new, need, dtype=np.int64)
        # the swap itself: pointer assignments and version bumps
        self._codes_buf, self._x_buf = c.tgt_codes, c.tgt_x
        self._ids_buf, self._active_buf = c.tgt_ids, active
        self._row_of_buf = row_of
        self._rows, self._base_len, self._frozen_len = need, n_new, 0
        self._refresh_views()
        self._base_version += 1
        self._base_mask_version += 1
        self._delta_version += 1
        self._bcap = int(dev_codes.shape[1])
        # the freshly uploaded single-device layout is current
        self._base_codes_dev = dev_codes
        self._base_codes_key = (self._base_version, None)
        self._base_x_dev, self._base_x_key = dev_x, self._base_version
        self.device_uploads += 2
        self.version += 1
        self.compactions += 1
        self._c = None

    # -- online refresh (serving.refresh drives this) ------------------------

    def _adopt_refresh(self, shadow: "LSMMultiTableIndex") -> dict:
        """Graft a shadow index's whole segment state (host buffers,
        families, probe tables, device caches) into this object by pointer
        flips: the generation swap.  Services and threads that hold this
        object see the new generation on their next locked read; a query
        that snapshotted the old device handles finishes on them.  An
        in-flight compaction is abandoned (``compaction_step`` re-checks).
        The shadow's device caches are adopted where their keys are
        current, so a warmed shadow serves its first query without an
        upload.  Returns the replaced generation, for the caller to free
        with ``release`` once it has let go of the lock: freeing it here
        would be most of the pause."""
        # lock held by caller
        retired = {"tables": self.tables, "compaction": self._c,
                   "buffers": (self._codes_buf, self._x_buf, self._ids_buf,
                               self._active_buf, self._row_of_buf),
                   "views": (self.codes, self.x_np, self.active, self.ids_np,
                             self._row_of),
                   "device": (self._base_codes_dev, self._base_active_dev,
                              self._base_x_dev, self._delta_codes_dev,
                              self._delta_x_dev, self._delta_active_dev,
                              self._x_dev)}
        with shadow._lock:
            self._codes_buf = shadow._codes_buf
            self._x_buf = shadow._x_buf
            self._ids_buf = shadow._ids_buf
            self._active_buf = shadow._active_buf
            # ids past the shadow's high-water mark (rows inserted and
            # deleted before the swap) resolve to -1, as deleted ids do
            hi = max(self._next_id, shadow._next_id)
            row_of = shadow._row_of_buf
            if row_of.shape[0] < hi:
                row_of = np.full(_pow2_at_least(hi, _MIN_CAP), -1, np.int64)
                row_of[:shadow._row_of_buf.shape[0]] = shadow._row_of_buf
            self._row_of_buf = row_of
            self._rows = shadow._rows
            self._base_len = shadow._base_len
            self._frozen_len = 0
            self._bcap = shadow._bcap
            self._next_id = hi
            self.families = shadow.families
            self.tables = shadow.tables
            self._refresh_views()
            self._base_version += 1
            self._base_mask_version += 1
            self._delta_version += 1
            if shadow._base_codes_key == (shadow._base_version, None):
                self._base_codes_dev = shadow._base_codes_dev
                self._base_codes_key = (self._base_version, None)
            else:
                self._base_codes_dev, self._base_codes_key = None, None
            if shadow._base_active_key == (shadow._base_version,
                                           shadow._base_mask_version):
                self._base_active_dev = shadow._base_active_dev
                self._base_active_key = (self._base_version,
                                         self._base_mask_version)
            else:
                self._base_active_dev, self._base_active_key = None, None
            if shadow._base_x_key == shadow._base_version:
                self._base_x_dev = shadow._base_x_dev
                self._base_x_key = self._base_version
            else:
                self._base_x_dev, self._base_x_key = None, None
            self._id_map_dev, self._id_map_key = (   # keep its base part
                (shadow._id_map_dev, (self._base_version, None))
                if (shadow._id_map_key or (None,))[0] == shadow._base_version
                else (None, None))
            if (shadow._delta_key == shadow._delta_version
                    and shadow._rows > shadow._base_len):
                self._delta_codes_dev = shadow._delta_codes_dev
                self._delta_x_dev = shadow._delta_x_dev
                self._delta_active_dev = shadow._delta_active_dev
                self._delta_key = self._delta_version
            else:
                self._delta_codes_dev = self._delta_x_dev = None
                self._delta_active_dev = self._delta_key = None
            self._x_dev, self._x_dev_key = None, None
            self.device_uploads += shadow.device_uploads
            self.scan_state_rebuilds += shadow.scan_state_rebuilds
            self.delta_uploads += shadow.delta_uploads
        self._c = None
        self.version += 1
        self.generation += 1
        self.refreshes += 1
        return retired

    def compact(self) -> np.ndarray:
        """Synchronous full compaction: begin, every incremental step and
        the swap.  Returns the surviving stable ids; a no-op when there is
        nothing to fold."""
        self._require_fit("compact")
        with self._lock:
            started = self._c is not None or self.begin_compaction()
            if not started:
                return self.ids_np[self.active].copy()
        while True:
            with self._lock:
                if self._c is None:
                    break
            if self.compaction_step() == 0:
                time.sleep(1e-4)   # another caller owns the upload phase
        with self._lock:
            return self.ids_np[self.active].copy()

    def _maybe_compact(self) -> None:
        """Piggybacked compaction: begin past the thresholds, then pay one
        bounded step per index call (queries included)."""
        if not self.config.lsm_auto:
            return
        with self._lock:
            if self._c is None and self._should_begin():
                self.begin_compaction()
            active = self._c is not None
        if active:
            self.compaction_step()

    def start_compactor(self, interval_s: float = 0.002) -> None:
        """Drive incremental compaction from a daemon thread (besides any
        piggybacking on index calls); ``stop_compactor`` joins it."""
        if self._compactor is not None:
            return
        self._compactor_stop.clear()

        def loop():
            while not self._compactor_stop.is_set():
                did = 0
                with self._lock:
                    if (self._c is None and self.x_np is not None
                            and self._should_begin()):
                        self.begin_compaction()
                    active = self._c is not None
                if active:
                    did = self.compaction_step()
                if not did:
                    self._compactor_stop.wait(interval_s)

        self._compactor = threading.Thread(target=loop, name="lsm-compactor",
                                           daemon=True)
        self._compactor.start()

    def stop_compactor(self) -> None:
        if self._compactor is None:
            return
        self._compactor_stop.set()
        self._compactor.join()
        self._compactor = None

    # -- device segment states -----------------------------------------------

    def _base_codes_state(self, mesh=None, axis: str = "data"):
        # lock held by caller.  Keyed by (base version, layout): without a
        # mesh (L, bcap, W) int32, padding rows zero; with one the
        # per-shard layout of the base rows (core.search.shard_rows)
        layout = None if mesh is None else (mesh, axis)
        key = (self._base_version, layout)
        if self._base_codes_key != key:
            base = self._codes_buf[:, :self._base_len]
            self._base_codes_dev = (
                self._padded(base, self._bcap, axis=1) if mesh is None
                else shard_rows(base, mesh, axis))
            self._base_codes_key = key
            self.scan_state_rebuilds += 1
            self.device_uploads += 1
        return self._base_codes_dev

    def _base_active_state(self):
        # lock held by caller; (bcap,) bool, padding rows False
        key = (self._base_version, self._base_mask_version)
        if self._base_active_key != key:
            self._base_active_dev = self._padded(
                self._active_buf[:self._base_len], self._bcap)
            self._base_active_key = key
            self.device_uploads += 1
        return self._base_active_dev

    def _base_x_state(self):
        # lock held by caller; (bcap, d) f32, padding rows zero
        if self._base_x_key != self._base_version:
            self._base_x_dev = self._padded(self._x_buf[:self._base_len],
                                            self._bcap)
            self._base_x_key = self._base_version
            self.device_uploads += 1
        return self._base_x_dev

    def _delta_state(self):
        # lock held by caller; codes / x / active padded to a power-of-two
        # row bucket no smaller than the delta floor
        if self._delta_key != self._delta_version:
            lo, hi = self._base_len, self._rows
            dcap = _pow2_at_least(hi - lo, self._delta_floor)
            self._delta_codes_dev = self._padded(self._codes_buf[:, lo:hi],
                                                 dcap, axis=1)
            self._delta_x_dev = self._padded(self._x_buf[lo:hi], dcap)
            self._delta_active_dev = self._padded(self._active_buf[lo:hi],
                                                  dcap)
            self._delta_key = self._delta_version
            self.delta_uploads += 1
            self.device_uploads += 1
        return (self._delta_codes_dev, self._delta_x_dev,
                self._delta_active_dev)

    def _id_map_state(self):
        # lock held by caller; (rows,) int64 row -> stable id for kernel 9:
        # the base's part crosses once a base version (later maps keep it),
        # the delta's when the delta does; not counted among the uploads
        key = (self._base_version, self._delta_version)
        if self._id_map_key != key:
            split, rows = self._base_len, self._rows
            base = (self._id_map_dev[:split]
                    if (self._id_map_key or (None,))[0] == self._base_version
                    else self._padded(self._ids_buf[:split], split))
            self._id_map_dev = torch.cat([base, self._padded(
                self._ids_buf[split:rows], rows - split)])
            self._id_map_key = key
        return self._id_map_dev

    def upload_base(self) -> None:
        """Put the base segment's device state (codes, liveness, features,
        stable ids) on the device now, so that the next scan does not pay
        the upload inside its call."""
        with self._lock:
            if self._base_len:
                self._base_codes_state()
                self._base_active_state()
                self._base_x_state()
                self._id_map_state()

    # -- probe path ----------------------------------------------------------

    def lookup_batch(self, w, qcodes: np.ndarray | None = None):
        """Probe path: the tables are id-keyed (they survive compaction),
        so the parent's lookup returns stable ids; translate them to the
        ROW space the lookup contract promises.  Ids ascend with rows, so
        the probe order carries over unchanged."""
        with self._lock:
            cands, hits, secs = super().lookup_batch(w, qcodes)
            t0 = time.perf_counter()
            cands = [self.ids_to_rows(c) if c.size else c.astype(np.int64)
                     for c in cands]
            return cands, hits, secs + time.perf_counter() - t0

    def rerank_rows(self, w, cands: list[np.ndarray], l: int = 1,
                    mask_rows=None):
        """Segmented exact-margin re-rank: base rows gather from the
        device-resident base features, delta rows from the small delta
        upload; equal to the parent's gather over the full rows."""
        ids, valid = bq.pad_candidates(cands)
        if mask_rows is not None:
            valid &= np.asarray(mask_rows, bool)[ids]
        nonempty = valid.any(axis=1)
        w = np.atleast_2d(np.asarray(w, np.float32))
        with self._lock:
            rerank = self._on_features(margin_rerank_batch,
                                       margin_rerank_segmented)
        dev = self.device
        margins, top = rerank(bq.as_float_tensor(w, dev),
                              torch.from_numpy(ids).to(dev),
                              torch.from_numpy(valid).to(dev), l)
        margins = margins.cpu().numpy()
        top = top.cpu().numpy().astype(np.int64)
        top[~np.isfinite(margins)] = -1
        return top, margins, nonempty

    def _on_features(self, one, two):
        # lock held by caller.  core.search's margin function one (x, ...)
        # over the features of the one segment with rows, or its segmented
        # form two (base_x, delta_x, split, ...) over both; global rows
        split = self._base_len
        base_x = self._base_x_state() if split else None
        delta_x = self._delta_state()[1] if self._rows > split else None
        if base_x is None or delta_x is None:
            return functools.partial(one, base_x if delta_x is None
                                     else delta_x)
        return functools.partial(two, base_x, delta_x, split)

    def query_batch(self, w, mask=None, l: int = 1) -> BatchQueryResult:
        with self._lock:
            res = super().query_batch(w, mask, l)
        self._maybe_compact()
        return res

    # -- scan path -----------------------------------------------------------

    def _scan_segment(self, codes_dev, qcodes, l: int, active_dev,
                      fused: bool):
        """One segment's top-l LIVE candidates, (L, B, l), lex-sorted,
        segment-local rows: exactly l deep with the liveness mask (False
        for tombstones and padding rows) applied inside selection."""
        cfg = self.config
        if fused:
            return ops.hamming_topk_grouped(codes_dev, qcodes, l,
                                            select=cfg.fused_select,
                                            active=active_dev,
                                            pack=cfg.cand_pack)
        return search.hamming_topk_grouped(codes_dev, qcodes, l,
                                           select=cfg.fused_select,
                                           active=active_dev)

    def _scan_base_sharded(self, codes, qcodes, l: int, split: int,
                           dead: int, active_dev, mesh, axis: str):
        """The base segment's top-l LIVE candidates over a mesh, (L, B, l),
        lex-sorted, base rows.  The sharded scan masks the padding past
        ``split`` itself; tombstones take the slack rule: scan l + dead
        deep (a power of two, at most the segment's), then drop them."""
        cfg = self.config
        depth = (l if not dead else min(_pow2_at_least(l + dead),
                                        _pow2_at_least(split, _MIN_CAP)))
        d, i = hamming_topk_grouped_sharded(
            codes, qcodes, depth, mesh, axis, n_valid=split,
            select=cfg.fused_select, pack=cfg.cand_pack)
        return drop_tombstones_topk(d, i, active_dev, l) if dead else (d, i)

    def _scan_segments(self, w: np.ndarray, l: int, mesh=None,
                       axis: str = "data"):
        """Hash w and scan both segments (the base over ``mesh`` when one
        is given); the per-table top-l over the live rows, merged:
        (snapshot, dists (L, B, l), rows (L, B, l)) with global rows (-1
        in empty slots), or None when no row is live.  The geometry and
        the device handles are snapshotted under one lock hold, so a
        concurrent compaction swap makes the answer reflect the state
        wholly before or wholly after it."""
        with self._lock:
            split, rows = self._base_len, self._rows
            if not self._active_buf[:rows].any():
                return None
            snap = dict(rows=rows, ids=self.ids_np,
                        id_map=self._id_map_state(),
                        rerank=self._on_features(margin_rerank_batch,
                                                 margin_rerank_segmented))
            # tombstones in the base: only the sharded scan needs them
            dead = (split - int(self._active_buf[:split].sum())
                    if split and mesh is not None else 0)
            base = ((self._base_codes_state(mesh, axis),
                     self._base_active_state(), dead)
                    if split else None)
            delta = self._delta_state() if rows > split else None
            fams = self.families
        qcodes = bq.hash_queries_all(fams, w)                    # (L, B, W)
        d_m = i_m = None
        if base is not None and mesh is not None:
            d_m, i_m = self._scan_base_sharded(base[0], qcodes, l, split,
                                               base[2], base[1], mesh, axis)
        elif base is not None:
            d_m, i_m = self._scan_segment(base[0], qcodes, l, base[1], True)
        if delta is not None:
            codes_d, _, active_d = delta
            fused = rows - split >= self.config.lsm_delta_fused_rows
            d_d, i_d = self._scan_segment(codes_d, qcodes, l, active_d, fused)
            i_d = torch.where(i_d < 0, -1, i_d + split)   # to global rows
            if d_m is None:
                d_m, i_m = d_d, i_d
            else:
                d_m, i_m = merge_topk_segments(d_m, i_m, d_d, i_d, l)
        return snap, d_m, i_m

    def query_scan_batch(self, w, l: int = 16, topk: int = 1, mask=None,
                         mesh=None, shard_axis: str = "data"
                         ) -> BatchQueryResult:
        """Two-segment fused scan (the parent's l / topk / mask / mesh
        contract): both segments scanned and merged through
        merge_topk_segments (``_scan_segments``), then the monolithic
        index's answer stage (``multi_table.answer_slots``: union, kernel
        9's lists, one read-back) over global rows, with the segmented
        exact re-rank."""
        if mesh is not None:
            shard_count(mesh, shard_axis)
        self._require_fit("query_scan_batch")
        w = np.atleast_2d(np.asarray(w, np.float32))
        scanned = self._scan_segments(w, l, mesh, shard_axis)
        if scanned is None:
            return empty_answer(w.shape[0], topk, self.num_tables)
        snap, _, i_m = scanned
        res = answer_slots(w, i_m, topk, mask, self.device, snap["id_map"],
                           snap["ids"], snap["rerank"])
        self._maybe_compact()
        return res

    def scan_table_topk(self, w, l: int = 16, mesh=None,
                        shard_axis: str = "data"
                        ) -> tuple[np.ndarray, np.ndarray]:
        """The parent's per-table Hamming top-l before the union, in
        stable-id space: both segments merged before translating to ids,
        so each list carries the (distance, id) order of a monolithic
        scan over the live rows."""
        if mesh is not None:
            shard_count(mesh, shard_axis)
        self._require_fit("scan_table_topk")
        w = np.atleast_2d(np.asarray(w, np.float32))
        scanned = self._scan_segments(w, l, mesh, shard_axis)
        if scanned is None:
            shape = (self.num_tables, w.shape[0], l)
            return (np.full(shape, DIST_SENTINEL, np.int32),
                    np.full(shape, -1, np.int64))
        snap, d_m, i_m = scanned
        i_np = i_m.cpu().numpy().astype(np.int64)
        ids = np.where(i_np >= 0,
                       snap["ids"][np.clip(i_np, 0, snap["rows"] - 1)], -1)
        return d_m.cpu().numpy(), ids

    def candidate_margins(self, w, cand_ids: np.ndarray) -> np.ndarray:
        """Segmented margins by stable id: (B, C) float32, +inf at padding
        (-1) or ids that no longer resolve; equal to the parent's."""
        self._require_fit("candidate_margins")
        w = np.atleast_2d(np.asarray(w, np.float32))
        cand_ids = np.asarray(cand_ids, dtype=np.int64)
        with self._lock:
            margins = self._on_features(margin_batch, margin_batch_segmented)
            next_id = self._next_id
            row_of = self._row_of          # old buffers stay valid views
        known = (cand_ids >= 0) & (cand_ids < next_id)
        rows = np.zeros(cand_ids.shape, dtype=np.int64)
        rows[known] = row_of[cand_ids[known]]
        valid = known & (rows >= 0)
        rows[~valid] = 0
        dev = self.device
        return margins(bq.as_float_tensor(w, dev),
                       torch.from_numpy(rows).to(dev),
                       torch.from_numpy(valid).to(dev)).cpu().numpy()

    # -- counters ------------------------------------------------------------

    def segments(self) -> dict:
        """The segment geometry: base, frozen and delta rows, and whether a
        compaction is in flight; cheap, unlike ``stats()`` (which walks
        every bucket of every table)."""
        with self._lock:
            return {"base_rows": self._base_len,
                    "delta_rows": self._rows - self._base_len,
                    "frozen_rows": self._frozen_len,
                    "compaction_active": self._c is not None}

    def stats(self) -> dict:
        with self._lock:
            st = super().stats()
            st.update(self.segments(), backend="lsm",
                      delta_uploads=self.delta_uploads)
        return st
