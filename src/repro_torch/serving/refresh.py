"""Online re-learning with a zero-downtime generation swap.

A served index learns its projections once, at ``fit``, and the rows it
serves drift away from the rows it learned on.  ``RefreshManager``
re-learns the families from the rows the index holds now and swaps the
rebuilt index in under live traffic.  One refresh runs in five phases, all
but the last off the query path:

1. **snapshot**: under the index lock, copy the live rows (features and
   stable ids), the id high-water mark, the generation and the base row
   bucket; release the lock.
2. **learn**: re-learn the per-table families from the snapshot through
   ``core.indexer.make_family`` (the one place a family is drawn or
   learned), under ``seed = functions.table_seed(config.seed, _LEARN_TAG +
   generation + 1)``: the same snapshot, seed and generation give the same
   families.  Fit-time tables use table_seed(config.seed, t) with t < L, so
   the two namespaces are disjoint.  With ``config.refresh_traffic_sample``
   the learning pool narrows to the snapshot rows with the smallest margin
   to recently served query normals.  On the card each table's LBH bits
   replay a CUDA graph captured on this (worker) thread.
3. **build**: hash the snapshot under the new families and install it as a
   private shadow ``LSMMultiTableIndex`` keyed by the ORIGINAL stable ids,
   its base bucket at least the live one.
4. **catch-up and warm-up**: rows inserted meanwhile (ids past the
   snapshot's high-water mark) are hashed under the new families and
   appended to the shadow's delta, until the gap stops moving; then, for
   a scanning service, the shadow's base goes to the device before the
   swap instead of inside the first query after it (``_warm``).
5. **swap**: one bounded critical section under the index lock: the last
   catch-up, a liveness reconcile (rows deleted meanwhile are tombstoned in
   the shadow) and ``LSMMultiTableIndex._adopt_refresh``'s pointer flips.
   This is the only pause a query can see (``last_swap_pause_ms``); the
   old generation is freed after it (``serving.lsm.release``).

Swap semantics: the index object survives (services keep their
reference); queries that snapshotted the old device handles finish on the
old generation, so no answer mixes generations; ``version`` and
``generation`` bump; stable ids survive.  Answers change across the swap
by design: the projections changed.

The JAX package folds the generation into a ``jax.random`` key, which
torch cannot reproduce, and pads its catch-up hash to power-of-two row
buckets to save jit traces; the port derives its seed from ``table_seed``
and hashes each catch-up at its own size.  Parity tests carry the JAX
shadow's families in through the learning seam (``_learn_families``).

Lock order: ``index._lock`` then ``shadow._lock``, never the reverse.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import functions as F
from repro_torch.core.indexer import make_family
from repro_torch.serving import batch_query as bq
from repro_torch.serving.lsm import LSMMultiTableIndex, release
from repro_torch.utils.bits import to_numpy_u32

# re-learn seed namespace: table_seed(config.seed, _LEARN_TAG + generation)
_LEARN_TAG = 0x5EED
# snapshot rows whose margins to the recent normals are held at once by
# the traffic-weighted pool: 65,536 x 256 float32 is 64 MB
POOL_ROW_CHUNK = 65_536


def learn_seed(seed: int, generation: int) -> int:
    """The seed the re-learn that makes generation + 1 uses."""
    return F.table_seed(seed, _LEARN_TAG + int(generation) + 1)


class RefreshManager:
    """Drives the re-learn, the shadow build and the generation swap of one
    ``LSMMultiTableIndex``.  At most one refresh runs at a time; a trigger
    while one runs is coalesced (``refresh`` returns False).  Thread-safe.
    """

    # The manager lock owns only the lifecycle flag and the worker handle;
    # the last_* / refreshes_* counters are written by the one refresh in
    # flight and read without the lock by stats().
    _GUARDED_BY = {"_busy": "_mu", "_thread": "_mu"}

    def __init__(self, index: LSMMultiTableIndex, recent_queries: int = 256):
        self.index = index
        self._mu = threading.Lock()
        self._busy = False
        self._thread: threading.Thread | None = None
        # recently served query normals for the traffic-weighted pool;
        # deque appends are atomic, so serving threads append lock-free
        self._recent_w: deque[np.ndarray] = deque(maxlen=int(recent_queries))
        self.refreshes_started = 0
        self.refreshes_done = 0
        self.refreshes_failed = 0
        self.last_error: str | None = None
        self.last_learn_s = 0.0
        self.last_build_s = 0.0
        self.last_swap_pause_s = 0.0
        self.last_catchup_rows = 0
        self.last_refresh_s = 0.0

    # -- traffic observation -------------------------------------------------

    def note_queries(self, ws) -> None:
        """Record served query normals (the service calls this per batch)."""
        for w in np.atleast_2d(np.asarray(ws, np.float32)):
            self._recent_w.append(w)

    def _learning_pool(self, x_snap: np.ndarray) -> torch.Tensor:
        """The rows the re-learn samples from, on the index's device.
        Default: the whole snapshot (``make_family`` subsamples
        ``lbh_sample`` of them, seeded).  With refresh_traffic_sample and
        recent normals on record: the min(n, 4 lbh_sample) rows with the
        smallest margin |x.w| / ||w|| to any of them, in row order; the
        margins are computed on the device in row chunks (strict fp32), and
        a stable argsort keeps ties in row order."""
        cfg = self.index.config
        dev = self.index.device
        recent = list(self._recent_w)
        if not cfg.refresh_traffic_sample or not recent:
            return bq.as_float_tensor(x_snap, dev)
        w = torch.from_numpy(np.stack(recent)).to(dev)          # (R, d)
        norms = torch.linalg.vector_norm(w, dim=1)
        norms = torch.where(norms == 0, 1.0, norms)
        n = x_snap.shape[0]
        near = torch.empty(n, dtype=torch.float32, device=dev)
        for s in range(0, n, POOL_ROW_CHUNK):
            xs = bq.as_float_tensor(x_snap[s:s + POOL_ROW_CHUNK], dev)
            with F.strict_fp32():
                near[s:s + xs.shape[0]] = ((xs @ w.T).abs() / norms).amin(1)
        pool_n = min(n, max(4 * cfg.lbh_sample, cfg.lbh_sample))
        keep = torch.sort(torch.argsort(near, stable=True)[:pool_n]).values
        return bq.as_float_tensor(x_snap[keep.cpu().numpy()], dev)

    def _learn_families(self, shadow_cfg, pool: torch.Tensor) -> list:
        """The shadow's per-table families, learned from the pool: the one
        seam every family of a refresh comes through."""
        return [make_family(shadow_cfg, pool, t)
                for t in range(self.index.num_tables)]

    # -- trigger -------------------------------------------------------------

    def refresh(self, wait: bool = True, warm: bool = False) -> bool:
        """Run one refresh.  wait=False runs it on a daemon worker
        (``wait_idle`` joins it).  Returns False when a refresh is already
        in flight (the trigger is coalesced) or the index has no live rows.
        warm: put the shadow's base on the device before the swap (a
        scanning service asks for it; the JAX package's warm scan batches,
        which pre-compile its traces, have nothing to compile here)."""
        with self._mu:
            if self._busy:
                return False
            self._busy = True
            self.refreshes_started += 1
        if wait:
            return self._run_guarded(warm)
        t = threading.Thread(target=self._run_guarded, args=(warm, False),
                             name="index-refresh", daemon=True)
        with self._mu:
            self._thread = t
        t.start()
        return True

    def wait_idle(self, timeout: float | None = None) -> None:
        """Join the background refresh in flight, if any."""
        with self._mu:
            t = self._thread
        if t is not None:
            t.join(timeout)

    def _run_guarded(self, warm: bool, reraise: bool = True) -> bool:
        """Run one refresh and always release the busy flag.  Phases 1-4
        only read the live index (the shadow is private), so a failure
        before the swap leaves the live generation as it was, no lock held
        and the next ``refresh()`` free to run.  wait=True callers get the
        exception; the background worker records it (``last_error``,
        ``refreshes_failed``)."""
        try:
            ok = self._run(warm)
        except BaseException as e:
            self.refreshes_failed += 1
            self.last_error = f"{type(e).__name__}: {e}"
            if reraise:
                raise
            return False
        else:
            self.last_error = None
            return ok
        finally:
            with self._mu:
                self._busy = False

    # -- the refresh ---------------------------------------------------------

    def _run(self, warm: bool) -> bool:
        idx = self.index
        cfg = idx.config
        t_all = time.perf_counter()
        # phase 1: snapshot the live rows and the id high-water mark
        with idx._lock:
            if idx.x_np is None:
                return False
            live = np.flatnonzero(idx._active_buf[:idx._rows])
            ids_snap = idx._ids_buf[live].copy()
            x_snap = idx._x_buf[live].copy()
            seen = int(idx._next_id)
            gen = int(idx.generation)
            bcap = int(idx._bcap)
        if x_snap.shape[0] == 0:
            return False

        # phase 2: re-learn the families off the query path
        t0 = time.perf_counter()
        shadow_cfg = dataclasses.replace(cfg, method=cfg.refresh_method,
                                         lsm_auto=False,
                                         seed=learn_seed(cfg.seed, gen))
        shadow = LSMMultiTableIndex(shadow_cfg, tables=idx.num_tables,
                                    device=idx.device)
        pool = self._learning_pool(x_snap)
        fams = self._learn_families(shadow_cfg, pool)
        del pool
        self.last_learn_s = time.perf_counter() - t0

        # phase 3: the snapshot becomes the shadow's base, keyed by the
        # original stable ids, its row bucket at least the live one
        t0 = time.perf_counter()
        shadow._install(x_snap, fams, ids=ids_snap, next_id=seen,
                        bcap_floor=bcap)

        # phase 4: catch up on rows inserted while we learned, then warm
        caught = 0
        for _ in range(16):
            seen2, k = self._catchup_round(shadow, fams, seen)
            caught += k
            if seen2 == seen:
                break
            seen = seen2
        if warm:
            self._warm(shadow)
        self.last_build_s = time.perf_counter() - t0

        # phase 5: the swap, the only pause traffic can see
        t0 = time.perf_counter()
        with idx._lock:
            # the lock is held: no id can appear after this round
            _, k = self._catchup_round(shadow, fams, seen)
            caught += k
            self._reconcile_deletes(shadow)
            retired = idx._adopt_refresh(shadow)
        self.last_swap_pause_s = time.perf_counter() - t0
        release(retired)
        self.last_catchup_rows = caught
        self.last_refresh_s = time.perf_counter() - t_all
        self.refreshes_done += 1
        return True

    def _catchup_round(self, shadow: LSMMultiTableIndex, fams,
                       seen: int) -> tuple[int, int]:
        """Mirror the live rows with ids in [seen, the live high-water mark)
        into the shadow's delta, hashed under the new families.  Returns
        the new high-water mark and the rows appended.  Rows already
        deleted are skipped (rows deleted after their mirror are handled by
        ``_reconcile_deletes`` at the swap)."""
        idx = self.index
        with idx._lock:
            hi = int(idx._next_id)
            if hi <= seen:
                return hi, 0
            cand = np.arange(seen, hi, dtype=np.int64)
            rows = idx._row_of_buf[cand]
            ok = rows >= 0
            rows_ok = rows[ok]
            act = idx._active_buf[rows_ok]
            ids_new = cand[ok][act]
            x_new = idx._x_buf[rows_ok[act]].copy()
        k = x_new.shape[0]
        if k == 0:
            return hi, 0
        codes = to_numpy_u32(bq.hash_database_all(fams, x_new))
        shadow._append_rows(x_new, codes, ids=ids_new)
        return hi, k

    def _reconcile_deletes(self, shadow: LSMMultiTableIndex) -> None:
        """Tombstone in the shadow every row the live index deleted after
        the row was snapshotted or mirrored.  Runs under the live lock at
        the swap, so the live mask cannot move underneath it."""
        idx = self.index
        with shadow._lock:
            srows = np.flatnonzero(shadow._active_buf[:shadow._rows])
            sids = shadow._ids_buf[srows]
        rows = idx._row_of_buf[sids]
        ok = rows >= 0
        alive = np.zeros(sids.size, dtype=bool)
        alive[ok] = idx._active_buf[rows[ok]]
        dead = sids[~alive]
        if dead.size:
            shadow.delete(dead)

    def _warm(self, shadow: LSMMultiTableIndex) -> None:
        """Upload the shadow's base (codes, liveness, features) before the
        swap; ``_adopt_refresh`` adopts those copies, so the first query of
        the new generation pays no upload inside its batch."""
        shadow.upload_base()

    # -- counters ------------------------------------------------------------

    def stats(self) -> dict:
        with self._mu:
            busy = self._busy
        return {
            "busy": busy,
            "refreshes_started": self.refreshes_started,
            "refreshes_done": self.refreshes_done,
            "refreshes_failed": self.refreshes_failed,
            "last_error": self.last_error,
            "last_learn_s": self.last_learn_s,
            "last_build_s": self.last_build_s,
            "last_swap_pause_ms": 1e3 * self.last_swap_pause_s,
            "last_catchup_rows": self.last_catchup_rows,
            "last_refresh_s": self.last_refresh_s,
            "recent_queries": len(self._recent_w),
        }
