"""Replicated-shard serving: R-way replicated row shards behind one router.

``ShardReplicaRouter`` splits the row space round-robin over S shards, each
served by R replica ``LSMMultiTableIndex`` instances built from the same
``IndexConfig`` (same seed, so the same families everywhere: replicas, and
a fresh reference index, are interchangeable bit for bit).  Every replica
interaction crosses one seam (``_guarded_call``) where a
``serving.faults.FaultPlan`` injects deterministic faults.  The replicas
live in this process; their scans run on the router's thread pools.

Query protocol (the degraded-answer contract):

1. **Scan, per shard**: one healthy replica per shard (rotated per query)
   returns its per-table Hamming top-l before any merge, in stable-id
   space (``scan_table_topk``).  The shards run in parallel under a
   deadline; a timeout or an injected fault retries the sibling replica
   after a backoff (the failover ladder).  Shards whose replicas are all
   down or late are left out.
2. **Merge at the Hamming level**: shard-local ids map to global ids and
   the per-table lists merge by (distance, global id)
   (``core.search.merge_topk_shards``).  Any row of the covered rows'
   top-l is in its own shard's top-l, so the merged lists equal one scan
   over the covered rows, ties and l > n sentinels included.
3. **Re-rank the merged union**: each covered shard computes exact margins
   for the candidates it owns (``candidate_margins``, the margin expression
   of every re-rank path, so the values do not depend on which index
   computes them), and the router keeps the top-k by ascending
   (margin, global id).

The result is a ``BatchQueryResult`` with ``coverage`` (the fraction of
live rows scanned) and ``degraded`` (coverage < 1).  A fully covered answer
equals a monolithic index's over all rows; a partial one equals a fresh
index's over the covered shards' rows.  When every shard is down the
router answers with coverage 0.0 and all ids -1.

Health: a replica that fails (or times out) ``fail_threshold`` times leaves
the rotation; every query then probes the downed replicas through the same
seam, and ``readmit_probes`` consecutive successes re-admit one
(hysteresis).  A replica that missed writes while down first catches up
through the refresh's shadow-build path: ``_install`` a shadow from the
router's own row log, then ``_adopt_refresh`` it in, so re-admission is
atomic and the recovered replica answers bit for bit.

Writes: the router owns the logical row log (per-shard feature rows,
global <-> local id maps, liveness); ``insert`` / ``delete`` land there
first and then go to every current replica, so a write succeeds logically
with a whole shard down.  The ids the router hands out are global;
replica-local ids are positions in the shard's append-only row log, which
ascend with global ids, so the (distance, id) tie order carries over.

**Deviation from the JAX package.**  Its ``_attempt`` / ``_shard_ladder``
turn any exception of a replica call into a replica failure and a degraded
answer.  Here only the failures a replica can have count: an injected
``faults.FaultError`` and a ``ShardCallTimeout``.  Every other exception
(a kernel wrapper's or the kernel build's ``RuntimeError``, a CUDA error,
a caller's ``ValueError``) propagates out of the query or the write, with
no replica marked down: a scan kernel that fails to build or launch must
fail the call, not show up as ``coverage < 1``.  Two such errors cannot
propagate at once, and are recorded on the replica instead
(``_ReplicaHealth.error``), which goes out of rotation:

- a write push that raises leaves its replica behind the log; the write
  is committed to the router's log all the same (ids assigned, the other
  replicas updated), and the error is raised after every push was tried;
- a call abandoned at its deadline that then ends in such an error.

While a replica is out of rotation for a recorded error, every query and
every write raises that error (a write before it touches the log), and no
query answers degraded in its place.  Re-admission clears it: probes,
then the catch-up, which hashes the shard's rows again and so raises the
error anew if its cause persists.  The deadline does not count a kernel
library's first-use build (``kernels._build.building``); on the card the
router loads every library at construction, outside any deadline.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout

import numpy as np

from repro_torch.core.indexer import IndexConfig, make_family
from repro_torch.core.search import DIST_SENTINEL, merge_topk_shards
from repro_torch.kernels import _build, ops
from repro_torch.serving.faults import FaultError, FaultPlan
from repro_torch.serving.lsm import (_MIN_CAP, LSMMultiTableIndex,
                                     _pow2_at_least, release)
from repro_torch.serving.multi_table import BatchQueryResult
from repro_torch.utils.device import as_float_tensor, resolve_device
from repro_torch.utils.mesh import shard_count


class ShardCallTimeout(RuntimeError):
    """A replica call ran past the router's per-shard deadline."""


class ShardUnavailableError(RuntimeError):
    """Every replica of a shard failed the call ladder."""


# what a replica call may fail with and still count as the replica's
# failure (anything else is the program's, and propagates)
_REPLICA_FAILURES = (FaultError, ShardCallTimeout)


class _ReplicaHealth:
    __slots__ = ("alive", "fails", "probe_ok", "applied", "error")

    def __init__(self):
        self.alive = True
        self.fails = 0        # consecutive call failures while alive
        self.probe_ok = 0     # consecutive probe successes while down
        self.applied = 0      # writes applied (vs the shard's write count)
        self.error = None     # the non-fault error that took it down


class ShardReplicaRouter:
    """Front end over S shards x R replicas of ``LSMMultiTableIndex``.

    Duck-types the scan-mode index surface ``HashQueryService`` /
    ``AsyncHashQueryService`` use (query_scan_batch / insert / delete /
    config / version / stats / churn counters).  Probe mode
    (``lookup_batch``) is not served here.
    """

    # Lock discipline (checked by the JAX package's static lint, which
    # walks every module under src/): the replica table, the health map,
    # the row log and every counter below are touched only under ``_mu``.
    # Replicas lock themselves; the router snapshots their handles under
    # _mu and calls them with _mu released.
    _GUARDED_BY = {
        "_replicas": "_mu", "_health": "_mu", "_families": "_mu",
        "_gids": "_mu", "_shard_x": "_mu", "_shard_active": "_mu",
        "_shard_of_buf": "_mu", "_local_of_buf": "_mu", "_next_id": "_mu",
        "_writes": "_mu", "_inflight": "_mu", "_rotation": "_mu",
        "version": "_mu", "queries": "_mu", "degraded_answers": "_mu",
        "last_coverage": "_mu", "failovers": "_mu", "timeouts": "_mu",
        "replica_downs": "_mu", "readmits": "_mu", "catchups": "_mu",
        "write_skips": "_mu",
    }

    def __init__(self, config: IndexConfig, shards: int = 2,
                 replicas: int = 2, deadline_ms: float = 250.0,
                 backoff_ms: float = 1.0, fail_threshold: int = 1,
                 readmit_probes: int = 2,
                 fault_plan: FaultPlan | None = None, device="cuda"):
        if shards < 1 or replicas < 1:
            raise ValueError(f"need shards >= 1 and replicas >= 1, got "
                             f"{shards} and {replicas}")
        self.config = config
        self.device = resolve_device(device)
        self.shards = int(shards)
        self.replicas = int(replicas)
        self.deadline_s = float(deadline_ms) * 1e-3
        self.backoff_ms = float(backoff_ms)
        self.fail_threshold = max(1, int(fail_threshold))
        self.readmit_probes = max(1, int(readmit_probes))
        self.fault_plan = fault_plan      # fixed after construction
        self._mu = threading.RLock()
        self._replicas = [[LSMMultiTableIndex(config, device=self.device)
                           for _ in range(self.replicas)]
                          for _ in range(self.shards)]
        self._health = [[_ReplicaHealth() for _ in range(self.replicas)]
                        for _ in range(self.shards)]
        self._families = None   # families carried in at fit, if any
        # the router's logical row log, per shard: feature rows, liveness
        # and the local -> global id map (append-only, strictly increasing)
        self._gids = [np.empty(0, np.int64) for _ in range(self.shards)]
        self._shard_x = [None for _ in range(self.shards)]
        self._shard_active = [np.empty(0, bool) for _ in range(self.shards)]
        # global id -> (owner shard, shard-local id)
        self._shard_of_buf = np.empty(0, np.int64)
        self._local_of_buf = np.empty(0, np.int64)
        self._next_id = 0
        self._writes = [0] * self.shards     # per-shard write count
        self._inflight = [0] * self.shards   # write pushes in flight
        self._rotation = [0] * self.shards   # spreads scans over replicas
        self.version = 0
        self.queries = 0
        self.degraded_answers = 0
        self.last_coverage = 1.0
        self.failovers = 0
        self.timeouts = 0
        self.replica_downs = 0
        self.readmits = 0
        self.catchups = 0
        self.write_skips = 0     # replica writes skipped (replica down)
        # shard ladders run on _shard_pool; each attempt on _call_pool, so
        # the ladder thread can abandon a late attempt at its deadline
        self._call_pool = ThreadPoolExecutor(
            max_workers=self.shards * self.replicas + 2,
            thread_name_prefix="cluster-call")
        self._shard_pool = ThreadPoolExecutor(
            max_workers=self.shards, thread_name_prefix="cluster-shard")
        if self.device.type == "cuda":
            # every kernel library now, not at a first use under a deadline
            ops.load_libraries()

    # -- build / writes ------------------------------------------------------

    def fit(self, x, families=None) -> "ShardReplicaRouter":
        """Split the rows round-robin over the shards (global row i to
        shard i mod S) and fit every replica of each shard on its rows.
        Global ids are 0..n-1.  families: optional per-table families
        carried in for every replica (default: each replica's own from the
        config); a shard that has lost every replica rebuilds with them."""
        x = np.atleast_2d(np.asarray(x, np.float32))
        n = x.shape[0]
        parts = [np.arange(s, n, self.shards) for s in range(self.shards)]
        with self._mu:
            reps = [list(row) for row in self._replicas]
        # fit with _mu released: hashing (and learning) is the slow part,
        # and nothing serves traffic before fit returns
        for s, rows in enumerate(parts):
            for rep in reps[s]:
                rep.fit(x[rows], families=families)
        with self._mu:
            self._families = None if families is None else list(families)
            self._gids = [p.astype(np.int64) for p in parts]
            self._shard_x = [x[p].copy() for p in parts]
            self._shard_active = [np.ones(p.size, bool) for p in parts]
            self._shard_of_buf = np.full(_pow2_at_least(max(n, 1), _MIN_CAP),
                                         -1, np.int64)
            self._local_of_buf = np.full(self._shard_of_buf.shape[0], -1,
                                         np.int64)
            self._shard_of_buf[:n] = np.arange(n) % self.shards
            for s, p in enumerate(parts):
                self._local_of_buf[p] = np.arange(p.size)
            self._next_id = n
            self._writes = [0] * self.shards
            for row in self._health:
                for h in row:
                    h.alive, h.fails, h.probe_ok, h.applied = True, 0, 0, 0
                    h.error = None
            self.version += 1
        return self

    def _grow_id_maps(self, need: int) -> None:
        # _mu lock held by caller
        if need <= self._shard_of_buf.shape[0]:
            return
        cap = _pow2_at_least(need, _MIN_CAP)
        so = np.full(cap, -1, np.int64)
        so[:self._next_id] = self._shard_of_buf[:self._next_id]
        lo = np.full(cap, -1, np.int64)
        lo[:self._next_id] = self._local_of_buf[:self._next_id]
        self._shard_of_buf, self._local_of_buf = so, lo

    def insert(self, x_new) -> np.ndarray:
        """Append rows (round-robin by global id).  Succeeds logically
        even with replicas down: the router's row log is the truth, and a
        replica that missed the write repairs from it at re-admission.
        Returns the assigned global ids.  A replica's non-fault error
        raises after the rows are committed (see the module docstring): do
        not retry the insert, the rows are in under the ids that follow the
        previous high-water mark."""
        x_new = np.atleast_2d(np.asarray(x_new, np.float32))
        k = x_new.shape[0]
        if k == 0:
            return np.empty((0,), dtype=np.int64)
        pushes = []
        with self._mu:
            self._raise_recorded_error()
            if self._shard_x[0] is None:
                raise RuntimeError("ShardReplicaRouter.insert before fit()")
            if x_new.shape[1] != self._shard_x[0].shape[1]:
                raise ValueError(f"rows of width {x_new.shape[1]} into an "
                                 f"index of width {self._shard_x[0].shape[1]}")
            gids = np.arange(self._next_id, self._next_id + k,
                             dtype=np.int64)
            self._grow_id_maps(self._next_id + k)
            owner = gids % self.shards
            self._shard_of_buf[gids] = owner
            self._next_id += k
            for s in range(self.shards):
                sel = np.flatnonzero(owner == s)
                if sel.size == 0:
                    continue
                local0 = self._gids[s].size
                self._local_of_buf[gids[sel]] = np.arange(
                    local0, local0 + sel.size)
                self._gids[s] = np.concatenate([self._gids[s], gids[sel]])
                self._shard_x[s] = np.concatenate(
                    [self._shard_x[s], x_new[sel]])
                self._shard_active[s] = np.concatenate(
                    [self._shard_active[s], np.ones(sel.size, bool)])
                targets = self._current_replicas(s)
                self.write_skips += self.replicas - len(targets)
                self._writes[s] += 1
                self._inflight[s] += 1
                pushes.append((s, x_new[sel].copy(), targets))
            self.version += 1
        self._push_all(pushes, lambda rep, xs: rep.insert(xs))
        return gids

    def delete(self, ids) -> None:
        """Tombstone rows by global id.  Checked against the router's own
        row log first (unknown, deleted or duplicate ids raise KeyError, as
        for a single index: a bad id is the caller's error, never a health
        event), then pushed to the current replicas.  As for ``insert``, a
        replica's non-fault error raises after the delete is committed."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        if ids.size == 0:
            return
        if np.unique(ids).size != ids.size:
            raise KeyError("duplicate ids in delete")
        pushes = []
        with self._mu:
            self._raise_recorded_error()
            if ids.min() < 0 or ids.max() >= self._next_id:
                raise KeyError(f"unknown ids (never assigned): "
                               f"{ids[(ids < 0) | (ids >= self._next_id)][:8]}")
            owner = self._shard_of_buf[ids]
            local = self._local_of_buf[ids]
            for s in range(self.shards):
                sel = local[owner == s]
                if sel.size and not self._shard_active[s][sel].all():
                    raise KeyError("delete of already-deleted id")
            for s in range(self.shards):
                sel = local[owner == s]
                if sel.size == 0:
                    continue
                self._shard_active[s][sel] = False
                targets = self._current_replicas(s)
                self.write_skips += self.replicas - len(targets)
                self._writes[s] += 1
                self._inflight[s] += 1
                pushes.append((s, sel.copy(), targets))
            self.version += 1
        self._push_all(pushes, lambda rep, sel: rep.delete(sel))

    def _push_all(self, pushes, apply) -> None:
        """Push each shard's write to its current replicas; the first
        non-fault error is raised after every push was tried."""
        error = None
        for s, payload, targets in pushes:
            try:
                for r, rep in targets:
                    try:
                        self._push_write(
                            s, r, lambda rep=rep: apply(rep, payload))
                    except Exception as e:   # raised after the pushes
                        error = error or e
            finally:
                with self._mu:
                    self._inflight[s] -= 1
        if error is not None:
            raise error

    def _current_replicas(self, s: int) -> list:
        # _mu lock held by caller: alive replicas that applied every write
        out = []
        for r in range(self.replicas):
            h = self._health[s][r]
            if h.alive and h.applied == self._writes[s]:
                out.append((r, self._replicas[s][r]))
        return out

    def _push_write(self, s: int, r: int, fn) -> None:
        """One replica write through the fault seam.  A failure demotes the
        replica: it is behind the log whatever the cause; a non-fault
        error is recorded on it and raised."""
        try:
            self._guarded_call(s, r, "write", fn)
        except FaultError:
            self._note_failure(s, r, force_down=True)
            return
        except Exception as e:
            self._note_failure(s, r, force_down=True, error=e)
            raise
        with self._mu:
            self._health[s][r].applied += 1
            self._health[s][r].fails = 0

    # -- the fault seam ------------------------------------------------------

    def _guarded_call(self, s: int, r: int, op: str, fn):
        """Every replica interaction goes through here: the seam the
        FaultPlan hooks."""
        if self.fault_plan is not None:
            self.fault_plan.on_call(s, r, op)
        return fn()

    def _note_failure(self, s: int, r: int, force_down: bool = False,
                      timeout: bool = False, error=None) -> None:
        with self._mu:
            h = self._health[s][r]
            h.fails += 1
            h.probe_ok = 0
            if timeout:
                self.timeouts += 1
            if error is not None and h.error is None:
                h.error = error
            if h.alive and (force_down or h.fails >= self.fail_threshold):
                h.alive = False
                self.replica_downs += 1

    def _note_late_error(self, s: int, r: int, fut) -> None:
        """Done-callback of a call abandoned at its deadline: an error that
        is not a replica failure is recorded on the replica, which leaves
        the rotation, so the next query or write raises it."""
        e = None if fut.cancelled() else fut.exception()
        if e is not None and not isinstance(e, _REPLICA_FAILURES):
            self._note_failure(s, r, force_down=True, error=e)

    def _recorded_error(self):
        # _mu lock held by caller: the first recorded non-fault error of a
        # replica out of rotation (raised in place of a degraded answer)
        return next((h.error for row in self._health for h in row
                     if h.error is not None), None)

    def _raise_recorded_error(self) -> None:
        # _mu lock held by caller
        err = self._recorded_error()
        if err is not None:
            raise err

    def _note_success(self, s: int, r: int) -> None:
        with self._mu:
            self._health[s][r].fails = 0

    def _attempt(self, s: int, r: int, op: str, fn):
        """One deadline-bounded replica call, run on _call_pool so this
        (ladder) thread can abandon a late attempt; the stray call ends
        on its own, its result is dropped and its non-fault error is
        recorded (``_note_late_error``).  Only a timeout or an injected
        fault counts against the replica; any other error propagates (see
        the module docstring).  While a kernel library builds, the
        deadline waits: a first-use build is the program's set-up, not
        the replica's lateness, and its error propagates."""
        fut = self._call_pool.submit(self._guarded_call, s, r, op, fn)
        while True:
            try:
                out = fut.result(timeout=self.deadline_s)
                break
            except _FutTimeout:
                if _build.building():
                    continue
                self._note_failure(s, r, timeout=True)
                fut.add_done_callback(
                    lambda f, s=s, r=r: self._note_late_error(s, r, f))
                raise ShardCallTimeout(
                    f"shard {s} replica {r} {op} past "
                    f"{self.deadline_s * 1e3:.0f} ms deadline") from None
            except FaultError:
                self._note_failure(s, r)
                raise
        self._note_success(s, r)
        return out

    def _ladder_order(self, s: int, prefer: int | None) -> list:
        # _mu lock held by caller: serving replicas rotated for load
        # spread; `prefer` (the replica that served this query's scan)
        # goes first so the margins call reuses its warm state
        cur = self._current_replicas(s)
        if not cur:
            return []
        rot = self._rotation[s] % len(cur)
        order = cur[rot:] + cur[:rot]
        if prefer is not None:
            order.sort(key=lambda t: t[0] != prefer)
        return order

    def _shard_ladder(self, s: int, op: str, fn_of_rep,
                      prefer: int | None = None):
        """Retry, sibling replica, ShardUnavailableError: the failover
        ladder.  Each rung is one deadline-bounded attempt; rungs after the
        first back off exponentially and count as failovers."""
        with self._mu:
            order = self._ladder_order(s, prefer)
        last: Exception | None = None
        for k, (r, rep) in enumerate(order):
            if k:
                with self._mu:
                    self.failovers += 1
                if self.backoff_ms:
                    time.sleep(self.backoff_ms * 1e-3 * (2 ** (k - 1)))
            try:
                return r, self._attempt(s, r, op,
                                        lambda rep=rep: fn_of_rep(rep))
            except _REPLICA_FAILURES as e:
                last = e
        raise ShardUnavailableError(
            f"shard {s}: all replicas failed {op}") from last

    # -- health probes and hysteresis ----------------------------------------

    def _probe_down_replicas(self) -> None:
        """Probe every downed replica through the fault seam; after
        ``readmit_probes`` consecutive successes, catch the replica up from
        the row log (if it missed writes) and re-admit it.  Runs at the
        start of every query."""
        with self._mu:
            targets = [(s, r, self._replicas[s][r])
                       for s in range(self.shards)
                       for r in range(self.replicas)
                       if not self._health[s][r].alive]
        for s, r, rep in targets:
            try:
                self._guarded_call(s, r, "probe", lambda rep=rep: rep.version)
            except FaultError:
                with self._mu:
                    self._health[s][r].probe_ok = 0
                continue
            with self._mu:
                h = self._health[s][r]
                h.probe_ok += 1
                # no re-admission while a write push is in flight: the
                # catch-up snapshot could apply that write twice
                ready = (h.probe_ok >= self.readmit_probes
                         and self._inflight[s] == 0)
                stale = h.applied != self._writes[s]
                writes_at = self._writes[s]
            if not ready:
                continue
            if stale and not self._catchup_replica(s, rep, writes_at):
                continue            # raced a write; retry next probe round
            with self._mu:
                h = self._health[s][r]
                h.alive, h.fails, h.probe_ok = True, 0, 0
                h.applied, h.error = writes_at, None
                self.readmits += 1

    def _catchup_replica(self, s: int, rep, writes_at: int) -> bool:
        """Rebuild a stale replica from the row log through the refresh's
        shadow-build path: ``_install`` a shadow over the shard's live rows
        (families from a current sibling, else those carried in at fit,
        else ``make_family`` from the config on the live rows, which for
        seeded methods are the fit's) and ``_adopt_refresh`` it in under
        the replica's lock, its base already on the device.  False if a
        write raced the snapshot."""
        with self._mu:
            live_local = np.flatnonzero(self._shard_active[s])
            x_live = self._shard_x[s][live_local].copy()
            d = self._shard_x[s].shape[1]
            n_s = self._gids[s].size
            sib = next((rr for _, rr in self._current_replicas(s)), None)
            carried = self._families
        shadow = LSMMultiTableIndex(self.config, device=self.device)
        if sib is not None:
            with sib._lock:
                fams = list(sib.families)
                bcap = sib._bcap
        elif carried is not None:
            fams, bcap = carried, _MIN_CAP
        else:
            xt = as_float_tensor(x_live if x_live.size
                                 else np.zeros((1, d), np.float32),
                                 self.device)
            fams = [make_family(self.config, xt, t)
                    for t in range(shadow.num_tables)]
            bcap = _MIN_CAP
        shadow._install(x_live, fams, ids=live_local, next_id=n_s,
                        bcap_floor=bcap)
        # the base crosses to the device here, not inside the re-admitted
        # replica's first scan (which runs under the deadline)
        shadow.upload_base()
        with self._mu:
            if self._writes[s] != writes_at or self._inflight[s]:
                return False
            with rep._lock:
                retired = rep._adopt_refresh(shadow)
            self.catchups += 1
        release(retired)
        return True

    # -- queries -------------------------------------------------------------

    def _scan_covered_shard(self, s: int, w: np.ndarray, l: int, mesh,
                            shard_axis: str, gids: np.ndarray):
        """One shard's scan ladder: per-table (distance, local id) top-l
        from a healthy replica (row-sharded over mesh when one is given),
        mapped to global ids.  Runs on _shard_pool, so the shards scan
        (and fail over) concurrently."""
        r, (d, ids) = self._shard_ladder(
            s, "scan", lambda rep: rep.scan_table_topk(
                w, l, mesh=mesh, shard_axis=shard_axis))
        known = (ids >= 0) & (ids < gids.size)
        g = np.where(known, gids[np.clip(ids, 0, gids.size - 1)], -1)
        # rows newer than this query's snapshot (an insert racing the
        # scan) drop to sentinels instead of mapping wrongly
        d = np.where(known | (ids < 0), d, DIST_SENTINEL).astype(np.int32)
        return r, d, g

    def query_scan_batch(self, w, l: int = 16, topk: int = 1, mask=None,
                         mesh=None, shard_axis: str = "data"
                         ) -> BatchQueryResult:
        """Cluster-wide scan answer (the protocol in the module
        docstring).  A replica's timeout or injected fault shrinks
        ``coverage`` instead of raising; any other error raises, and so
        does an error recorded on a replica still out of rotation.
        ``mask`` is a bool mask over the global stable-id space.  mesh /
        shard_axis: each replica's scan runs row-sharded over the mesh
        (``MultiTableIndex.scan_table_topk``), with the same answers."""
        if mesh is not None:
            shard_count(mesh, shard_axis)
        w = np.atleast_2d(np.asarray(w, np.float32))
        b = w.shape[0]
        t0 = time.perf_counter()
        with self._mu:
            recorded = self._recorded_error()
        # the probes advance (and may re-admit) either way, but a recorded
        # error seen before them raises: re-admission does not swallow it
        self._probe_down_replicas()
        if recorded is not None:
            raise recorded
        with self._mu:
            if self._shard_x[0] is None:
                raise RuntimeError("ShardReplicaRouter.query_scan_batch "
                                   "before fit()")
            gids_snap = list(self._gids)
            live = [int(a.sum()) for a in self._shard_active]
            shard_of = self._shard_of_buf
            local_of = self._local_of_buf
            n_id = self._next_id
            self._rotation = [c + 1 for c in self._rotation]
            self.queries += 1
        total_live = sum(live)
        hits = np.zeros(self.config.tables, dtype=np.int64)
        empty = ([np.empty(0, np.int64) for _ in range(b)],
                 np.full((b, topk), -1, np.int64),
                 np.full((b, topk), np.inf, np.float32))
        if total_live == 0:
            return self._finish(topk, empty[1], empty[2], np.zeros(b, bool),
                                empty[0], time.perf_counter() - t0, 0.0,
                                hits, 1.0)
        # phase 1: per-shard scans in parallel, each with its ladder
        futs = {s: self._shard_pool.submit(self._scan_covered_shard, s, w, l,
                                           mesh, shard_axis, gids_snap[s])
                for s in range(self.shards) if live[s] > 0}
        scans: dict[int, tuple] = {}
        served: dict[int, int] = {}
        error = None
        for s, fut in futs.items():
            try:
                r, d, g = fut.result()
            except ShardUnavailableError:
                continue
            except Exception as e:   # raised once every shard's scan ended
                error = error or e
                continue
            scans[s] = (d, g)
            served[s] = r
        if error is not None:
            raise error
        lookup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        # phases 2 and 3, again without a shard whose margins call failed
        covered = sorted(scans)
        while covered:
            _, g_m = merge_topk_shards([scans[s][0] for s in covered],
                                       [scans[s][1] for s in covered], l)
            flat = np.sort(g_m.transpose(1, 0, 2).reshape(b, -1), axis=1)
            uniq = flat >= 0
            uniq[:, 1:] &= flat[:, 1:] != flat[:, :-1]
            cwidth = max(1, int(uniq.sum(axis=1).max()))
            cand = np.full((b, cwidth), -1, np.int64)
            for i in range(b):
                sel = flat[i, uniq[i]]
                cand[i, :sel.size] = sel
            known = (cand >= 0) & (cand < n_id)
            at = np.clip(cand, 0, n_id - 1)
            owner = np.where(known, shard_of[at], -1)
            margins = np.full((b, cwidth), np.inf, np.float32)
            failed = []
            for s in covered:
                mine = owner == s
                if not mine.any():
                    continue
                local = np.where(mine, local_of[at], -1)
                try:
                    _, m_s = self._shard_ladder(
                        s, "margins",
                        lambda rep, local=local: rep.candidate_margins(
                            w, local),
                        prefer=served.get(s))
                except ShardUnavailableError:
                    failed.append(s)
                    continue
                put = mine & np.isfinite(m_s)
                margins[put] = m_s[put]
            if not failed:
                break
            covered = [s for s in covered if s not in failed]
        if not covered:
            return self._finish(topk, empty[1], empty[2], np.zeros(b, bool),
                                empty[0], lookup_s, time.perf_counter() - t0,
                                hits, 0.0)
        # the global top-k by ascending (margin, global id): a stable sort
        # by margin over the ascending candidate ids
        sel_valid = (cand >= 0) & np.isfinite(margins)
        if mask is not None:
            mask_arr = np.asarray(mask, dtype=bool)
            in_mask = np.zeros_like(sel_valid)
            ok = (cand >= 0) & (cand < mask_arr.size)
            in_mask[ok] = mask_arr[cand[ok]]
            sel_valid &= in_mask
        ids_topk = np.full((b, topk), -1, np.int64)
        margins_topk = np.full((b, topk), np.inf, np.float32)
        for i in range(b):
            mm = np.where(sel_valid[i], margins[i], np.inf)
            order = np.lexsort((cand[i], mm))[:topk]
            mt = mm[order]
            ids_topk[i, :order.size] = np.where(np.isfinite(mt),
                                                cand[i][order], -1)
            margins_topk[i, :order.size] = mt
        cands = [cand[i][cand[i] >= 0] for i in range(b)]
        hits = (g_m >= 0).sum(axis=(1, 2)).astype(np.int64)
        coverage = sum(live[s] for s in covered) / total_live
        return self._finish(topk, ids_topk, margins_topk,
                            sel_valid.any(axis=1), cands, lookup_s,
                            time.perf_counter() - t0, hits, coverage)

    def _finish(self, topk, ids_topk, margins_topk, nonempty, cands,
                lookup_s, rerank_s, hits, coverage) -> BatchQueryResult:
        degraded = coverage < 1.0
        with self._mu:
            self.last_coverage = float(coverage)
            if degraded:
                self.degraded_answers += 1
        return BatchQueryResult(
            ids_topk[:, 0], margins_topk[:, 0], nonempty, cands,
            lookup_s, rerank_s, hits,
            ids_topk=ids_topk if topk > 1 else None,
            margins_topk=margins_topk if topk > 1 else None,
            coverage=float(coverage), degraded=degraded)

    # -- the service's surface -----------------------------------------------

    def lookup_batch(self, w, qcodes=None):
        raise NotImplementedError(
            "ShardReplicaRouter serves scan mode only: use "
            "HashQueryService(router, mode='scan')")

    @property
    def n(self) -> int:
        with self._mu:
            return int(sum(int(a.sum()) for a in self._shard_active))

    def replica(self, s: int, r: int) -> LSMMultiTableIndex:
        """Replica r of shard s (for warm-up and inspection)."""
        with self._mu:
            return self._replicas[s][r]

    def _replica_sum(self, attr: str) -> int:
        with self._mu:
            reps = [rep for row in self._replicas for rep in row]
        return int(sum(getattr(rep, attr) for rep in reps))

    @property
    def device_uploads(self) -> int:
        return self._replica_sum("device_uploads")

    @property
    def scan_state_rebuilds(self) -> int:
        return self._replica_sum("scan_state_rebuilds")

    @property
    def compaction_steps(self) -> int:
        return self._replica_sum("compaction_steps")

    @property
    def compactions(self) -> int:
        return self._replica_sum("compactions")

    def health(self) -> list[list[dict]]:
        with self._mu:
            return [[{"alive": h.alive, "fails": h.fails,
                      "probe_ok": h.probe_ok, "applied": h.applied,
                      "writes": self._writes[s],
                      "error": None if h.error is None else repr(h.error)}
                     for h in self._health[s]]
                    for s in range(self.shards)]

    def close(self) -> None:
        """Stop the router's thread pools (a stray late attempt finishes
        first)."""
        self._call_pool.shutdown(wait=True)
        self._shard_pool.shutdown(wait=True)

    def stats(self) -> dict:
        with self._mu:
            alive = sum(h.alive for row in self._health for h in row)
            out = {
                "backend": "cluster",
                "shards": self.shards,
                "replicas": self.replicas,
                "replicas_alive": int(alive),
                "n": int(sum(int(a.sum()) for a in self._shard_active)),
                "rows": int(sum(g.size for g in self._gids)),
                "version": self.version,
                "queries": self.queries,
                "degraded_answers": self.degraded_answers,
                "last_coverage": self.last_coverage,
                "failovers": self.failovers,
                "timeouts": self.timeouts,
                "replica_downs": self.replica_downs,
                "readmits": self.readmits,
                "catchups": self.catchups,
                "write_skips": self.write_skips,
                "writes": list(self._writes),
            }
        out["health"] = self.health()
        out["device_uploads"] = self.device_uploads
        if self.fault_plan is not None:
            out["faults"] = self.fault_plan.stats()
        return out
