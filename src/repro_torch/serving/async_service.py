"""Async deadline-flush front end over the batched query service.

``HashQueryService`` is synchronous: concurrent callers (the paper's C
one-vs-all SVM learners, §5) cannot share device launches unless someone
assembles their batch by hand.  ``AsyncHashQueryService`` hands every
caller a ``Future`` from ``submit`` and a background flush loop coalesces
whatever is pending into one batched pass.  A batch fires when it reaches
``max_batch`` or when its oldest request has waited ``deadline_ms``,
whichever comes first, so batching never costs more than one deadline of
latency.

Three layers, so the policy is testable without sleeps:

- ``DeadlineBatcher``: the pure flush policy.  No clock, no locks, no
  threads: every method takes ``now`` from the caller, so tests drive it
  (and the service, with ``start=False`` + ``pump(now)``) on a fake clock.
- ``AsyncHashQueryService``: futures, the bounded queue (``submit`` past
  ``max_queue`` raises ``QueueFullError`` instead of stretching latency),
  the flush thread and the counters (queue depth, batch-size histogram,
  p50/p95/p99 request latency).
- the inner ``HashQueryService``, which answers each flushed batch through
  either backend (``mode="probe"`` or ``"scan"``): async answers equal the
  synchronous ``query_batch``'s for the same requests.

Requests that carry a ``mask`` (active learning restricts answers to the
unlabelled pool) are grouped by mask identity inside a flush: requests
passing the same array object still share a launch.

Writes ride the same queue: ``submit_insert`` / ``submit_delete`` return
futures, and the flush loop splits each batch into runs at write
boundaries, so a query sees exactly the writes submitted before it.  With
``serving.lsm.LSMMultiTableIndex`` underneath this is streaming ingest:
inserts land in the delta, queries keep flowing, and incremental
compaction folds the delta back without stopping the world.

The JAX package pads each flushed group to a power-of-two size so that its
jitted paths see few shapes; PyTorch traces nothing, so the port answers
each group at its own size.  ``refresh`` triggers the inner service's
online re-learn and generation swap; ``mesh`` / ``shard_axis`` reach
the inner service's row-sharded scan.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque
from concurrent.futures import Future

import numpy as np

from repro_torch.serving.multi_table import MultiTableIndex
from repro_torch.serving.service import HashQueryService


class QueueFullError(RuntimeError):
    """Admission control: the bounded request queue is full — the request
    is shed instead of queued (callers may retry, degrade, or drop)."""


class ServiceClosedError(RuntimeError):
    """submit() after close(), or a pending request cancelled by
    close(drain=False)."""


class _Request:
    __slots__ = ("kind", "w", "mask", "mask_key", "t_submit", "future",
                 "payload")

    def __init__(self, w, mask, t_submit, kind: str = "query", payload=None):
        self.kind = kind           # "query" | "insert" | "delete"
        self.w = w
        self.mask = mask
        # group key: requests answered together must share one mask.  Keyed
        # by object identity, not content — O(1) per submit (content
        # hashing would copy the whole n-element mask per request), and
        # safe because every queued request keeps its mask alive, so two
        # live distinct arrays can never share an id.  Callers that want
        # coalescing (svm.active: C learners, one unlabeled pool) pass the
        # same array object; equal-content copies just flush separately.
        self.mask_key = None if mask is None else id(mask)
        self.t_submit = t_submit
        self.payload = payload     # insert: (k, d) rows; delete: (k,) ids
        self.future: Future = Future()


class DeadlineBatcher:
    """Pure deadline-flush policy over a bounded FIFO queue.

    Ready to fire when ``depth >= max_batch`` (flush-on-full) or the
    OLDEST pending item has waited ``deadline_s`` (flush-on-deadline).
    ``take`` pops at most ``max_batch`` oldest items; younger items keep
    their original arrival times, so a backlog drains as a sequence of
    full batches and the next deadline is always the new oldest's.
    All times are passed in by the caller — nothing here reads a clock.
    """

    def __init__(self, max_batch: int, deadline_s: float, max_queue: int):
        if max_batch < 1 or deadline_s < 0.0:
            raise ValueError(f"need max_batch >= 1 and deadline_s >= 0, got "
                             f"{max_batch}, {deadline_s}")
        if max_queue < max_batch:
            raise ValueError(f"max_queue {max_queue} below max_batch "
                             f"{max_batch} can never fill a batch")
        self.max_batch = int(max_batch)
        self.deadline_s = float(deadline_s)
        self.max_queue = int(max_queue)
        self._q: deque[tuple[object, float]] = deque()

    @property
    def depth(self) -> int:
        return len(self._q)

    def offer(self, item, now: float) -> None:
        """Admit one item, or shed it: raises QueueFullError at max_queue."""
        if len(self._q) >= self.max_queue:
            raise QueueFullError(
                f"request queue full ({self.max_queue}); shedding")
        self._q.append((item, now))

    def ready(self, now: float) -> bool:
        if len(self._q) >= self.max_batch:
            return True
        return bool(self._q) and now - self._q[0][1] >= self.deadline_s

    def next_fire(self) -> float | None:
        """Absolute time the oldest pending item hits its deadline
        (None when idle).  A full queue is ready immediately regardless."""
        return self._q[0][1] + self.deadline_s if self._q else None

    def take(self) -> list:
        """Pop the up-to-``max_batch`` oldest items (empty list when idle)."""
        return [self._q.popleft()[0]
                for _ in range(min(self.max_batch, len(self._q)))]

    def drain(self) -> list:
        """Pop everything (close-without-drain cancellation path)."""
        out = [item for item, _ in self._q]
        self._q.clear()
        return out


class AsyncHashQueryService:
    """Future-per-request front end with deadline-based batch coalescing.

    ``submit(w)`` returns a ``concurrent.futures.Future`` resolving to the
    same ``QueryResult`` the synchronous ``HashQueryService.query_batch``
    would produce for that request — bit-identical, both backends.  A
    daemon flush thread fires batches per the ``DeadlineBatcher`` policy;
    pass ``start=False`` to drive flushing yourself with ``pump()`` (tests
    use this with an injected fake ``clock``).

    deadline_ms: max time a request waits for batch-mates before its batch
        is flushed anyway — the knob trading device efficiency (bigger
        batches) against tail latency.
    max_queue: admission bound; ``submit`` past it raises QueueFullError
        (sheds load explicitly instead of stretching the tail).
    mode, cache_size, scan_l: the inner HashQueryService's.
    """

    # Lock discipline (checked by the JAX package's static lint, which
    # walks every module under src/).  The condition's lock owns the
    # flush-policy queue, the lifecycle flag and every counter; the inner
    # HashQueryService is not thread-safe, so the attribute itself is only
    # touched under _service_lock.
    _GUARDED_BY = {
        "_batcher": "_cond", "_closed": "_cond",
        "submitted": "_cond", "completed": "_cond", "shed": "_cond",
        "_admit_window": "_cond",
        "flushes": "_cond", "batch_sizes": "_cond", "latencies_s": "_cond",
        "service": "_service_lock",
    }

    def __init__(self, index: MultiTableIndex, *, max_batch: int | None = None,
                 deadline_ms: float = 5.0, max_queue: int = 1024,
                 mode: str = "probe", cache_size: int = 1024,
                 scan_l: int = 16, mesh=None, shard_axis: str = "data",
                 clock=time.monotonic, start: bool = True):
        self.service = HashQueryService(
            index, max_batch=max_batch, cache_size=cache_size, mode=mode,
            scan_l=scan_l, mesh=mesh, shard_axis=shard_axis)
        self.max_batch = self.service.max_batch
        self.deadline_s = float(deadline_ms) * 1e-3
        self._clock = clock
        self._batcher = DeadlineBatcher(self.max_batch, self.deadline_s,
                                        max_queue)
        self._cond = threading.Condition()
        # the inner HashQueryService (LRU cache, counters) is not
        # thread-safe; flush()/pump() callers can race the flush thread,
        # so every query_batch call goes through this lock
        self._service_lock = threading.Lock()
        self._closed = False
        # counters (all mutated under self._cond); latency history is a
        # bounded window so a long-lived service doesn't grow without
        # bound — percentiles are over the most recent entries
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        # sliding admission window (1 = shed, 0 = admitted) so stats() can
        # report a shed RATE over recent traffic, not a lifetime ratio that
        # an old burst pins forever
        self._admit_window: deque[int] = deque(maxlen=4096)
        self.flushes = 0
        self.batch_sizes: Counter[int] = Counter()
        self.latencies_s: deque[float] = deque(maxlen=65536)
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="async-hash-query-flush", daemon=True)
            self._thread.start()

    # -- request side --------------------------------------------------------

    def submit(self, w, mask=None) -> Future:
        """Enqueue one hyperplane query; resolves to its QueryResult.

        mask: optional bool mask over stable-id space (as in query_batch).
        Raises QueueFullError when the queue is at max_queue (the request
        is shed and counted) and ServiceClosedError after close()."""
        w = np.asarray(w, np.float32).reshape(-1)
        if mask is not None:
            mask = np.asarray(mask, dtype=bool)
        with self._cond:
            if self._closed:
                raise ServiceClosedError("submit after close()")
            req = _Request(w, mask, self._clock())
            try:
                self._batcher.offer(req, req.t_submit)
            except QueueFullError:
                self.shed += 1
                self._admit_window.append(1)
                raise
            self.submitted += 1
            self._admit_window.append(0)
            self._cond.notify_all()
        return req.future

    def submit_with_retry(self, w, mask=None, attempts: int = 4,
                          backoff_ms: float = 2.0) -> Future:
        """``submit`` that retries through QueueFullError with exponential
        backoff — the canonical caller-side response to shedding: back off,
        let the flush loop drain, try again.  Sleeps backoff_ms, 2x, 4x …
        between attempts and re-raises the final QueueFullError so callers
        still see sustained overload.  Other errors (ServiceClosedError)
        propagate immediately."""
        attempts = max(1, int(attempts))
        for k in range(attempts):
            try:
                return self.submit(w, mask)
            except QueueFullError:
                if k + 1 >= attempts:
                    raise
            time.sleep(backoff_ms * 1e-3 * (2 ** k))
        raise AssertionError("unreachable")

    def _submit_write(self, kind: str, payload) -> Future:
        """Enqueue a write through the same bounded queue / deadline policy
        as queries — one FIFO stream, so a query submitted after a write
        observes it and one submitted before does not (the flush loop
        splits batches at write boundaries to keep that order)."""
        with self._cond:
            if self._closed:
                raise ServiceClosedError("submit after close()")
            req = _Request(None, None, self._clock(), kind=kind,
                           payload=payload)
            try:
                self._batcher.offer(req, req.t_submit)
            except QueueFullError:
                self.shed += 1
                self._admit_window.append(1)
                raise
            self.submitted += 1
            self._admit_window.append(0)
            self._cond.notify_all()
        return req.future

    def submit_insert(self, x_new) -> Future:
        """Enqueue a streaming insert; resolves to the assigned stable ids
        (np.int64 array).  Interleaves with query flushes in submit order."""
        return self._submit_write(
            "insert", np.atleast_2d(np.asarray(x_new, np.float32)))

    def submit_delete(self, ids) -> Future:
        """Enqueue a streaming delete (tombstone); resolves to None."""
        return self._submit_write(
            "delete", np.atleast_1d(np.asarray(ids, dtype=np.int64)))

    @property
    def pending(self) -> int:
        with self._cond:
            return self._batcher.depth

    # -- flush side ----------------------------------------------------------

    def pump(self, now: float | None = None) -> int:
        """Run at most one flush iteration in the calling thread.

        Fires only if the policy says a batch is due at ``now`` (defaults
        to the injected clock) — or unconditionally once closed, so close
        can drain.  Returns the number of requests answered.  This is the
        no-thread (``start=False``) drive path and the fake-clock test
        hook; it is safe alongside the background thread (take happens
        under the queue lock, the inner service runs under its own lock).
        """
        with self._cond:
            if now is None:
                now = self._clock()
            if not (self._closed or self._batcher.ready(now)):
                return 0
            batch = self._batcher.take()
        if not batch:
            return 0
        self._run_batch(batch)
        return len(batch)

    def flush(self) -> None:
        """Answer everything pending NOW, in the calling thread, without
        waiting for deadlines (e.g. a caller that just submitted a burst
        and wants the shared launch immediately)."""
        while True:
            with self._cond:
                batch = self._batcher.take()
            if not batch:
                return
            self._run_batch(batch)

    def close(self, drain: bool = True) -> None:
        """Stop accepting work.  drain=True (default) answers everything
        still pending before returning; drain=False fails pending futures
        with ServiceClosedError.  Idempotent."""
        with self._cond:
            already = self._closed
            self._closed = True
            if not drain and not already:
                for req in self._batcher.drain():
                    if req.future.set_running_or_notify_cancel():
                        req.future.set_exception(
                            ServiceClosedError("service closed before flush"))
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        elif drain:
            while self.pump():
                pass

    def __enter__(self) -> "AsyncHashQueryService":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    # -- internals -----------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                while True:
                    now = self._clock()
                    if self._batcher.depth and (self._closed
                                                or self._batcher.ready(now)):
                        batch = self._batcher.take()
                        break
                    if self._closed:
                        return
                    fire = self._batcher.next_fire()
                    self._cond.wait(None if fire is None
                                    else max(fire - now, 0.0))
            self._run_batch(batch)

    def _run_batch(self, batch: list[_Request]) -> None:
        """Answer one flushed batch, split into contiguous runs at write
        boundaries: consecutive queries share launches (grouped by mask
        identity — mask-dependent answers must not mix), each write runs
        alone between them, all in submit order — so every query sees
        exactly the writes submitted before it.  Resolves futures, records
        per-request latency and batch counters."""
        runs: list[list[_Request]] = []
        for req in batch:
            if req.kind != "query" or not runs or runs[-1][0].kind != "query":
                runs.append([req])
            else:
                runs[-1].append(req)
        n_done = 0
        lats: list[float] = []
        for run in runs:
            if run[0].kind != "query":
                n_done += self._run_write(run[0], lats)
                continue
            groups: dict = {}
            for req in run:
                groups.setdefault(req.mask_key, []).append(req)
            for reqs in groups.values():
                # skip futures cancelled while they sat in the queue
                reqs = [r for r in reqs
                        if r.future.set_running_or_notify_cancel()]
                if not reqs:
                    continue
                ws = np.stack([r.w for r in reqs])
                try:
                    with self._service_lock:
                        results = self.service.query_batch(
                            ws, mask=reqs[0].mask)
                except Exception as e:  # resolve the futures, keep flushing
                    for r in reqs:
                        r.future.set_exception(e)
                    continue
                now = self._clock()
                for r, res in zip(reqs, results):
                    lats.append(now - r.t_submit)
                    r.future.set_result(res)
                n_done += len(reqs)
        with self._cond:
            self.latencies_s.extend(lats)
            self.completed += n_done
            self.flushes += 1
            self.batch_sizes[len(batch)] += 1

    def _run_write(self, req: _Request, lats: list[float]) -> int:
        """Execute one insert/delete request; returns 1 when resolved."""
        if not req.future.set_running_or_notify_cancel():
            return 0
        try:
            with self._service_lock:
                if req.kind == "insert":
                    out = self.service.insert(req.payload)
                else:
                    self.service.delete(req.payload)
                    out = None
        except Exception as e:
            req.future.set_exception(e)
            return 0
        lats.append(self._clock() - req.t_submit)
        req.future.set_result(out)
        return 1

    # -- online refresh ------------------------------------------------------

    def refresh(self, wait: bool = True) -> bool:
        """Trigger an online re-learn and generation swap (see
        ``HashQueryService.refresh``).  The learn and build phases run
        outside ``_service_lock``: flushes keep flowing against the old
        generation until the swap's bounded critical section, so any
        thread may call this, with wait=True too."""
        with self._service_lock:
            service = self.service
        # delegate off the lock: the refresh manager serialises itself and
        # the index lock guards the swap
        return service.refresh(wait=wait)

    # -- counters ------------------------------------------------------------

    def stats(self) -> dict:
        """Async-layer counters plus the inner service's (QPS, cache, …)."""
        # inner-service counters mutate under _service_lock (it is not
        # thread-safe); read them there, OUTSIDE _cond, so the two locks
        # never nest and a slow backend stats() can't stall submitters
        with self._service_lock:
            backend = self.service.stats()
        with self._cond:
            lat = (np.asarray(self.latencies_s) if self.latencies_s
                   else np.zeros(1))
            win = self._admit_window
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "shed": self.shed,
                # fraction of the last len(win) submit attempts shed —
                # the live overload signal (0.0 when no attempts yet)
                "shed_rate": (sum(win) / len(win)) if win else 0.0,
                "queue_depth": self._batcher.depth,
                "flushes": self.flushes,
                "mean_batch": self.completed / max(self.flushes, 1),
                "batch_size_hist": dict(sorted(self.batch_sizes.items())),
                "latency_ms": {
                    "mean": 1e3 * float(lat.mean()),
                    "p50": 1e3 * float(np.quantile(lat, 0.50)),
                    "p95": 1e3 * float(np.quantile(lat, 0.95)),
                    "p99": 1e3 * float(np.quantile(lat, 0.99)),
                },
                "deadline_ms": 1e3 * self.deadline_s,
                "max_batch": self.max_batch,
                "max_queue": self._batcher.max_queue,
                "backend": backend,
            }
