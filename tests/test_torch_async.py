"""The port's async deadline-flush front end on the CPU, modelled on
tests/test_async_serving.py:

- ``DeadlineBatcher``: the pure flush policy on a fake clock, no sleeps;
- ``AsyncHashQueryService`` with an injected fake clock and no flush
  thread (``start=False`` + ``pump(now)``): flush on deadline and on full,
  shedding at ``max_queue``, close with and without drain, parity with the
  synchronous service for both backends, mask grouping, writes in FIFO
  order over the LSM index, retries;
- a small threaded soak against the real flush thread, every
  ``future.result`` with a timeout and the service closed in ``finally``.

Tolerance: none.  The async answers come from the same HashQueryService
code on the same rows as the synchronous ones, and every query row is
answered independently of its batch-mates, so ids, margins and candidate
lists must be identical.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.indexer import IndexConfig  # noqa: E402
from repro_torch.data.synthetic import tiny1m_like  # noqa: E402
from repro_torch.serving.async_service import (  # noqa: E402
    AsyncHashQueryService, DeadlineBatcher, QueueFullError,
    ServiceClosedError)
from repro_torch.serving.lsm import LSMMultiTableIndex  # noqa: E402
from repro_torch.serving.multi_table import MultiTableIndex  # noqa: E402
from repro_torch.serving.service import HashQueryService  # noqa: E402

TIMEOUT_S = 60


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def corpus():
    return tiny1m_like(n_labeled=2000, n_unlabeled=0, d=32, classes=5,
                       seed=0)


@pytest.fixture(scope="module")
def index(corpus):
    cfg = IndexConfig(method="bh", bits=18, radius=3, tables=2, batch=8)
    return MultiTableIndex(cfg, device="cpu").fit(corpus.x)


@pytest.fixture(scope="module")
def queries(corpus):
    rng = np.random.default_rng(1)
    return rng.normal(size=(48, corpus.x.shape[1])).astype(np.float32)


def _same_result(a, b) -> bool:
    return (a.index == b.index and a.margin == b.margin
            and a.nonempty == b.nonempty
            and np.array_equal(a.candidates, b.candidates))


# -- DeadlineBatcher: the pure flush policy ----------------------------------

def test_batcher_flush_on_full():
    b = DeadlineBatcher(max_batch=4, deadline_s=1.0, max_queue=8)
    for i in range(3):
        b.offer(i, now=0.0)
    assert not b.ready(0.0)
    b.offer(3, now=0.0)
    assert b.ready(0.0)
    assert b.take() == [0, 1, 2, 3] and b.depth == 0


def test_batcher_flush_on_deadline():
    b = DeadlineBatcher(max_batch=4, deadline_s=1.0, max_queue=8)
    b.offer("a", now=0.0)
    b.offer("b", now=0.4)
    assert b.next_fire() == 1.0          # the OLDEST request's deadline
    assert not b.ready(0.99)
    assert b.ready(1.0)
    assert b.take() == ["a", "b"]
    assert b.next_fire() is None and not b.ready(99.0)


def test_batcher_backlog_drains_oldest_first_keeping_times():
    b = DeadlineBatcher(max_batch=2, deadline_s=1.0, max_queue=8)
    for i, t in enumerate((0.0, 0.1, 0.2)):
        b.offer(i, now=t)
    assert b.ready(0.2)
    assert b.take() == [0, 1]
    assert b.depth == 1 and b.next_fire() == 1.2


def test_batcher_sheds_at_max_queue():
    b = DeadlineBatcher(max_batch=2, deadline_s=1.0, max_queue=3)
    for i in range(3):
        b.offer(i, now=0.0)
    with pytest.raises(QueueFullError):
        b.offer(3, now=0.0)
    b.take()
    b.offer(3, now=0.5)
    assert b.depth == 2


def test_batcher_zero_deadline_and_bad_bounds():
    b = DeadlineBatcher(max_batch=8, deadline_s=0.0, max_queue=8)
    b.offer("a", now=5.0)
    assert b.ready(5.0)
    assert b.drain() == ["a"] and b.take() == []
    with pytest.raises(ValueError):
        DeadlineBatcher(max_batch=4, deadline_s=1.0, max_queue=2)
    with pytest.raises(ValueError):
        DeadlineBatcher(max_batch=0, deadline_s=1.0, max_queue=2)


# -- the service on a fake clock ---------------------------------------------

def test_service_deadline_vs_full_flush(index, queries):
    clock = FakeClock()
    svc = AsyncHashQueryService(index, max_batch=4, deadline_ms=10.0,
                                clock=clock, start=False)
    ref = HashQueryService(index, max_batch=4).query_batch(queries[:6])
    futs = [svc.submit(w) for w in queries[:2]]
    assert svc.pump() == 0
    assert not futs[0].done()
    clock.advance(0.010)
    assert svc.pump() == 2               # deadline flush
    assert all(_same_result(f.result(timeout=0), r)
               for f, r in zip(futs, ref[:2]))
    futs = [svc.submit(w) for w in queries[2:6]]
    assert svc.pump() == 4               # full flush, no time advanced
    assert all(_same_result(f.result(timeout=0), r)
               for f, r in zip(futs, ref[2:6]))
    st = svc.stats()
    assert st["batch_size_hist"] == {2: 1, 4: 1}
    assert st["flushes"] == 2 and st["completed"] == 6 and st["shed"] == 0
    assert st["latency_ms"]["p99"] == pytest.approx(10.0)
    assert st["backend"]["requests"] == 6
    svc.close()


def test_service_sheds_at_max_queue_and_counts(index, queries):
    svc = AsyncHashQueryService(index, max_batch=2, deadline_ms=1e6,
                                max_queue=2, clock=FakeClock(), start=False)
    svc.submit(queries[0])
    svc.submit(queries[1])
    with pytest.raises(QueueFullError):
        svc.submit(queries[2])
    st = svc.stats()
    assert st["shed"] == 1 and st["submitted"] == 2 and st["queue_depth"] == 2
    assert st["shed_rate"] == pytest.approx(1 / 3)
    svc.close()


def test_service_drains_on_close(index, queries):
    clock = FakeClock()
    svc = AsyncHashQueryService(index, max_batch=8, deadline_ms=1e6,
                                clock=clock, start=False)
    futs = [svc.submit(w) for w in queries[:3]]
    assert svc.pump() == 0
    svc.close(drain=True)
    ref = HashQueryService(index, max_batch=8).query_batch(queries[:3])
    assert all(_same_result(f.result(timeout=0), r)
               for f, r in zip(futs, ref))
    with pytest.raises(ServiceClosedError):
        svc.submit(queries[0])
    with pytest.raises(ServiceClosedError):
        svc.submit_insert(queries[:1])
    svc.close()                          # idempotent


def test_service_close_without_drain_fails_pending(index, queries):
    svc = AsyncHashQueryService(index, max_batch=8, deadline_ms=1e6,
                                clock=FakeClock(), start=False)
    futs = [svc.submit(w) for w in queries[:3]]
    svc.close(drain=False)
    for f in futs:
        with pytest.raises(ServiceClosedError):
            f.result(timeout=0)
    assert svc.stats()["completed"] == 0


@pytest.mark.parametrize("mode", ["probe", "scan"])
def test_pumped_parity_with_sync_batch(index, queries, mode):
    """Deadline-coalesced answers equal the synchronous query_batch, per
    backend, for ragged batch sizes."""
    clock = FakeClock()
    svc = AsyncHashQueryService(index, max_batch=8, deadline_ms=5.0,
                                mode=mode, scan_l=32, clock=clock,
                                start=False)
    ref = HashQueryService(index, max_batch=8, mode=mode,
                           scan_l=32).query_batch(queries)
    futs = []
    for chunk in (queries[:3], queries[3:11], queries[11:16], queries[16:]):
        futs.extend(svc.submit(w) for w in chunk)
        clock.advance(0.005)
        while svc.pump():
            pass
    svc.close()
    assert len(futs) == len(ref)
    for f, r in zip(futs, ref):
        assert _same_result(f.result(timeout=0), r)


def test_masked_requests_group_by_mask_identity(index, corpus, queries):
    rng = np.random.default_rng(7)
    mask_a = rng.random(corpus.x.shape[0]) < 0.5
    mask_b = ~mask_a
    sync = HashQueryService(index, max_batch=8)
    ref_a = sync.query_batch(queries[:4], mask=mask_a)
    ref_b = sync.query_batch(queries[4:8], mask=mask_b)
    svc = AsyncHashQueryService(index, max_batch=8, deadline_ms=1e6,
                                clock=FakeClock(), start=False)
    futs = ([svc.submit(w, mask=mask_a) for w in queries[:4]]
            + [svc.submit(w, mask=mask_b) for w in queries[4:8]])
    assert svc.pump() == 8               # one flush, two launches
    svc.close()
    assert svc.stats()["backend"]["batches"] == 2
    for f, r in zip(futs, ref_a + ref_b):
        assert _same_result(f.result(timeout=0), r)
    for f in futs[:4]:
        res = f.result(timeout=0)
        assert not res.nonempty or mask_a[res.index]


@pytest.mark.parametrize("mode", ["probe", "scan"])
def test_writes_ride_the_queue_in_order(corpus, queries, mode):
    """Over the LSM index: a query submitted before a delete answers from
    the pre-delete state, one after it sees the tombstone; inserts resolve
    to their stable ids; the results equal a synchronous replay."""
    cfg = IndexConfig(method="bh", bits=14, tables=2, seed=3,
                      lsm_delta_min=64, lsm_delta_threshold=0.25,
                      lsm_step_rows=128, lbh_sample=64, lbh_steps=6)
    lsm = LSMMultiTableIndex(cfg, device="cpu").fit(corpus.x[:400])
    mirror = LSMMultiTableIndex(cfg, device="cpu").fit(corpus.x[:400])
    clock = FakeClock()
    svc = AsyncHashQueryService(lsm, deadline_ms=5.0, max_batch=16,
                                mode=mode, scan_l=8, clock=clock,
                                start=False)
    sync = HashQueryService(mirror, max_batch=16, mode=mode, scan_l=8)
    w = queries[0]
    best = sync.query_batch(w[None])[0].index
    assert best >= 0
    f_pre = svc.submit(w)
    f_del = svc.submit_delete(np.asarray([best]))
    f_post = svc.submit(w)
    clock.advance(1.0)
    assert svc.pump() == 3
    assert f_pre.result(timeout=0).index == best
    assert f_del.result(timeout=0) is None
    assert f_post.result(timeout=0).index != best
    sync.delete([best])
    assert _same_result(f_post.result(timeout=0), sync.query_batch(w[None])[0])
    rng = np.random.default_rng(19)
    for step in range(6):
        xa = rng.normal(size=(40, corpus.x.shape[1])).astype(np.float32)
        f_ins = svc.submit_insert(xa)
        futs = [svc.submit(q) for q in queries[:12]]
        clock.advance(1.0)
        while svc.pump():
            pass
        ids = f_ins.result(timeout=0)
        assert np.array_equal(ids, sync.insert(xa))
        for f, r in zip(futs, sync.query_batch(queries[:12])):
            assert _same_result(f.result(timeout=0), r)
    assert lsm.compaction_steps > 0          # folding piggybacks on calls
    f_all = [svc.submit(q) for q in queries]
    lsm.compact()                           # finish the fold, then answer
    assert lsm.compactions >= 1
    svc.flush()
    for f, r in zip(f_all, sync.query_batch(queries)):
        assert _same_result(f.result(timeout=0), r)
    st = svc.stats()
    assert st["completed"] == st["submitted"] == 3 + 6 * 13 + len(queries)
    assert st["backend"]["inserted_rows"] == 240
    # the online refresh: the same history re-learns the same families on
    # both sides, so the new generation answers alike
    assert svc.refresh(wait=True) and sync.refresh(wait=True)
    assert lsm.generation == mirror.generation == 1
    f_ref = [svc.submit(q) for q in queries]
    svc.flush()
    for f, r in zip(f_ref, sync.query_batch(queries)):
        assert _same_result(f.result(timeout=0), r)
    svc.close()


def test_submit_with_retry_backs_off_then_succeeds(index, queries,
                                                   monkeypatch):
    svc = AsyncHashQueryService(index, max_batch=4, max_queue=4,
                                deadline_ms=5.0, clock=FakeClock(),
                                start=False)
    calls = {"n": 0}
    real = svc.submit

    def flaky(w, mask=None):
        calls["n"] += 1
        if calls["n"] < 3:
            raise QueueFullError("full")
        return real(w, mask)

    monkeypatch.setattr(svc, "submit", flaky)
    slept: list[float] = []
    monkeypatch.setattr("repro_torch.serving.async_service.time.sleep",
                        slept.append)
    fut = svc.submit_with_retry(queries[0], attempts=4, backoff_ms=2.0)
    assert calls["n"] == 3
    assert slept == [0.002, 0.004]
    svc.close(drain=True)
    assert fut.result(timeout=5) is not None


def test_submit_with_retry_exhausts(index, queries, monkeypatch):
    svc = AsyncHashQueryService(index, max_batch=2, max_queue=2,
                                deadline_ms=1000.0, clock=FakeClock(),
                                start=False)
    monkeypatch.setattr("repro_torch.serving.async_service.time.sleep",
                        lambda s: None)
    svc.submit(queries[0])
    svc.submit(queries[1])
    with pytest.raises(QueueFullError):
        svc.submit_with_retry(queries[2], attempts=3, backoff_ms=1.0)
    st = svc.stats()
    assert st["shed"] == 3
    assert st["shed_rate"] == pytest.approx(3 / 5)
    svc.close(drain=True)
    assert svc.stats()["completed"] == 2


# -- threaded soak against the real flush thread ------------------------------

@pytest.mark.parametrize("mode", ["probe", "scan"])
def test_threaded_soak_parity(index, queries, mode):
    """4 seeded threads x 24 requests race the deadline-flush thread with
    a shortened switch interval; every answer equals the synchronous
    query_batch's and no request is lost."""
    import sys
    ref = HashQueryService(index, max_batch=8, mode=mode,
                           scan_l=32).query_batch(queries)
    out: dict[int, object] = {}
    errors: list[BaseException] = []
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    svc = AsyncHashQueryService(index, max_batch=8, deadline_ms=1.0,
                                max_queue=512, mode=mode, scan_l=32)
    try:
        def worker(seed: int) -> None:
            order = np.random.default_rng(seed).permutation(
                len(queries))[:24]
            try:
                futs = [(int(i), svc.submit(queries[i])) for i in order]
                for i, f in futs:
                    out[(seed, i)] = f.result(timeout=TIMEOUT_S)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2 * TIMEOUT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old_interval)
        svc.close()
    assert not errors
    assert len(out) == 4 * 24
    st = svc.stats()
    assert st["completed"] == st["submitted"] == 96 and st["shed"] == 0
    assert st["queue_depth"] == 0
    for (_, i), res in out.items():
        assert _same_result(res, ref[i])
