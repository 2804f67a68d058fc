"""The port's replicated-shard router (serving.cluster) on the CPU: the
counterparts of tests/test_cluster.py (healthy, masked, fail-over,
degraded and recovered answers, health hysteresis, catch-up, writes with a
shard down, the service over the router, seeded fault plans), the router
held to the JAX package's router under the same faults, and the port's one
deviation: an error that is not a replica's (here a scan kernel's) raises
instead of degrading the answer.

Tolerances, stated per check:
- router against a fresh port index over the covered rows (same families,
  same torch arithmetic): ids, margins, candidate lists, table hits and
  the nonempty flags identical, ties and l > n sentinels included;
- port router against the JAX router (the JAX replicas' seeded families
  carried in): each package hashes its rows itself, and a code bit may
  differ only where its projection lies within the float32 rounding bound
  of zero (``kernels.ref.sign_flip_ratios`` <= 1); these rows have no such
  bit, which the test asserts.  So the integer stages (candidate lists,
  table hits, coverage) are identical; margins agree within rtol 1e-5 plus
  the float32 rounding bound of the d-term dot product, and ids may differ
  only where two margins tie within that bound.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.indexer import IndexConfig as JConfig  # noqa: E402
from repro.serving import FaultPlan as JFaultPlan  # noqa: E402
from repro.serving import ShardReplicaRouter as JRouter  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.indexer import IndexConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import sign_flip_ratios  # noqa: E402
from repro_torch.serving.cluster import ShardReplicaRouter  # noqa: E402
from repro_torch.serving.faults import FaultPlan  # noqa: E402
from repro_torch.serving.lsm import LSMMultiTableIndex  # noqa: E402
from repro_torch.serving.service import HashQueryService  # noqa: E402
from repro_torch.utils.bits import from_numpy_u32  # noqa: E402

D = 12
SHARDS = 3
REPLICAS = 2
KW = dict(method="bh", bits=12, tables=2, seed=3, lsm_auto=False)


def _cfg(**kw):
    return IndexConfig(**{**KW, **kw})


def _corpus(n=240, seed=0, dup_every=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    if dup_every:
        # duplicate rows across shard boundaries: equal margins and equal
        # Hamming distances, so the cross-shard tie order is exercised
        x[dup_every::dup_every] = x[:n - dup_every:dup_every]
    return x


def _queries(b=8, seed=1):
    return np.random.default_rng(seed).standard_normal((b, D)).astype(
        np.float32)


# routers a test made, closed after it (close waits for a call abandoned
# at its deadline, so none runs on into the next test's monkeypatches)
_OPEN: list = []


@pytest.fixture(autouse=True)
def _close_routers():
    yield
    while _OPEN:
        _OPEN.pop().close()


def _router(x, fault_plan=None, **kw):
    kw.setdefault("shards", SHARDS)
    kw.setdefault("replicas", REPLICAS)
    kw.setdefault("deadline_ms", 2000.0)
    r = ShardReplicaRouter(_cfg(), fault_plan=fault_plan, device="cpu", **kw)
    _OPEN.append(r)
    r.fit(x)
    return r


def _fresh(x):
    return LSMMultiTableIndex(_cfg(), device="cpu").fit(x)


def _assert_same_answer(res_a, res_b, id_map=None):
    """res_a (router) equals res_b (reference); id_map turns the
    reference's ids into global ids (a covered-rows reference hands out
    dense local ids)."""
    ids_b = res_b.ids_topk
    if id_map is not None:
        ids_b = np.where(ids_b >= 0, id_map[np.clip(ids_b, 0, None)], -1)
    assert np.array_equal(res_a.ids_topk, ids_b)
    assert np.array_equal(res_a.margins_topk, res_b.margins_topk)
    assert np.array_equal(res_a.nonempty, res_b.nonempty)
    assert np.array_equal(res_a.table_hits, res_b.table_hits)
    for ca, cb in zip(res_a.candidates, res_b.candidates):
        cb = cb if id_map is None else id_map[cb]
        assert np.array_equal(ca, np.sort(cb))


# -- healthy-path parity -------------------------------------------------------


def test_healthy_parity_bit_identical():
    x = _corpus(dup_every=7)
    router = _router(x)
    w = _queries()
    res_r = router.query_scan_batch(w, l=16, topk=4)
    assert res_r.coverage == 1.0 and not res_r.degraded
    _assert_same_answer(res_r, _fresh(x).query_scan_batch(w, l=16, topk=4))


def test_healthy_parity_after_writes():
    x = _corpus()
    router = _router(x)
    ref = _fresh(x)
    gids = router.insert(x[:17] * 0.5)
    assert np.array_equal(gids, ref.insert(x[:17] * 0.5))
    for ids in ([3, 50, 241], [7]):
        router.delete(ids)
        ref.delete(ids)
    w = _queries()
    res_r = router.query_scan_batch(w, l=16, topk=3)
    assert res_r.coverage == 1.0
    _assert_same_answer(res_r, ref.query_scan_batch(w, l=16, topk=3))


def test_mask_parity():
    x = _corpus()
    router = _router(x)
    mask = np.zeros(x.shape[0], dtype=bool)
    mask[::3] = True
    w = _queries()
    _assert_same_answer(router.query_scan_batch(w, l=16, topk=3, mask=mask),
                        _fresh(x).query_scan_batch(w, l=16, topk=3,
                                                   mask=mask))


# -- the degraded-mode contract ------------------------------------------------


def _covered_rows(n, down_shard):
    return np.sort(np.concatenate(
        [np.arange(s, n, SHARDS) for s in range(SHARDS) if s != down_shard]))


def test_partial_union_bit_identical_to_covered_index():
    """Every replica of one shard down: the answer equals a fresh index's
    over the covered shards' rows, duplicates (ties) included, and
    coverage is the covered live fraction."""
    x = _corpus(dup_every=7)
    plan = FaultPlan()
    router = _router(x, fault_plan=plan)
    for r in range(REPLICAS):
        plan.kill(0, r)
    w = _queries()
    res_d = router.query_scan_batch(w, l=16, topk=4)
    assert res_d.degraded
    cov = _covered_rows(x.shape[0], down_shard=0)
    assert res_d.coverage == pytest.approx(cov.size / x.shape[0])
    _assert_same_answer(res_d, _fresh(x[cov]).query_scan_batch(w, l=16,
                                                                topk=4),
                        id_map=cov)


def test_partial_union_sentinels_when_l_exceeds_covered():
    x = _corpus(n=9)
    plan = FaultPlan()
    router = _router(x, fault_plan=plan)
    for r in range(REPLICAS):
        plan.kill(1, r)
    w = _queries(b=3)
    res_d = router.query_scan_batch(w, l=32, topk=12)
    cov = _covered_rows(9, down_shard=1)
    res_c = _fresh(x[cov]).query_scan_batch(w, l=32, topk=12)
    _assert_same_answer(res_d, res_c, id_map=cov)
    assert (res_d.ids_topk[:, cov.size:] == -1).all()
    assert np.isinf(res_d.margins_topk[:, cov.size:]).all()


def test_all_replicas_down_answers_instead_of_raising():
    x = _corpus()
    plan = FaultPlan()
    router = _router(x, fault_plan=plan)
    for s in range(SHARDS):
        for r in range(REPLICAS):
            plan.kill(s, r)
    res = router.query_scan_batch(_queries(), l=16, topk=2)
    assert res.degraded and res.coverage == 0.0
    assert (res.ids_topk == -1).all()
    assert np.isinf(res.margins_topk).all()
    assert not res.nonempty.any()


# -- failover ladder -----------------------------------------------------------


def test_single_replica_kill_fails_over_exactly():
    x = _corpus()
    plan = FaultPlan()
    router = _router(x, fault_plan=plan)
    ref = _fresh(x)
    plan.kill(0, 0)
    plan.kill(1, 1)
    w = _queries()
    # two queries, so the rotation visits both replicas of each shard
    for _ in range(2):
        res_r = router.query_scan_batch(w, l=16, topk=3)
        assert res_r.coverage == 1.0 and not res_r.degraded
        _assert_same_answer(res_r, ref.query_scan_batch(w, l=16, topk=3))
    st = router.stats()
    assert st["replica_downs"] == 2
    assert st["failovers"] >= 1


def test_deadline_timeout_fails_over_exactly():
    """A scripted delay past the deadline reads as a dead replica: the
    ladder retries the sibling and the answer stays exact."""
    x = _corpus()
    plan = FaultPlan()
    plan.delay_at(0, 1, 0, ms=500.0)   # the first rotation starts at 1
    router = _router(x, fault_plan=plan, deadline_ms=100.0)
    w = _queries()
    res_r = router.query_scan_batch(w, l=16, topk=3)
    assert res_r.coverage == 1.0
    _assert_same_answer(res_r, _fresh(x).query_scan_batch(w, l=16, topk=3))
    assert router.stats()["timeouts"] >= 1


def test_dropped_response_fails_over_exactly():
    x = _corpus()
    plan = FaultPlan()
    plan.drop_at(0, 1, 0)
    router = _router(x, fault_plan=plan)
    w = _queries()
    res_r = router.query_scan_batch(w, l=16, topk=3)
    assert res_r.coverage == 1.0
    _assert_same_answer(res_r, _fresh(x).query_scan_batch(w, l=16, topk=3))
    assert router.stats()["failovers"] >= 1


# -- health hysteresis and catch-up --------------------------------------------


def test_readmit_requires_consecutive_probes():
    x = _corpus()
    plan = FaultPlan()
    router = _router(x, fault_plan=plan, readmit_probes=2)
    plan.kill(2, 0)
    w = _queries(b=2)
    for _ in range(2):                  # the rotation must try (2, 0)
        router.query_scan_batch(w)
    assert not router.health()[2][0]["alive"]
    plan.revive(2, 0)
    router.query_scan_batch(w)          # probe success 1 of 2
    assert not router.health()[2][0]["alive"]
    router.query_scan_batch(w)          # probe success 2 of 2: re-admit
    assert router.health()[2][0]["alive"]
    assert router.stats()["readmits"] == 1


def test_flapping_replica_does_not_thrash_back_in():
    x = _corpus()
    plan = FaultPlan()
    router = _router(x, fault_plan=plan, readmit_probes=3)
    plan.kill(2, 0)
    w = _queries(b=2)
    for _ in range(2):
        router.query_scan_batch(w)
    assert not router.health()[2][0]["alive"]
    plan.revive(2, 0)
    router.query_scan_batch(w)          # probe ok (1/3)
    plan.kill(2, 0)
    router.query_scan_batch(w)          # probe fails: the count resets
    assert not router.health()[2][0]["alive"]
    plan.revive(2, 0)
    for _ in range(3):
        router.query_scan_batch(w)
    assert router.health()[2][0]["alive"]


def test_recovered_replica_catches_up_missed_writes():
    """Writes that land while a replica is down are repaired from the row
    log at re-admission (the refresh's shadow-build path), and the answers
    after recovery equal a fresh full index's."""
    x = _corpus()
    plan = FaultPlan()
    router = _router(x, fault_plan=plan, readmit_probes=2)
    ref = _fresh(x)
    plan.kill(1, 0)
    w = _queries()
    router.query_scan_batch(w)          # demote (1, 0)
    extra = _corpus(n=13, seed=9)
    assert np.array_equal(router.insert(extra), ref.insert(extra))
    router.delete([1, 4, 245])
    ref.delete([1, 4, 245])
    h = router.health()[1][0]
    assert not h["alive"] and h["applied"] < h["writes"]
    plan.revive(1, 0)
    for _ in range(3):
        res = router.query_scan_batch(w, l=16, topk=3)
    assert router.health()[1][0]["alive"]
    assert router.health()[1][0]["applied"] == router.health()[1][0]["writes"]
    assert router.stats()["catchups"] == 1
    assert router.replica(1, 0).generation == 1   # adopted a shadow
    assert res.coverage == 1.0
    _assert_same_answer(res, ref.query_scan_batch(w, l=16, topk=3))
    plan.kill(1, 1)                     # the caught-up replica alone
    res2 = router.query_scan_batch(w, l=16, topk=3)
    assert res2.coverage == 1.0
    _assert_same_answer(res2, ref.query_scan_batch(w, l=16, topk=3))


def test_whole_shard_outage_with_writes_recovers_to_parity():
    """Writes succeed logically with a whole shard down; after revive and
    hysteresis both replicas rebuild from the row log (families from the
    config, no sibling being current) and the cluster is back to full
    coverage and parity."""
    x = _corpus()
    plan = FaultPlan()
    router = _router(x, fault_plan=plan, readmit_probes=2)
    ref = _fresh(x)
    for r in range(REPLICAS):
        plan.kill(0, r)
    extra = _corpus(n=11, seed=7)
    assert np.array_equal(router.insert(extra), ref.insert(extra))
    router.delete([0, 9])               # gids 0 and 9 live in shard 0
    ref.delete([0, 9])
    w = _queries()
    assert router.query_scan_batch(w).degraded
    for r in range(REPLICAS):
        plan.revive(0, r)
    steps = 0
    while steps < 6:
        steps += 1
        res = router.query_scan_batch(w, l=16, topk=3)
        if res.coverage == 1.0:
            break
    assert res.coverage == 1.0 and steps <= 3
    assert router.stats()["catchups"] == REPLICAS
    _assert_same_answer(res, ref.query_scan_batch(w, l=16, topk=3))


# -- delete validation and the port's error contract ---------------------------


def test_bad_delete_is_callers_error_not_a_health_event():
    x = _corpus()
    router = _router(x)
    with pytest.raises(KeyError):
        router.delete([10 ** 6])
    router.delete([5])
    with pytest.raises(KeyError):
        router.delete([5])              # already deleted
    with pytest.raises(KeyError):
        router.delete([7, 7])           # duplicates
    with pytest.raises(ValueError, match="width"):
        router.insert(np.zeros((2, D + 1), np.float32))
    assert all(h["alive"] for row in router.health() for h in row)
    assert router.n == x.shape[0] - 1


def test_kernel_error_raises_instead_of_degrading(monkeypatch):
    """A scan kernel that fails (a wrapper raising RuntimeError, as a
    failed build or launch does) makes query_scan_batch raise: it is not a
    replica failure, so no replica goes down and no answer degrades."""
    x = _corpus()
    router = _router(x)
    w = _queries()

    def broken(*a, **k):
        raise RuntimeError("topk_hist launch failed: CUDA error 98")

    monkeypatch.setattr(ops, "hamming_topk_hist", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        router.query_scan_batch(w, l=16)
    st = router.stats()
    assert st["replica_downs"] == 0 and st["failovers"] == 0
    assert st["degraded_answers"] == 0
    assert all(h["alive"] and h["fails"] == 0
               for row in router.health() for h in row)
    monkeypatch.undo()
    _assert_same_answer(router.query_scan_batch(w, l=16, topk=2),
                        _fresh(x).query_scan_batch(w, l=16, topk=2))


def test_first_use_build_error_raises_instead_of_degrading(tmp_path,
                                                          monkeypatch):
    """A kernel library built at its first use inside a replica call: nvcc
    (a script here that fails after 0.3 s) outlasts the 50 ms deadline, but
    the deadline does not count a build, so the build's error raises out of
    query_scan_batch; no replica times out or goes down, no answer
    degrades."""
    from repro_torch.kernels import _build
    x = _corpus()
    router = _router(x, deadline_ms=50.0)
    w = _queries()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "cold.cu").write_text("int a;\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nsleep 0.3\necho 'cold.cu: error'\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_LIBS", {})
    scan = ops.hamming_topk_hist

    def cold_scan(*a, **k):
        _build.load("cold", {})
        return scan(*a, **k)

    monkeypatch.setattr(ops, "hamming_topk_hist", cold_scan)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        router.query_scan_batch(w, l=16)
    st = router.stats()
    assert st["timeouts"] == 0 and st["replica_downs"] == 0
    assert st["failovers"] == 0 and st["degraded_answers"] == 0
    assert not _build.building()
    monkeypatch.undo()
    # the scenario ends here; the identity check after it runs at the
    # fixture's deadline, out of reach of the host's speed
    router.deadline_s = 2.0
    _assert_same_answer(router.query_scan_batch(w, l=16, topk=2),
                        _fresh(x).query_scan_batch(w, l=16, topk=2))


def _wait_for(cond, timeout=10.0):
    import time
    t_end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t_end, "condition not reached"
        time.sleep(0.01)


def test_late_kernel_error_is_raised_by_the_next_query(monkeypatch):
    """A scan that outlasts the deadline and then fails with a non-fault
    error: that query degrades (its replicas were late: real timeouts), and
    the late error, recorded on the replicas when their abandoned calls
    end, raises out of the next write (before it touches the log) and the
    next query instead of another degraded answer.  The query's probes
    re-admit the replicas, so the one after answers in full."""
    import time
    x = _corpus()
    router = _router(x, deadline_ms=50.0, readmit_probes=1)
    w = _queries()

    def late(*a, **k):
        time.sleep(0.2)
        raise RuntimeError("topk_hist launch failed: CUDA error 700")

    monkeypatch.setattr(ops, "hamming_topk_hist", late)
    res = router.query_scan_batch(w, l=16)
    assert res.coverage == 0.0 and res.degraded
    assert router.stats()["timeouts"] == SHARDS * REPLICAS
    _wait_for(lambda: all(h["error"] for row in router.health()
                          for h in row))
    monkeypatch.undo()
    version = router.stats()["version"]
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        router.insert(x[:3])
    assert router.stats()["version"] == version and router.n == x.shape[0]
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        router.query_scan_batch(w, l=16)
    assert router.stats()["degraded_answers"] == 1
    assert all(h["alive"] and h["error"] is None
               for row in router.health() for h in row)
    # as above: the identity check runs at the fixture's deadline
    router.deadline_s = 2.0
    _assert_same_answer(router.query_scan_batch(w, l=16, topk=2),
                        _fresh(x).query_scan_batch(w, l=16, topk=2))


def test_write_kernel_error_raises_from_queries_until_caught_up(monkeypatch):
    """A hash kernel that fails on an insert: the rows are committed to the
    router's log (the insert raises after every push was tried) and every
    replica that raised leaves the rotation with the error recorded.  Until
    they are re-admitted, a retried write raises before touching the log
    and every query raises the error instead of answering degraded; the
    re-admission catches them up from the log, and the answers equal a
    fresh index's over all rows, the committed insert's included."""
    x = _corpus()
    router = _router(x, readmit_probes=2)
    ref = _fresh(x)
    w = _queries()
    extra = _corpus(n=13, seed=9)

    def broken(*a, **k):
        raise RuntimeError("bh_seeded launch failed: CUDA error 98")

    monkeypatch.setattr(ops, "bilinear_hash_seeded_grouped", broken)
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        router.insert(extra)
    monkeypatch.undo()
    ref.insert(extra)
    assert router.n == ref.n
    assert all(not h["alive"] and "CUDA error 98" in h["error"]
               for row in router.health() for h in row)
    version = router.stats()["version"]
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        router.insert(extra)
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        router.delete([5])
    assert router.stats()["version"] == version and router.n == ref.n
    for _ in range(2):      # the second query's probes catch up, re-admit
        with pytest.raises(RuntimeError, match="CUDA error 98"):
            router.query_scan_batch(w, l=16)
    st = router.stats()
    assert st["degraded_answers"] == 0
    assert st["catchups"] == SHARDS * REPLICAS
    assert all(h["alive"] and h["error"] is None
               for row in router.health() for h in row)
    res = router.query_scan_batch(w, l=16, topk=3)
    assert res.coverage == 1.0
    _assert_same_answer(res, ref.query_scan_batch(w, l=16, topk=3))


# -- service integration -------------------------------------------------------


def test_service_over_router_matches_service_over_index():
    x = _corpus()
    router = _router(x)
    svc_r = HashQueryService(router, mode="scan", scan_l=16)
    svc_f = HashQueryService(_fresh(x), mode="scan", scan_l=16)
    assert svc_r.refresher is None      # no refresh surface on the router
    w = _queries(b=10)
    for a, b in zip(svc_r.query_batch(w), svc_f.query_batch(w)):
        assert a.index == b.index and a.margin == b.margin
        assert np.array_equal(a.candidates, b.candidates)
    st = svc_r.stats()
    assert st["degraded_batches"] == 0 and st["last_coverage"] == 1.0


def test_service_surfaces_degraded_coverage():
    x = _corpus()
    plan = FaultPlan()
    router = _router(x, fault_plan=plan)
    svc = HashQueryService(router, mode="scan", scan_l=16)
    for r in range(REPLICAS):
        plan.kill(0, r)
    svc.query_batch(_queries(b=4))
    st = svc.stats()
    assert st["degraded_batches"] >= 1
    assert 0.0 < st["last_coverage"] < 1.0


# -- fault-plan determinism ----------------------------------------------------


def test_seeded_plan_never_covers_a_whole_shard():
    for seed in range(5):
        plan = FaultPlan.seeded(seed, shards=SHARDS, replicas=REPLICAS)
        killed = {(s, r) for (s, r, c), evs in plan._events.items()
                  for ev in evs if ev[0] in ("kill", "flap")}
        for s in range(SHARDS):
            assert {(s, r) for r in range(REPLICAS)} - killed, \
                f"seed {seed} kills every replica of shard {s}"


def _soak(router, w, writes):
    coverages = []
    for i in range(12):
        if i % 4 == 3:
            writes.append(("insert", _corpus(n=3, seed=100 + i)))
            router.insert(writes[-1][1])
        if i == 7:
            writes.append(("delete", [2]))
            router.delete([2])
        coverages.append(router.query_scan_batch(w, l=16).coverage)
    return coverages


def test_seeded_soak_is_replayable_and_exception_free():
    """Same seed, same calls: the same injected-fault log, no uncaught
    exception, full coverage throughout (the seeded plan leaves one live
    replica per shard), and parity with a fresh index at the end."""
    x = _corpus()
    w = _queries(b=4)
    runs = []
    for _ in range(2):
        plan = FaultPlan.seeded(11, SHARDS, REPLICAS, horizon_calls=40)
        router = _router(x, fault_plan=plan, readmit_probes=1)
        writes = []
        runs.append((_soak(router, w, writes), list(plan.log), router,
                     writes))
    (cov_a, log_a, router_a, writes), (cov_b, log_b, _, _) = runs
    assert log_a == log_b and len(log_a) > 0
    assert cov_a == cov_b
    assert all(c == 1.0 for c in cov_a)
    ref = _fresh(x)
    for op, arg in writes:
        getattr(ref, op)(arg)
    _assert_same_answer(router_a.query_scan_batch(w, l=16, topk=3),
                        ref.query_scan_batch(w, l=16, topk=3))


# -- against the JAX package's router ------------------------------------------


def _margin_tol(x_by_id, ws, ids, want):
    """rtol 1e-5 plus the float32 rounding bound of |w . x| / ||w||."""
    terms = np.abs(x_by_id[np.clip(ids, 0, None)] * ws[:, None, :]).sum(-1)
    bound = (ws.shape[1] + 8) * 2.0 ** -23 * terms / np.linalg.norm(
        ws, axis=1, keepdims=True)
    return 1e-5 * np.abs(np.where(np.isfinite(want), want, 0)) + bound


def _assert_like_jax(tres, jres, x_by_id, ws):
    assert tres.coverage == jres.coverage
    assert tres.degraded == jres.degraded
    assert np.array_equal(tres.table_hits, jres.table_hits)
    assert np.array_equal(tres.nonempty, jres.nonempty)
    for a, b in zip(tres.candidates, jres.candidates):
        assert np.array_equal(a, b)
    m_t, m_j = tres.margins_topk, jres.margins_topk
    assert np.array_equal(np.isinf(m_t), np.isinf(m_j))
    fin = np.isfinite(m_j)
    tol = _margin_tol(x_by_id, ws, jres.ids_topk, m_j)
    assert np.all(np.abs(m_t - m_j)[fin] <= tol[fin])
    differ = tres.ids_topk != jres.ids_topk
    if differ.any():
        alt = _margin_tol(x_by_id, ws, tres.ids_topk, m_t)
        assert np.all(np.abs(m_t - m_j)[differ] <= tol[differ] + alt[differ])


# both routers' deadline in the comparison with the JAX router: its first
# query compiles the JAX scan inside the deadline (0.7 s on an idle host,
# past 2 s under a loaded one, where a timeout then adds a failover the
# port's router does not make); the scenarios' faults are injected (kill,
# drop_at), so no call here needs a deadline to fail over
JAX_PARITY_DEADLINE_MS = 120_000.0


@pytest.mark.parametrize("scenario", ["failover", "degraded", "recovered"])
def test_router_matches_jax_router(scenario):
    """The same faults and writes on both routers, the JAX replicas'
    seeded families carried into every port replica: identical codes, and
    the healthy, fail-over, degraded and recovered answers agree (header);
    each port answer also equals a fresh port index's over its rows."""
    x = _corpus(n=300, seed=4, dup_every=11)
    ws = _queries(b=8, seed=5)
    jplan, tplan = JFaultPlan(), FaultPlan()
    jr = JRouter(JConfig(**KW), shards=SHARDS, replicas=REPLICAS,
                 deadline_ms=JAX_PARITY_DEADLINE_MS, fault_plan=jplan).fit(x)
    specs = [{"kind": "seeded_bh", "seed": f.seed, "u": np.asarray(f.u),
              "v": np.asarray(f.v)} for f in jr._replicas[0][0].families]
    fams = interop.families_from_numpy(specs, device="cpu")
    tr = ShardReplicaRouter(_cfg(), shards=SHARDS, replicas=REPLICAS,
                            deadline_ms=JAX_PARITY_DEADLINE_MS,
                            fault_plan=tplan, device="cpu").fit(
                                x, families=fams)
    for s in range(SHARDS):
        got = np.stack(tr.replica(s, 0).codes)
        want = np.stack(jr._replicas[s][0].codes)
        ratios = sign_flip_ratios(
            torch.from_numpy(x[s::SHARDS]), [(f.u, f.v) for f in fams],
            from_numpy_u32(got), from_numpy_u32(want))
        assert (ratios <= 1.0).all()
        assert np.array_equal(got, want), "a near-zero bit flipped"
    ref_rows = np.arange(x.shape[0])
    x_all = x

    def both(**kw):
        return (tr.query_scan_batch(ws, l=16, topk=3, **kw),
                jr.query_scan_batch(ws, l=16, topk=3, **kw))

    tres, jres = both()                 # healthy
    _assert_like_jax(tres, jres, x_all, ws)
    if scenario == "failover":
        for plan in (jplan, tplan):
            plan.kill(0, 1)
            plan.drop_at(2, 0, 1)
        for _ in range(2):
            tres, jres = both()
            assert tres.coverage == 1.0
            _assert_like_jax(tres, jres, x_all, ws)
        assert tr.stats()["failovers"] == jr.stats()["failovers"] >= 1
        assert tr.stats()["timeouts"] == jr.stats()["timeouts"] == 0
    elif scenario == "degraded":
        for plan in (jplan, tplan):
            plan.kill(1, 0)
            plan.kill(1, 1)
        tres, jres = both()
        assert tres.degraded and tres.coverage < 1.0
        _assert_like_jax(tres, jres, x_all, ws)
        ref_rows = _covered_rows(x.shape[0], down_shard=1)
    else:
        for plan in (jplan, tplan):
            plan.kill(1, 0)
        both()                          # demote (1, 0) on both
        extra = _corpus(n=20, seed=8)
        assert np.array_equal(tr.insert(extra), jr.insert(extra))
        tr.delete([1, 4, 301])
        jr.delete([1, 4, 301])
        for plan in (jplan, tplan):
            plan.revive(1, 0)
        for _ in range(3):
            tres, jres = both()
        assert tr.stats()["catchups"] == jr.stats()["catchups"] == 1
        x_all = np.concatenate([x, extra])
        _assert_like_jax(tres, jres, x_all, ws)
        ref = LSMMultiTableIndex(_cfg(), device="cpu").fit(
            x, families=fams)
        ref.insert(extra)
        ref.delete([1, 4, 301])
        _assert_same_answer(tres, ref.query_scan_batch(ws, l=16, topk=3))
        return
    ref = LSMMultiTableIndex(_cfg(), device="cpu").fit(x[ref_rows],
                                                       families=fams)
    _assert_same_answer(tres, ref.query_scan_batch(ws, l=16, topk=3),
                        id_map=ref_rows)
