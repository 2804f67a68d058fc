"""The port's online refresh (serving.refresh) on the CPU: the counterparts
of tests/test_refresh.py (learning determinism, refresh against an offline
rebuild, cache invalidation, stable ids, catch-up of concurrent ingest, the
swap under fire, the ingest-volume policy, an abandoned compaction, the LSM
requirement, the traffic-weighted pool, failures that leave the live index
untouched), plus the same refresh run by the JAX package and the port on
the same rows.

Tolerances, stated per check:
- port against port (same snapshot, seed and generation; same torch
  arithmetic at the same shapes): families, codes, ids and answers
  identical;
- port against the JAX package (the JAX shadow's learned families carried
  into the port through the learning seam ``_learn_families``): each
  package hashes the snapshot and the catch-up rows itself, and a code bit
  may differ only where its projection lies within the float32 rounding
  bound of zero (``kernels.ref.sign_flip_ratios`` <= 1); this test's rows
  have no such bit, which it asserts, so codes, ids, tombstones and the
  per-table Hamming lists (distances and stable ids) must be identical and
  the candidate lists too.  Margins agree within rtol 1e-5 plus the float32
  rounding bound of the d-term dot product; ids may differ only where two
  margins tie within that bound.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.indexer import IndexConfig as JConfig  # noqa: E402
from repro.serving import LSMMultiTableIndex as JLSM  # noqa: E402
from repro.serving import RefreshManager as JRefresh  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import functions as F  # noqa: E402
from repro_torch.core.indexer import IndexConfig  # noqa: E402
from repro_torch.core.tables import keys_of  # noqa: E402
from repro_torch.kernels.ref import sign_flip_ratios  # noqa: E402
from repro_torch.serving import refresh as R  # noqa: E402
from repro_torch.serving.lsm import LSMMultiTableIndex  # noqa: E402
from repro_torch.serving.multi_table import MultiTableIndex  # noqa: E402
from repro_torch.serving.refresh import RefreshManager  # noqa: E402
from repro_torch.serving.service import HashQueryService  # noqa: E402
from repro_torch.utils.bits import from_numpy_u32  # noqa: E402

D = 12
KW = dict(method="bh", bits=12, tables=2, seed=3, lsm_auto=False,
          lbh_sample=64, lbh_steps=6, lbh_lr=0.05)


def _cfg(**kw):
    return IndexConfig(**{**KW, **kw})


def _lsm(cfg, x):
    return LSMMultiTableIndex(cfg, device="cpu").fit(x)


def _fit(rng, n=220, **kw):
    x = rng.normal(size=(n, D)).astype(np.float32)
    return _lsm(_cfg(**kw), x), x


def test_refresh_learning_deterministic():
    """Two identical histories give identical families, codes and id
    layout after the refresh, learned under the generation's seed."""
    seed_rng = np.random.default_rng(0)
    x = seed_rng.normal(size=(220, D)).astype(np.float32)
    ins = seed_rng.normal(size=(30, D)).astype(np.float32)
    out = []
    for _ in range(2):
        idx = _lsm(_cfg(), x)
        ids = idx.insert(ins)
        idx.delete(ids[:5])
        assert RefreshManager(idx).refresh(wait=True)
        out.append(idx)
    a, b = out
    assert a.generation == b.generation == 1
    assert all(type(f) is F.LBHHash for f in a.families)
    for fa, fb in zip(a.families, b.families):
        assert torch.equal(fa.u, fb.u) and torch.equal(fa.v, fb.v)
    assert a._rows == b._rows
    assert np.array_equal(a._codes_buf[:, :a._rows],
                          b._codes_buf[:, :b._rows])
    assert np.array_equal(a.ids_np, b.ids_np)
    # the seed namespace: disjoint from every fit-time table seed
    s1 = R.learn_seed(3, 0)
    assert s1 == F.table_seed(3, R._LEARN_TAG + 1)
    assert s1 not in {F.table_seed(3, t) for t in range(64)}


def test_refresh_matches_offline_rebuild():
    """The swapped-in state equals an offline ``_install`` of the same live
    rows under the same families."""
    rng = np.random.default_rng(1)
    idx, _ = _fit(rng)
    ids = idx.insert(rng.normal(size=(40, D)).astype(np.float32))
    idx.delete(ids[:8])
    idx.delete(np.asarray([2, 17, 33]))
    x_live = idx.x_np[idx.active].copy()
    ids_live = idx.ids_np[idx.active].copy()
    hi = idx._next_id
    assert RefreshManager(idx).refresh(wait=True)

    off = LSMMultiTableIndex(_cfg(method=idx.config.refresh_method),
                             tables=idx.num_tables, device="cpu")
    off._install(x_live, idx.families, ids=ids_live, next_id=hi,
                 bcap_floor=idx._bcap)
    assert np.array_equal(idx._codes_buf[:, :idx._rows],
                          off._codes_buf[:, :off._rows])
    assert np.array_equal(idx.ids_np, off.ids_np)

    ws = rng.normal(size=(6, D)).astype(np.float32)
    ra = idx.query_scan_batch(ws, l=12, topk=3)
    rb = off.query_scan_batch(ws, l=12, topk=3)
    assert np.array_equal(ra.ids_topk, rb.ids_topk)
    assert np.array_equal(ra.margins_topk, rb.margins_topk)
    pa = idx.query_batch(ws)
    pb = off.query_batch(ws)
    assert np.array_equal(pa.ids, pb.ids)
    assert np.array_equal(pa.margins, pb.margins)


def test_refresh_invalidates_query_cache():
    """The swap bumps ``version``: the service's query-code cache drops
    every old-generation list and fills again after."""
    rng = np.random.default_rng(2)
    idx, _ = _fit(rng)
    svc = HashQueryService(idx, mode="probe", cache_size=64)
    ws = rng.normal(size=(5, D)).astype(np.float32)
    svc.query_batch(ws)
    svc.query_batch(ws)
    assert svc.cache_hits == ws.shape[0]
    v0, g0 = idx.version, idx.generation
    assert svc.refresh(wait=True)
    assert idx.version > v0 and idx.generation == g0 + 1
    hits = svc.cache_hits
    res_a = svc.query_batch(ws)       # cold: the swap dropped the cache
    assert svc.cache_hits == hits
    res_b = svc.query_batch(ws)       # warm again, same answers
    assert svc.cache_hits == hits + ws.shape[0]
    assert [r.index for r in res_a] == [r.index for r in res_b]
    assert svc.stats()["refresh"]["refreshes_done"] == 1


def test_ids_stable_and_tombstones_dropped_across_swap():
    rng = np.random.default_rng(3)
    idx, _ = _fit(rng, n=150)
    new_ids = idx.insert(rng.normal(size=(20, D)).astype(np.float32))
    idx.delete(np.asarray([4, 9]))
    survivors = np.setdiff1d(np.arange(150), [4, 9])
    assert RefreshManager(idx).refresh(wait=True)
    rows = idx.ids_to_rows(np.concatenate([survivors, new_ids]))
    assert idx.active[rows].all()
    assert np.array_equal(idx.ids_np, np.sort(idx.ids_np))
    assert idx.n == 150 - 2 + 20
    with pytest.raises(KeyError):     # tombstoned rows are gone
        idx.ids_to_rows(np.asarray([4]))
    post = idx.insert(rng.normal(size=(3, D)).astype(np.float32))
    assert post.min() > new_ids.max()


def test_concurrent_ingest_catches_up_into_new_generation():
    """Rows inserted while the re-learn runs land in the swapped index,
    filed under the new generation's codes (buffer codes and probe-table
    buckets agree); rows deleted meanwhile stay dead."""
    rng = np.random.default_rng(4)
    idx, _ = _fit(rng)
    mgr = RefreshManager(idx)
    started = threading.Event()
    release = threading.Event()
    orig_pool = mgr._learning_pool

    def slow_pool(x_snap):
        # hold the learn phase open until the writer is done, so the
        # insert and delete land before the swap deterministically
        started.set()
        release.wait(60)
        return orig_pool(x_snap)

    mgr._learning_pool = slow_pool
    assert mgr.refresh(wait=False)
    assert started.wait(10)
    mid = idx.insert(rng.normal(size=(25, D)).astype(np.float32))
    idx.delete(mid[:4])
    release.set()
    mgr.wait_idle(60)
    assert mgr.refreshes_done == 1 and idx.generation == 1
    assert mgr.last_catchup_rows >= mid.size - 4
    rows = idx.ids_to_rows(mid[4:])
    assert idx.active[rows].all()
    for t in range(idx.num_tables):
        keys = keys_of(idx._codes_buf[t, rows])
        for i, key in zip(mid[4:], keys):
            assert int(i) in idx.tables[t].buckets[int(key)].tolist()
    with pytest.raises(KeyError):
        idx.ids_to_rows(mid[:1])


def test_queries_survive_swap_under_fire():
    """query_batch hammered from a second thread straight through a
    refresh: every answer is a live stable id or -1, never an error."""
    rng = np.random.default_rng(5)
    idx, _ = _fit(rng)
    svc = HashQueryService(idx, mode="scan", scan_l=8, max_batch=8)
    ws = rng.normal(size=(8, D)).astype(np.float32)
    errs: list[BaseException] = []
    stop = threading.Event()
    answered = [0]

    def fire():
        try:
            while not stop.is_set():
                for r in svc.query_batch(ws):
                    assert r.index == -1 or r.index >= 0
                answered[0] += 1
        except BaseException as e:   # pragma: no cover - failure path
            errs.append(e)

    t = threading.Thread(target=fire)
    t.start()
    try:
        assert svc.refresh(wait=True)
    finally:
        stop.set()
        t.join(30)
    assert not errs and answered[0] > 0
    assert idx.generation == 1


def test_auto_refresh_policy_on_ingest_volume():
    rng = np.random.default_rng(6)
    idx, _ = _fit(rng, refresh_ingest_rows=50)
    svc = HashQueryService(idx, mode="scan", scan_l=8)
    svc.insert(rng.normal(size=(30, D)).astype(np.float32))
    assert svc.refresher.refreshes_started == 0   # below the threshold
    svc.insert(rng.normal(size=(30, D)).astype(np.float32))
    svc.refresher.wait_idle(60)
    assert svc.refresher.refreshes_done == 1
    assert idx.generation == 1


def test_refresh_abandons_inflight_compaction():
    rng = np.random.default_rng(7)
    idx, _ = _fit(rng)
    ids = idx.insert(rng.normal(size=(60, D)).astype(np.float32))
    idx.delete(ids[:10])
    assert idx.begin_compaction()
    idx.compaction_step(max_rows=32)       # leave the fold half done
    assert idx._c is not None
    assert RefreshManager(idx).refresh(wait=True)
    assert idx._c is None                  # the swap dropped the fold
    ids2 = idx.insert(rng.normal(size=(10, D)).astype(np.float32))
    idx.delete(ids2)
    live = idx.compact()
    assert live.size == idx.n


def test_swap_hands_back_the_old_generation_to_release():
    """``_adopt_refresh`` returns the generation it replaced (probe tables,
    buffers, device state) for the caller to free after the lock;
    ``release`` empties it without touching the live index."""
    rng = np.random.default_rng(13)
    idx, x = _fit(rng)
    idx.insert(rng.normal(size=(9, D)).astype(np.float32))   # id -> key map
    ws = rng.normal(size=(5, D)).astype(np.float32)
    old_tables, old_x = idx.tables, idx._x_buf
    shadow = LSMMultiTableIndex(_cfg(), device="cpu")
    shadow._install(idx.x_np[idx.active], idx.families,
                    ids=idx.ids_np[idx.active], next_id=idx._next_id)
    want = shadow.query_scan_batch(ws, l=12, topk=3)
    with idx._lock:
        retired = idx._adopt_refresh(shadow)
    assert retired["tables"] is old_tables
    assert retired["buffers"][1] is old_x
    assert old_tables[0]._id_key        # the map the insert built
    R.release(retired)
    assert retired == {}
    assert all(not t.buckets and not t._id_key for t in old_tables)
    got = idx.query_scan_batch(ws, l=12, topk=3)
    assert np.array_equal(got.ids_topk, want.ids_topk)
    assert np.array_equal(got.margins_topk, want.margins_topk)
    assert idx.tables is shadow.tables and idx.tables[0].buckets


def test_refresh_requires_lsm_index():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(100, D)).astype(np.float32)
    idx = MultiTableIndex(_cfg(), device="cpu").fit(x)
    svc = HashQueryService(idx)
    assert svc.refresher is None
    with pytest.raises(RuntimeError, match="generation-swap"):
        svc.refresh()


def test_traffic_weighted_pool_is_deterministic_and_bounded():
    rng = np.random.default_rng(9)
    idx, x = _fit(rng, refresh_traffic_sample=True, lbh_sample=16)
    mgr = RefreshManager(idx)
    ws = rng.normal(size=(12, D)).astype(np.float32)
    mgr.note_queries(ws)
    pool_a = mgr._learning_pool(x)
    pool_b = mgr._learning_pool(x)
    assert torch.equal(pool_a, pool_b)
    assert pool_a.shape[0] == min(x.shape[0], 4 * 16)
    # the rows kept are those nearest the recent normals, in row order
    near = (np.abs(x @ ws.T) / np.linalg.norm(ws, axis=1)).min(axis=1)
    want = np.sort(np.argsort(near, kind="stable")[:64])
    assert torch.equal(pool_a, torch.from_numpy(x[want]))
    # without traffic on record, the pool is the whole snapshot
    assert RefreshManager(idx)._learning_pool(x).shape[0] == x.shape[0]


def test_refresh_failure_leaves_live_index_untouched(monkeypatch):
    """learn_lbh raising mid-refresh leaves the live index as it was: the
    generation, the answers, no lock held; the next refresh() succeeds."""
    import repro_torch.core.learning as learning

    rng = np.random.default_rng(10)
    idx, x = _fit(rng)
    w = rng.normal(size=(8, D)).astype(np.float32)
    before = idx.query_scan_batch(w, l=16, topk=3)
    gen0, ver0 = idx.generation, idx.version

    def boom(*a, **k):
        raise RuntimeError("learn exploded")

    monkeypatch.setattr(learning, "learn_lbh", boom)
    mgr = RefreshManager(idx)
    with pytest.raises(RuntimeError, match="learn exploded"):
        mgr.refresh(wait=True)
    st = mgr.stats()
    assert st["refreshes_failed"] == 1 and not st["busy"]
    assert "learn exploded" in st["last_error"]
    assert idx.generation == gen0 and idx.version == ver0
    after = idx.query_scan_batch(w, l=16, topk=3)
    assert np.array_equal(before.ids_topk, after.ids_topk)
    assert np.array_equal(before.margins_topk, after.margins_topk)
    idx.insert(rng.normal(size=(5, D)).astype(np.float32))
    monkeypatch.undo()
    assert mgr.refresh(wait=True)
    assert idx.generation == gen0 + 1
    assert mgr.stats()["last_error"] is None
    assert mgr.stats()["refreshes_done"] == 1


def test_background_refresh_failure_is_recorded_not_raised(monkeypatch):
    import repro_torch.core.learning as learning

    rng = np.random.default_rng(11)
    idx, _ = _fit(rng)

    def boom(*a, **k):
        raise RuntimeError("bg boom")

    monkeypatch.setattr(learning, "learn_lbh", boom)
    mgr = RefreshManager(idx)
    assert mgr.refresh(wait=False)
    mgr.wait_idle()
    st = mgr.stats()
    assert st["refreshes_failed"] == 1 and not st["busy"]
    assert "bg boom" in st["last_error"]
    monkeypatch.undo()
    assert mgr.refresh(wait=True)
    assert mgr.stats()["refreshes_done"] == 1


# -- against the JAX package's RefreshManager --------------------------------

def _margin_tol(x_by_id, ws, ids, want):
    """rtol 1e-5 plus the float32 rounding bound of |w . x| / ||w||."""
    terms = np.abs(x_by_id[np.clip(ids, 0, None)] * ws[:, None, :]).sum(-1)
    bound = (ws.shape[1] + 8) * 2.0 ** -23 * terms / np.linalg.norm(
        ws, axis=1, keepdims=True)
    return 1e-5 * np.abs(np.where(np.isfinite(want), want, 0)) + bound


def test_refresh_matches_jax_refresh():
    """The same history and the same refresh (a mid-refresh insert and
    delete, so the catch-up and the delete reconcile run) on both
    packages, the JAX shadow's learned families carried into the port's:
    the swapped-in states and their scan answers agree (header)."""
    kw = dict(KW, bits=16, lbh_sample=48)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(300, D)).astype(np.float32)
    ins = rng.normal(size=(40, D)).astype(np.float32)
    mid = rng.normal(size=(17, D)).astype(np.float32)
    ws = rng.normal(size=(8, D)).astype(np.float32)
    jidx = JLSM(JConfig(**kw)).fit(x)
    tidx = interop.index_from_numpy(
        IndexConfig(**kw),
        [{"kind": "seeded_bh", "seed": f.seed, "u": np.asarray(f.u),
          "v": np.asarray(f.v)} for f in jidx.families],
        jidx.x_np, jidx.codes, jidx.active, jidx.ids_np, jidx._next_id,
        device="cpu", cls=LSMMultiTableIndex)
    for idx in (jidx, tidx):
        ids = idx.insert(ins)
        idx.delete(np.concatenate([[5, 77], ids[:6]]))

    jmgr, tmgr = JRefresh(jidx), RefreshManager(tidx)
    for idx, mgr in ((jidx, jmgr), (tidx, tmgr)):
        orig = mgr._learning_pool

        def pool(x_snap, idx=idx, orig=orig):
            new = idx.insert(mid)            # lands while the learn runs
            idx.delete(np.concatenate([new[:3], [11]]))
            return orig(x_snap)

        mgr._learning_pool = pool
    tmgr._learn_families = lambda cfg, pool: interop.families_from_numpy(
        [{"kind": "lbh", "u": np.asarray(f.u), "v": np.asarray(f.v)}
         for f in jidx.families], device="cpu")
    assert jmgr.refresh(wait=True)
    assert tmgr.refresh(wait=True)
    assert jidx.generation == tidx.generation == 1
    assert jmgr.last_catchup_rows == tmgr.last_catchup_rows == 14
    for fj, ft in zip(jidx.families, tidx.families):
        assert type(ft) is F.LBHHash
        assert np.array_equal(np.asarray(fj.u), ft.u.numpy())
    assert np.array_equal(tidx.ids_np, jidx.ids_np)
    assert np.array_equal(tidx.active, jidx.active)
    assert tidx._next_id == jidx._next_id
    assert tidx.segments()["delta_rows"] == 14   # the catch-up's rows
    got, want = np.stack(tidx.codes), np.stack(jidx.codes)
    ratios = sign_flip_ratios(torch.from_numpy(np.asarray(tidx.x_np)),
                              [(f.u, f.v) for f in tidx.families],
                              from_numpy_u32(got), from_numpy_u32(want))
    assert (ratios <= 1.0).all()
    assert np.array_equal(got, want), "a near-zero bit flipped: see header"
    td, ti = tidx.scan_table_topk(ws, l=12)
    jd, ji = jidx.scan_table_topk(ws, l=12)
    assert np.array_equal(td, jd) and np.array_equal(ti, ji)
    tres = tidx.query_scan_batch(ws, l=12, topk=3)
    jres = jidx.query_scan_batch(ws, l=12, topk=3)
    for a, b in zip(tres.candidates, jres.candidates):
        assert np.array_equal(a, b)
    x_by_id = np.zeros((jidx._next_id, D), np.float32)
    x_by_id[jidx.ids_np] = jidx.x_np
    m_t, m_j = tres.margins_topk, jres.margins_topk
    fin = np.isfinite(m_j)
    assert np.array_equal(np.isinf(m_t), np.isinf(m_j))
    tol = _margin_tol(x_by_id, ws, jres.ids_topk, m_j)
    assert np.all(np.abs(m_t - m_j)[fin] <= tol[fin])
    differ = tres.ids_topk != jres.ids_topk
    if differ.any():
        alt = _margin_tol(x_by_id, ws, tres.ids_topk, m_t)
        assert np.all(np.abs(m_t - m_j)[differ] <= tol[differ] + alt[differ])
