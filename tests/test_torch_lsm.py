"""The port's LSM delta index on the CPU: held to the port's monolithic
MultiTableIndex replaying the same mutation stream, to a fresh monolithic
index over the surviving rows, and to the JAX package's LSM index running
the same insert/delete/compaction script (state carried across through
``repro_torch.interop``), modelled on tests/test_lsm.py.

Tolerances, stated per check:
- port LSM vs port monolithic (same families, same torch arithmetic):
  everything identical: per-table Hamming lists, ids, candidate lists and
  margins bit for bit, tie order and l > n sentinels included;
- port vs JAX: each package hashes its inserts itself, and a code bit may
  differ only where its projection lies within the float32 rounding bound
  of zero (``kernels.ref.sign_flip_ratios`` <= 1); this script's rows have
  no such bit, which the test asserts, so the per-table Hamming lists
  (distances and stable ids) must be identical.  Answers must be identical
  except where two candidates' margins tie within the float32 rounding
  bound of the d-term dot product (torch and XLA sum over d in another
  order): there either pick is right, and the two margins must agree
  within rtol 1e-5 plus that bound.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.indexer import IndexConfig as JConfig  # noqa: E402
from repro.data.synthetic import tiny1m_like  # noqa: E402
from repro.serving import LSMMultiTableIndex as JLSM  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.indexer import IndexConfig  # noqa: E402
from repro_torch.kernels.ref import sign_flip_ratios  # noqa: E402
from repro_torch.serving.lsm import LSMMultiTableIndex  # noqa: E402
from repro_torch.serving.multi_table import MultiTableIndex  # noqa: E402
from repro_torch.serving.service import HashQueryService  # noqa: E402
from repro_torch.utils.bits import from_numpy_u32  # noqa: E402
from repro_torch.utils.mesh import make_mesh  # noqa: E402

D = 24
# small thresholds so short streams cross real compaction cycles
LSM_KW = dict(method="bh", bits=14, tables=2, seed=3, lsm_delta_min=64,
              lsm_delta_threshold=0.25, lsm_step_rows=128)


@pytest.fixture(scope="module")
def corpus():
    return tiny1m_like(n_labeled=400, n_unlabeled=0, d=D, classes=5, seed=0)


@pytest.fixture(scope="module")
def queries(corpus):
    rng = np.random.default_rng(1)
    return rng.normal(size=(16, corpus.x.shape[1])).astype(np.float32)


def _cfg(**kw):
    return IndexConfig(**{**LSM_KW, **kw})


def _pair(x, **kw):
    """(LSM index, monolithic reference) over the same rows and families."""
    return (LSMMultiTableIndex(_cfg(**kw), device="cpu").fit(x),
            MultiTableIndex(_cfg(**kw), device="cpu").fit(x))


def _assert_scan_equal(a, b):
    assert np.array_equal(a.ids, b.ids)
    assert np.array_equal(a.margins, b.margins)
    assert np.array_equal(a.nonempty, b.nonempty)
    assert np.array_equal(a.table_hits, b.table_hits)
    for ca, cb in zip(a.candidates, b.candidates):
        assert np.array_equal(ca, cb)
    assert (a.ids_topk is None) == (b.ids_topk is None)
    if a.ids_topk is not None:
        assert np.array_equal(a.ids_topk, b.ids_topk)
        assert np.array_equal(a.margins_topk, b.margins_topk)


def _assert_probe_equal(a, b):
    assert np.array_equal(a.ids, b.ids)
    assert np.array_equal(a.margins, b.margins)
    for ca, cb in zip(a.candidates, b.candidates):
        assert np.array_equal(ca, cb)


def _assert_lists_equal(a, b, ws, l):
    da, ia = a.scan_table_topk(ws, l=l)
    db, ib = b.scan_table_topk(ws, l=l)
    assert np.array_equal(da, db) and np.array_equal(ia, ib)


@pytest.mark.parametrize("select", ["hist", "argmin"])
def test_insert_delete_stream_parity(corpus, queries, select):
    """Interleaved inserts/deletes crossing >= 2 auto-compactions stay
    identical to the monolithic index on both backends and both selects,
    with queries between every mutation burst."""
    rng = np.random.default_rng(7)
    lsm, mono = _pair(corpus.x, fused_select=select)
    for step in range(8):
        xa = rng.normal(size=(40, corpus.x.shape[1])).astype(np.float32)
        ia, ib = lsm.insert(xa), mono.insert(xa)
        assert np.array_equal(ia, ib)
        if step % 2 == 1:
            lsm.delete(ia[:1 + step])
            mono.delete(ia[:1 + step])
        _assert_scan_equal(lsm.query_scan_batch(queries, l=9, topk=3),
                           mono.query_scan_batch(queries, l=9, topk=3))
        _assert_probe_equal(lsm.query_batch(queries, l=2),
                            mono.query_batch(queries, l=2))
        _assert_lists_equal(lsm, mono, queries, 9)
    assert lsm.compactions >= 2, "stream too small to exercise compaction"


def test_fused_delta_route_past_the_knob(corpus, queries):
    """A delta past lsm_delta_fused_rows scans through the kernel wrapper
    (here its plain version) instead of core.search: the same answers."""
    rng = np.random.default_rng(3)
    lsm, mono = _pair(corpus.x, lsm_delta_min=10_000,
                      lsm_delta_fused_rows=32)
    xa = rng.normal(size=(100, corpus.x.shape[1])).astype(np.float32)
    lsm.insert(xa)
    mono.insert(xa)
    lsm.delete(np.arange(395, 420))
    mono.delete(np.arange(395, 420))
    assert lsm.stats()["delta_rows"] == 100
    _assert_scan_equal(lsm.query_scan_batch(queries, l=9, topk=2),
                       mono.query_scan_batch(queries, l=9, topk=2))
    _assert_lists_equal(lsm, mono, queries, 9)


def test_base_stays_resident_under_inserts(corpus, queries):
    """Under an insert stream the monolithic index rebuilds its scan state
    per mutation, while the LSM base stays on the device: only the small
    delta re-uploads."""
    rng = np.random.default_rng(8)
    lsm, mono = _pair(corpus.x, lsm_delta_min=10_000)
    lsm.query_scan_batch(queries, l=8)
    mono.query_scan_batch(queries, l=8)
    base_rebuilds = lsm.scan_state_rebuilds
    for _ in range(4):
        xa = rng.normal(size=(16, corpus.x.shape[1])).astype(np.float32)
        lsm.insert(xa)
        mono.insert(xa)
        _assert_scan_equal(lsm.query_scan_batch(queries, l=8),
                           mono.query_scan_batch(queries, l=8))
    st = lsm.stats()
    assert st["backend"] == "lsm" and st["delta_rows"] == 64
    assert lsm.scan_state_rebuilds == base_rebuilds
    assert mono.scan_state_rebuilds >= 4
    assert lsm.delta_uploads >= 4
    assert lsm.device_uploads < mono.device_uploads


def test_tombstones_filtered_from_scan(corpus, queries):
    """Deleting the scan-topping rows surfaces the runners-up, as in the
    monolithic index."""
    lsm, mono = _pair(corpus.x)
    first = lsm.query_scan_batch(queries, l=6)
    victims = np.unique(first.ids[first.ids >= 0])[:8]
    lsm.delete(victims)
    mono.delete(victims)
    after = lsm.query_scan_batch(queries, l=6)
    _assert_scan_equal(after, mono.query_scan_batch(queries, l=6))
    assert not np.isin(victims, after.ids).any()
    for c in after.candidates:
        assert not np.isin(victims, c).any()


def test_incremental_compaction_bounded_steps(corpus, queries):
    """Manual begin/step: every copy step touches at most max_rows source
    rows, a query MID-compaction answers identically, and the id-keyed
    probe tables survive the swap untouched."""
    lsm, mono = _pair(corpus.x, lsm_auto=False)
    rng = np.random.default_rng(9)
    xa = rng.normal(size=(220, corpus.x.shape[1])).astype(np.float32)
    lsm.insert(xa)
    mono.insert(xa)
    dead = np.arange(10, 60, dtype=np.int64)
    lsm.delete(dead)
    mono.delete(dead)
    tables_before = list(lsm.tables)
    ref = mono.query_scan_batch(queries, l=9, topk=2)
    pref = mono.query_batch(queries)

    assert lsm.begin_compaction()
    assert not lsm.begin_compaction()        # one in flight at a time
    steps, mid_checked = 0, False
    while lsm.stats()["compaction_active"]:
        assert lsm.compaction_step(max_rows=100) <= 100
        steps += 1
        if not mid_checked:
            _assert_scan_equal(lsm.query_scan_batch(queries, l=9, topk=2),
                               ref)
            _assert_probe_equal(lsm.query_batch(queries), pref)
            _assert_lists_equal(lsm, mono, queries, 9)
            mid_checked = True
        assert steps < 100, "compaction failed to converge"
    assert steps > 2, "steps not bounded: compaction ran monolithically"
    st = lsm.stats()
    assert lsm.compactions == 1 and st["frozen_rows"] == 0
    _assert_scan_equal(lsm.query_scan_batch(queries, l=9, topk=2), ref)
    _assert_probe_equal(lsm.query_batch(queries), pref)
    assert st["base_rows"] == lsm.n == 400 + 220 - 50
    assert all(a is b for a, b in zip(tables_before, lsm.tables))
    with pytest.raises(KeyError, match="compacted away"):
        lsm.ids_to_rows(dead[:1])
    assert np.array_equal(lsm.compact(), mono.ids_np[mono.active])


def test_soak_identical_to_fresh_build(corpus, queries):
    """A seeded insert/delete/query soak crossing >= 2 compactions ends
    identical to a FRESH monolithic index over the surviving rows: Hamming
    lists (ids mapped through the survivors' stable ids), answers and
    margins."""
    rng = np.random.default_rng(11)
    lsm, mono = _pair(corpus.x, lsm_step_rows=96)
    live_x = list(corpus.x)
    live_ids = list(range(corpus.x.shape[0]))
    for step in range(10):
        xa = rng.normal(size=(48, corpus.x.shape[1])).astype(np.float32)
        ids = lsm.insert(xa)
        mono.insert(xa)
        live_x.extend(xa)
        live_ids.extend(ids)
        if step % 3 == 2:
            kill = set(rng.choice(len(live_ids), size=12, replace=False))
            dead = np.sort([live_ids[i] for i in kill]).astype(np.int64)
            lsm.delete(dead)
            mono.delete(dead)
            live_x = [v for i, v in enumerate(live_x) if i not in kill]
            live_ids = [v for i, v in enumerate(live_ids) if i not in kill]
        lsm.query_scan_batch(queries[:4], l=8)
    assert lsm.compactions >= 2
    _assert_scan_equal(lsm.query_scan_batch(queries, l=9, topk=3),
                       mono.query_scan_batch(queries, l=9, topk=3))
    _assert_probe_equal(lsm.query_batch(queries, l=2),
                        mono.query_batch(queries, l=2))
    fresh = MultiTableIndex(_cfg(), device="cpu").fit(np.stack(live_x),
                                                     families=lsm.families)
    live_ids = np.asarray(live_ids)
    dl, il = lsm.scan_table_topk(queries, l=9)
    df, i_f = fresh.scan_table_topk(queries, l=9)
    assert np.array_equal(dl, df)
    assert np.array_equal(il, np.where(i_f >= 0, live_ids[i_f], -1))
    rl = lsm.query_scan_batch(queries, l=9)
    rf = fresh.query_scan_batch(queries, l=9)
    assert np.array_equal(rl.margins, rf.margins)
    assert np.array_equal(live_ids[rf.ids], rl.ids)


def test_l_exceeds_rows_and_mask_edges(corpus, queries):
    """l > n sentinels, topk past the candidate count, and stable-id masks
    across the segment split."""
    lsm, mono = _pair(corpus.x, lsm_delta_min=10_000)
    rng = np.random.default_rng(13)
    xa = rng.normal(size=(30, corpus.x.shape[1])).astype(np.float32)
    lsm.insert(xa)
    mono.insert(xa)
    _assert_scan_equal(lsm.query_scan_batch(queries, l=4096, topk=2),
                       mono.query_scan_batch(queries, l=4096, topk=2))
    _assert_lists_equal(lsm, mono, queries, 1000)
    mask = np.zeros(lsm._next_id, dtype=bool)
    mask[::5] = True
    _assert_scan_equal(lsm.query_scan_batch(queries, l=9, mask=mask),
                       mono.query_scan_batch(queries, l=9, mask=mask))
    _assert_probe_equal(lsm.query_batch(queries, mask=mask),
                        mono.query_batch(queries, mask=mask))
    ids = np.random.default_rng(14).integers(-1, lsm._next_id, (16, 20))
    assert np.array_equal(lsm.candidate_margins(queries, ids),
                          mono.candidate_margins(queries, ids))


def test_empty_index_and_unported_paths(corpus, queries):
    lsm = LSMMultiTableIndex(_cfg(lsm_auto=False), device="cpu")
    with pytest.raises(RuntimeError, match="before fit"):
        lsm.insert(corpus.x[:2])
    lsm.fit(corpus.x[:50])
    lsm.delete(np.arange(50))
    res = lsm.query_scan_batch(queries[:3], topk=4)
    assert (res.ids == -1).all() and res.ids_topk.shape == (3, 4)
    d, i = lsm.scan_table_topk(queries[:3], l=5)
    assert (i == -1).all() and d.shape == (2, 3, 5)
    assert np.array_equal(lsm.compact(), np.empty(0, np.int64))
    lsm.insert(corpus.x[50:60])          # base empty, delta only
    mono = MultiTableIndex(_cfg(), device="cpu").fit(corpus.x[50:60],
                                                     families=lsm.families)
    dl, il = lsm.scan_table_topk(queries, l=4)
    df, i_f = mono.scan_table_topk(queries, l=4)
    assert np.array_equal(dl, df) and np.array_equal(il, i_f + 50)
    # a co-located CPU mesh answers like no mesh; a non-mesh raises
    mesh = make_mesh((3,), ("data",), devices=["cpu"] * 3)
    lsm.delete(lsm.ids_np[[1, 4]])       # a tombstone in the delta
    lsm.compact()                        # the delta folds into the base
    lsm.insert(corpus.x[60:70])
    lsm.delete(lsm.ids_np[[0, 2]])       # base tombstones: the overscan
    _assert_scan_equal(lsm.query_scan_batch(queries, l=4, topk=3, mesh=mesh),
                       lsm.query_scan_batch(queries, l=4, topk=3))
    dm, im = lsm.scan_table_topk(queries, l=4, mesh=mesh)
    dn, i_n = lsm.scan_table_topk(queries, l=4)
    assert np.array_equal(dm, dn) and np.array_equal(im, i_n)
    with pytest.raises(TypeError, match="mesh"):
        lsm.query_scan_batch(queries[:3], mesh=object())
    n_live = lsm.n
    assert HashQueryService(lsm).refresh()   # the refresh is ported
    assert lsm.generation == 1 and lsm.n == n_live


def test_background_compactor_under_live_queries(corpus, queries):
    """A daemon compactor folding the delta while queries flow: answers
    stay identical to a monolithic replay, and a cycle completes."""
    lsm, mono = _pair(corpus.x, lsm_auto=False, lsm_step_rows=64)
    rng = np.random.default_rng(23)
    lsm.start_compactor(interval_s=1e-4)
    try:
        for step in range(200):
            xa = rng.normal(size=(32, corpus.x.shape[1])).astype(np.float32)
            ia = lsm.insert(xa)
            mono.insert(xa)
            if step % 2:
                lsm.delete(ia[:3])
                mono.delete(ia[:3])
            _assert_scan_equal(lsm.query_scan_batch(queries[:8], l=8),
                               mono.query_scan_batch(queries[:8], l=8))
            if lsm.compactions >= 1 and not lsm.stats()["compaction_active"]:
                break
        assert lsm.compactions >= 1, "compactor never completed a cycle"
    finally:
        lsm.stop_compactor()
    _assert_probe_equal(lsm.query_batch(queries), mono.query_batch(queries))


def test_service_forwards_writes_under_the_index_lock(corpus, queries):
    lsm, mono = _pair(corpus.x)
    svc = HashQueryService(lsm, mode="probe")
    ref = HashQueryService(mono, mode="probe")
    svc.query_batch(queries)
    ref.query_batch(queries)
    xa = np.random.default_rng(17).normal(
        size=(70, corpus.x.shape[1])).astype(np.float32)
    ids = svc.insert(xa)
    assert np.array_equal(ids, mono.insert(xa))
    svc.delete(ids[:5])
    mono.delete(ids[:5])
    a, b = svc.query_batch(queries), ref.query_batch(queries)
    assert [r.index for r in a] == [r.index for r in b]
    assert [r.margin for r in a] == [r.margin for r in b]
    st = svc.stats()
    assert (st["inserts"], st["inserted_rows"]) == (1, 70)
    assert (st["deletes"], st["deleted_rows"]) == (1, 5)
    assert st["index_delta_uploads"] == lsm.delta_uploads > 0
    assert ref.stats()["index_delta_uploads"] == 0
    assert st["index_compaction_steps"] == lsm.compaction_steps


# -- against the JAX package's LSM index -------------------------------------

def _specs(jidx):
    return [{"kind": "seeded_bh", "seed": f.seed, "u": np.asarray(f.u),
             "v": np.asarray(f.v)} for f in jidx.families]


def _margin_tol(x_by_id, ws, ids, want):
    """rtol 1e-5 plus the float32 rounding bound of |w . x| / ||w||."""
    terms = np.abs(x_by_id[np.clip(ids, 0, None)] * ws[:, None, :]).sum(-1)
    bound = (ws.shape[1] + 8) * 2.0 ** -23 * terms / np.linalg.norm(
        ws, axis=1, keepdims=True)
    return 1e-5 * np.abs(np.where(np.isfinite(want), want, 0)) + bound


def _assert_like_jax(tidx, jidx, ws, l=9, topk=3):
    assert np.array_equal(tidx.ids_np, jidx.ids_np)
    assert np.array_equal(tidx.active, jidx.active)
    assert tidx._next_id == jidx._next_id
    got, want = np.stack(tidx.codes), np.stack(jidx.codes)
    ratios = sign_flip_ratios(torch.from_numpy(np.asarray(tidx.x_np)),
                              [(f.u, f.v) for f in tidx.families],
                              from_numpy_u32(got), from_numpy_u32(want))
    assert (ratios <= 1.0).all()
    assert np.array_equal(got, want), "a near-zero bit flipped: see header"
    td, ti = tidx.scan_table_topk(ws, l=l)
    jd, ji = jidx.scan_table_topk(ws, l=l)
    assert np.array_equal(td, jd) and np.array_equal(ti, ji)
    tres = tidx.query_scan_batch(ws, l=l, topk=topk)
    jres = jidx.query_scan_batch(ws, l=l, topk=topk)
    for a, b in zip(tres.candidates, jres.candidates):
        assert np.array_equal(a, b)
    x_by_id = np.zeros((jidx._next_id, ws.shape[1]), np.float32)
    x_by_id[jidx.ids_np] = jidx.x_np
    m_t, m_j = tres.margins_topk, jres.margins_topk
    assert np.array_equal(np.isinf(m_t), np.isinf(m_j))
    fin = np.isfinite(m_j)
    tol = _margin_tol(x_by_id, ws, jres.ids_topk, m_j)
    assert np.all(np.abs(m_t - m_j)[fin] <= tol[fin])
    # ids may differ only where the two margins tie within the bound
    differ = tres.ids_topk != jres.ids_topk
    if differ.any():
        alt = _margin_tol(x_by_id, ws, tres.ids_topk, m_t)
        assert np.all(np.abs(m_t - m_j)[differ] <= tol[differ] + alt[differ])


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["jax-plain", "jax-pallas"])
def test_script_matches_jax_lsm(corpus, queries, use_kernels):
    """The same insert/delete/compaction script on both packages, from one
    JAX-built state: identical Hamming lists throughout, including a query
    mid-compaction and l > n_live."""
    kw = dict(LSM_KW, lsm_auto=False)
    jidx = JLSM(JConfig(**kw, use_kernels=use_kernels)).fit(corpus.x)
    tidx = interop.index_from_numpy(
        IndexConfig(**kw), _specs(jidx), jidx.x_np, jidx.codes, jidx.active,
        jidx.ids_np, jidx._next_id, device="cpu", cls=LSMMultiTableIndex)
    assert isinstance(tidx, LSMMultiTableIndex)
    _assert_like_jax(tidx, jidx, queries)
    rng = np.random.default_rng(29)
    for step in range(3):
        xa = rng.normal(size=(60, corpus.x.shape[1])).astype(np.float32)
        assert np.array_equal(tidx.insert(xa), jidx.insert(xa))
        dead = np.sort(rng.choice(jidx._next_id, 15, replace=False))
        dead = dead[jidx.active[jidx.ids_to_rows(dead)]]
        tidx.delete(dead)
        jidx.delete(dead)
        _assert_like_jax(tidx, jidx, queries)
    assert tidx.begin_compaction() and jidx.begin_compaction()
    for _ in range(2):
        assert tidx.compaction_step(max_rows=100) == \
            jidx.compaction_step(max_rows=100)
    _assert_like_jax(tidx, jidx, queries)                  # mid-compaction
    xa = rng.normal(size=(20, corpus.x.shape[1])).astype(np.float32)
    assert np.array_equal(tidx.insert(xa), jidx.insert(xa))
    assert np.array_equal(tidx.compact(), jidx.compact())
    assert tidx.compactions == jidx.compactions == 1
    assert tidx.stats()["base_rows"] == jidx.stats()["base_rows"]
    _assert_like_jax(tidx, jidx, queries)
    _assert_like_jax(tidx, jidx, queries, l=2048, topk=4)  # l > n_live
