"""The port's MultiTableIndex and HashQueryService against the JAX
package's, on the CPU: a JAX index (seeded BH, bits 20, L 4, n = 3000) is
carried across as numpy arrays (``repro_torch.interop``) and both answer
the same hyperplane queries in scan and probe modes, with a row mask, with
topk 1 and 5, and after insert, delete and compact.

Tolerances, stated per check:
- query codes are hashed by each package on its own; a bit may differ only
  where a projection lies within the float32 rounding bound of zero
  (``kernels.ref.sign_flip_ratios`` <= 1).  Answers are compared for the
  queries whose codes are identical in all tables: ids and candidate lists
  identical, margins within rtol 1e-5 plus the float32 rounding bound of
  the d-term dot product (torch and XLA sum over d in another order);
- index state (codes of inserted rows aside, which obey the bit rule
  above) and every id are identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.indexer import IndexConfig as JConfig  # noqa: E402
from repro.data.synthetic import tiny1m_like  # noqa: E402
from repro.serving import HashQueryService as JService  # noqa: E402
from repro.serving import MultiTableIndex as JIndex  # noqa: E402
from repro.serving import batch_query as jbq  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.indexer import IndexConfig as TConfig  # noqa: E402
from repro_torch.kernels.ref import sign_flip_ratios  # noqa: E402
from repro_torch.serving import batch_query as tbq  # noqa: E402
from repro_torch.serving.service import HashQueryService as TService  # noqa: E402,E501
from repro_torch.utils.bits import from_numpy_u32, to_numpy_u32  # noqa: E402

SCAN_L = 64
CFG = dict(method="bh", bits=20, tables=4, batch=16, radius=3)


@pytest.fixture(scope="module")
def corpus():
    return tiny1m_like(n_labeled=500, n_unlabeled=2500, d=64, classes=5,
                       seed=0)


@pytest.fixture(scope="module")
def queries(corpus):
    rng = np.random.default_rng(1)
    return rng.normal(size=(40, corpus.x.shape[1])).astype(np.float32)


def _specs(jidx):
    return [{"kind": "seeded_bh", "seed": f.seed, "u": np.asarray(f.u),
             "v": np.asarray(f.v)} for f in jidx.families]


def _carry(jidx):
    return interop.index_from_numpy(
        TConfig(**CFG), _specs(jidx), jidx.x_np, jidx.codes, jidx.active,
        jidx.ids_np, jidx._next_id, device="cpu")


def _assert_codes_close(x, families, got, want):
    """(L, n, W) uint32 codes of x: equal but for near-zero bits."""
    ratios = sign_flip_ratios(torch.from_numpy(np.asarray(x, np.float32)),
                              [(f.u, f.v) for f in families],
                              from_numpy_u32(got), from_numpy_u32(want))
    assert (ratios <= 1.0).all(), ratios.max()


def _same_queries(tidx, jidx, ws):
    """Queries whose codes the two packages agree on in every table."""
    tq = to_numpy_u32(tbq.hash_queries_all(tidx.families, ws))
    jq = np.asarray(jbq.hash_queries_all(jidx.families, jnp.asarray(ws)))
    _assert_codes_close(ws, tidx.families, tq, jq)
    same = (tq == jq).all(axis=(0, 2))
    assert same.mean() >= 0.9
    return same


def _assert_state_equal(tidx, jidx):
    assert np.array_equal(tidx.ids_np, jidx.ids_np)
    assert np.array_equal(tidx.active, jidx.active)
    assert np.array_equal(tidx._row_of, jidx._row_of)
    assert tidx._next_id == jidx._next_id and tidx.n == jidx.n
    assert np.array_equal(tidx.x_np, jidx.x_np)


def _synced(tidx, jidx):
    """tidx itself when its codes equal the JAX index's; otherwise (a bit
    flipped at the sign boundary) the JAX state carried across afresh."""
    _assert_state_equal(tidx, jidx)
    got, want = np.stack(tidx.codes), np.stack(jidx.codes)
    _assert_codes_close(tidx.x_np, tidx.families, got, want)
    return tidx if np.array_equal(got, want) else _carry(jidx)


def _margin_tol(x, ws, ids, want):
    """rtol 1e-5 plus the float32 rounding bound of |w . x| / ||w||."""
    rows = np.clip(ids, 0, None)
    terms = np.abs(x[rows] * ws[:, None, :]).sum(-1)
    bound = (x.shape[1] + 8) * 2.0 ** -23 * terms / np.linalg.norm(
        ws, axis=1, keepdims=True)
    return 1e-5 * np.abs(np.where(np.isfinite(want), want, 0)) + bound


def _assert_results_equal(tres, jres, same, x_by_id, ws):
    ids_t = np.atleast_2d(tres.ids if tres.ids_topk is None
                          else tres.ids_topk.T).T
    ids_j = np.atleast_2d(jres.ids if jres.ids_topk is None
                          else jres.ids_topk.T).T
    m_t = np.atleast_2d(tres.margins if tres.margins_topk is None
                        else tres.margins_topk.T).T
    m_j = np.atleast_2d(jres.margins if jres.margins_topk is None
                        else jres.margins_topk.T).T
    assert ids_t.shape == ids_j.shape
    assert np.array_equal(ids_t[same], ids_j[same])
    assert np.array_equal(np.isinf(m_t[same]), np.isinf(m_j[same]))
    fin = np.isfinite(m_j) & same[:, None]
    tol = _margin_tol(x_by_id, ws, ids_j, m_j)
    assert np.all(np.abs(m_t - m_j)[fin] <= tol[fin])
    assert np.array_equal(tres.nonempty[same], jres.nonempty[same])
    for i in np.flatnonzero(same):
        assert np.array_equal(np.sort(tres.candidates[i]),
                              np.sort(jres.candidates[i]))


def _x_by_id(jidx):
    """Features indexed by stable id (rows compacted away stay zero)."""
    out = np.zeros((jidx._next_id, jidx.x_np.shape[1]), np.float32)
    out[jidx.ids_np] = jidx.x_np
    return out


def _compare_paths(tidx, jidx, ws, mask=None):
    same = _same_queries(tidx, jidx, ws)
    xb = _x_by_id(jidx)
    for topk in (1, 5):
        _assert_results_equal(
            tidx.query_scan_batch(ws, l=SCAN_L, topk=topk, mask=mask),
            jidx.query_scan_batch(ws, l=SCAN_L, topk=topk, mask=mask),
            same, xb, ws)
        _assert_results_equal(tidx.query_batch(ws, mask=mask, l=topk),
                              jidx.query_batch(ws, mask=mask, l=topk),
                              same, xb, ws)
    td, ti = tidx.scan_table_topk(ws, l=SCAN_L)
    jd, ji = jidx.scan_table_topk(ws, l=SCAN_L)
    assert np.array_equal(td[:, same], jd[:, same])
    assert np.array_equal(ti[:, same], ji[:, same])


@pytest.fixture(scope="module")
def pair(corpus):
    jidx = JIndex(JConfig(**CFG)).fit(corpus.x)
    return _carry(jidx), jidx


def test_carried_index_answers_like_jax(pair, queries):
    tidx, jidx = pair
    _assert_state_equal(tidx, jidx)
    _compare_paths(tidx, jidx, queries)
    # the single-query path (B = 1)
    i = int(np.flatnonzero(_same_queries(tidx, jidx, queries))[0])
    one_t, one_j = tidx.query(queries[i]), jidx.query(queries[i])
    assert one_t.index == one_j.index and one_t.nonempty == one_j.nonempty
    assert np.array_equal(np.sort(one_t.candidates),
                          np.sort(one_j.candidates))


def test_masked_answers_like_jax(pair, queries):
    tidx, jidx = pair
    mask = np.random.default_rng(2).random(jidx._next_id) < 0.3
    _compare_paths(tidx, jidx, queries, mask=mask)


def test_candidate_margins_like_jax(pair, queries):
    tidx, jidx = pair
    ids = np.random.default_rng(3).integers(-1, jidx._next_id, (40, 30))
    got, want = (tidx.candidate_margins(queries, ids),
                 jidx.candidate_margins(queries, ids))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    tol = _margin_tol(_x_by_id(jidx), queries, ids, want)
    assert np.all(np.abs(got - want)[fin] <= tol[fin])


def test_mutations_track_jax(corpus, queries):
    x = corpus.x
    cfg = dict(CFG, compact_threshold=None)
    jidx = JIndex(JConfig(**cfg)).fit(x[:2500])
    tidx = interop.index_from_numpy(
        TConfig(**cfg), _specs(jidx), jidx.x_np, jidx.codes, jidx.active,
        jidx.ids_np, jidx._next_id, device="cpu")
    # insert: each package hashes the new rows itself
    new_t, new_j = tidx.insert(x[2500:]), jidx.insert(x[2500:])
    assert np.array_equal(new_t, new_j)
    tcur = _synced(tidx, jidx)
    _compare_paths(tcur, jidx, queries)
    # delete (tombstones), then compact (rows renumbered, ids stable)
    gone = np.random.default_rng(4).choice(3000, 900, replace=False)
    tidx.delete(gone)
    jidx.delete(gone)
    if tcur is not tidx:
        tcur.delete(gone)
    assert tidx.version == jidx.version
    _compare_paths(_synced(tidx, jidx), jidx, queries)
    mask = np.random.default_rng(5).random(jidx._next_id) < 0.5
    _compare_paths(_synced(tidx, jidx), jidx, queries, mask=mask)
    assert np.array_equal(tidx.compact(), jidx.compact())
    assert tidx.stats()["compactions"] == jidx.stats()["compactions"] == 1
    _compare_paths(_synced(tidx, jidx), jidx, queries)
    with pytest.raises(KeyError):
        tidx.ids_to_rows(gone[:3])


def test_auto_compaction_threshold_like_jax(corpus):
    cfg = dict(CFG, compact_threshold=0.2)
    jidx = JIndex(JConfig(**cfg)).fit(corpus.x[:1000])
    tidx = _carry(jidx)
    tidx.config.compact_threshold = 0.2
    for chunk in np.array_split(np.arange(300), 3):
        tidx.delete(chunk)
        jidx.delete(chunk)
        assert tidx.compactions == jidx.compactions
    assert tidx.compactions == 1
    _assert_state_equal(tidx, jidx)
    tidx.delete([])
    assert tidx.version == jidx.version


@pytest.mark.parametrize("mode", ["scan", "probe"])
def test_service_answers_like_jax(pair, queries, mode):
    tidx, jidx = pair
    same = _same_queries(tidx, jidx, queries)
    tsvc = TService(tidx, mode=mode, scan_l=SCAN_L)
    jsvc = JService(jidx, mode=mode, scan_l=SCAN_L)
    for _ in range(2):                  # the second pass hits the cache
        tres, jres = tsvc.query_batch(queries), jsvc.query_batch(queries)
        assert [r.index for r, s in zip(tres, same) if s] == \
            [r.index for r, s in zip(jres, same) if s]
        for r_t, r_j, s in zip(tres, jres, same):
            if s:
                assert np.array_equal(np.sort(r_t.candidates),
                                      np.sort(r_j.candidates))
                assert r_t.nonempty == r_j.nonempty
    st_t, st_j = tsvc.stats(), jsvc.stats()
    for key in ("requests", "batches", "cache_hits", "cache_entries"):
        assert st_t[key] == st_j[key], key
    assert st_t["batches"] == 2 * 3
    assert st_t["p95_batch_latency_ms"] > 0 and st_t["qps"] > 0
    # micro-batching: submit/flush answers in submit order
    t1, t2 = tsvc.submit(queries[0]), tsvc.submit(queries[1])
    assert (t1, t2) == (0, 1) and tsvc.pending == 2
    flushed = tsvc.flush()
    assert [r.index for r in flushed] == [tres[0].index, tres[1].index]
    assert tsvc.pending == 0 and tsvc.stats()["requests"] == 82


def test_service_writes_and_cache_invalidation(corpus, queries):
    jidx = JIndex(JConfig(**CFG)).fit(corpus.x[:800])
    tsvc = TService(_carry(jidx), mode="probe")
    tsvc.query_batch(queries[:8])
    assert tsvc.stats()["cache_entries"] > 0
    ids = tsvc.insert(corpus.x[800:900])
    assert np.array_equal(ids, np.arange(800, 900))
    tsvc.query_batch(queries[:8])
    assert tsvc.stats()["cache_hits"] == 0     # dropped on the version bump
    tsvc.delete(ids[:10])
    st = tsvc.stats()
    assert (st["inserted_rows"], st["deleted_rows"]) == (100, 10)
    assert st["index_version"] == tsvc.index.version == 3


def test_empty_index_and_pre_fit_errors(corpus, queries):
    cfg = TConfig(**CFG)
    from repro_torch.serving.multi_table import MultiTableIndex
    idx = MultiTableIndex(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        idx.query_scan_batch(queries)
    idx.fit(corpus.x[:50])
    idx.delete(np.arange(50))          # every row dead (auto-compacts)
    res = idx.query_scan_batch(queries[:3], topk=4)
    assert (res.ids == -1).all() and res.ids_topk.shape == (3, 4)
    with pytest.raises(NotImplementedError, match="mesh"):
        idx.query_scan_batch(queries[:3], mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        TService(idx, mode="scan", mesh=object())


@pytest.mark.parametrize("overrides", [
    dict(method="lbh"),
    dict(method="bh", seeded_projections=False),
], ids=["lbh", "bh-unseeded"])
def test_unported_families_raise_at_fit(corpus, overrides):
    """Families the JAX package draws or learns are carried in, never
    invented by the port: building them from the config raises."""
    from repro_torch.serving.multi_table import MultiTableIndex
    idx = MultiTableIndex(TConfig(**{**CFG, **overrides}), device="cpu")
    with pytest.raises(NotImplementedError, match="interop"):
        idx.fit(corpus.x[:50])
