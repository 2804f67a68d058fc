"""The scan path's read-back (``MultiTableIndex.answer_from_scan``, and
``multi_table.answer_slots`` under it, which the LSM index answers
through too): its result equals, field by field, one built the way the
JAX package builds it (the union's rows read back and each query's list
translated to stable ids on the host), over one and four tables, scan
depths past the live rows, masks, topk past L·l, mutations and the
row-sharded scan; the LSM index's equals its own old answer path's in
each of its segment states; a batch's arrays stay as they were after
later batches; one blocking read a micro-batch.  ``kernels.candidates``' plain version is held to its
definition here and to the CUDA kernel on a card (tests marked ``cuda``
skip without one; ``pytest -m cuda tests/test_torch_readback.py``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.indexer import IndexConfig  # noqa: E402
from repro_torch.core.search import margin_rerank_batch  # noqa: E402
from repro_torch.kernels import candidates as cl  # noqa: E402
from repro_torch.serving import batch_query as bq  # noqa: E402
from repro_torch.serving.lsm import LSMMultiTableIndex  # noqa: E402
from repro_torch.serving.multi_table import (BatchQueryResult,  # noqa: E402
                                             MultiTableIndex)
from repro_torch.serving.service import HashQueryService  # noqa: E402
from repro_torch.utils import trace  # noqa: E402
from repro_torch.utils.mesh import make_mesh  # noqa: E402

D = 17


def _index(n, tables, device="cpu", seed=5):
    x = np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)
    return MultiTableIndex(IndexConfig(method="bh", bits=12, tables=tables,
                                       seed=seed, compact_threshold=None),
                           device=device).fit(x)


def _queries(b, seed=9):
    return np.random.default_rng(seed).normal(size=(b, D)).astype(np.float32)


def _lsm(n, tables, device="cpu", seed=5, fused_rows=4096):
    """An LSM index whose n rows are its base; compaction only when asked."""
    x = np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)
    return LSMMultiTableIndex(
        IndexConfig(method="bh", bits=12, tables=tables, seed=seed,
                    compact_threshold=None, lsm_auto=False,
                    lsm_delta_fused_rows=fused_rows), device=device).fit(x)


def _make(kind, n, tables, device="cpu"):
    """A monolithic index over n rows, or an LSM index holding n rows as a
    base and a delta, with tombstones in both."""
    if kind == "monolithic":
        return _index(n, tables, device)
    index = _lsm(n - n // 8, tables, device)
    index.insert(_queries(n // 8, seed=7))
    index.delete(index.ids_np[::9])
    return index


def _old_answer(index, w, idx, topk=1, mask=None) -> BatchQueryResult:
    """The read-back before the lists moved to the device: every array of
    the union read back, each query's unique rows translated to stable
    ids one query at a time."""
    w = np.atleast_2d(np.asarray(w, np.float32))
    b = w.shape[0]
    n_live = index._live_rows.shape[0]
    flat = torch.sort(idx.permute(1, 0, 2).reshape(b, -1), dim=1).values
    uniq = flat >= 0
    uniq[:, 1:] &= flat[:, 1:] != flat[:, :-1]
    grows = index._live_rows_dev[torch.clamp(flat, 0, n_live - 1).long()]
    mask_rows = index.mask_to_rows(mask)
    valid = uniq if mask_rows is None else (
        uniq & torch.from_numpy(mask_rows).to(index.device)[grows])
    hits = (idx >= 0).sum(dim=(1, 2))
    margins, top = margin_rerank_batch(
        index.x, bq.as_float_tensor(w, index.device), grows, valid, topk)
    margins, top, hits, grows, uniq, valid = (
        t.cpu().numpy() for t in (margins, top, hits, grows, uniq, valid))
    top = top.astype(np.int64)
    top[~np.isfinite(margins)] = -1
    if margins.shape[1] < topk:
        padw = ((0, 0), (0, topk - margins.shape[1]))
        margins = np.pad(margins, padw, constant_values=np.inf)
        top = np.pad(top, padw, constant_values=-1)
    top = index.rows_to_ids(top)
    cands = [index.rows_to_ids(grows[i, uniq[i]]) for i in range(b)]
    return BatchQueryResult(
        top[:, 0], margins[:, 0], valid.any(axis=1), cands, 0.0, 0.0,
        hits.astype(np.int64), ids_topk=top if topk > 1 else None,
        margins_topk=margins if topk > 1 else None)


def _old_lsm_answer(index, w, i_m, topk=1, mask=None) -> BatchQueryResult:
    """The LSM index's answer path before it shared the monolithic one,
    over a merged two-segment scan result i_m (L, B, l) of global rows:
    six arrays read back, each query's list built on the host; its
    segmented re-rank stands here as the re-rank over the whole rows
    (``index.x``), which it equals."""
    w = np.atleast_2d(np.asarray(w, np.float32))
    b = w.shape[0]
    ids_view, dev = index.ids_np, index.device
    flat = torch.sort(i_m.permute(1, 0, 2).reshape(b, -1), dim=1).values
    uniq = flat >= 0
    uniq[:, 1:] &= flat[:, 1:] != flat[:, :-1]
    grows = torch.clamp(flat, 0, ids_view.shape[0] - 1).long()
    valid = uniq if mask is None else uniq & torch.from_numpy(
        np.asarray(mask, dtype=bool)[ids_view]).to(dev)[grows]
    margins, top = margin_rerank_batch(
        index.x, bq.as_float_tensor(w, dev), grows, valid, topk)
    margins = margins.cpu().numpy()
    top = top.cpu().numpy().astype(np.int64)
    top[~np.isfinite(margins)] = -1
    if margins.shape[1] < topk:
        padw = ((0, 0), (0, topk - margins.shape[1]))
        margins = np.pad(margins, padw, constant_values=np.inf)
        top = np.pad(top, padw, constant_values=-1)
    top_ids = np.where(top >= 0, ids_view[np.clip(top, 0, None)], -1)
    hits = (i_m >= 0).sum(dim=(1, 2)).cpu().numpy().astype(np.int64)
    grows_np = grows.cpu().numpy()
    uniq_np, valid_np = uniq.cpu().numpy(), valid.cpu().numpy()
    cands = [ids_view[grows_np[i, uniq_np[i]]] for i in range(b)]
    return BatchQueryResult(
        top_ids[:, 0], margins[:, 0], valid_np.any(axis=1), cands, 0.0, 0.0,
        hits, ids_topk=top_ids if topk > 1 else None,
        margins_topk=margins if topk > 1 else None)


def _assert_same(got: BatchQueryResult, want: BatchQueryResult):
    for f in dataclasses.fields(BatchQueryResult):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "candidates":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)
        elif isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), f.name
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def _check(index, w, l, topk=1, mask=None, mesh=None):
    """answer_from_scan against the old read-back on one scan result, and
    query_scan_batch against it too."""
    _, idx = index._scan(w, l, mesh)
    got = index.answer_from_scan(w, idx, topk, mask)
    want = _old_answer(index, w, idx, topk, mask)
    _assert_same(got, want)
    _assert_same(index.query_scan_batch(w, l=l, topk=topk, mask=mask,
                                        mesh=mesh), want)
    return got


def _check_lsm(index, w, l, topk=1, mask=None):
    """An LSM index's query_scan_batch against its old answer path on the
    same two-segment scan."""
    _, _, i_m = index._scan_segments(np.atleast_2d(w), l)
    got = index.query_scan_batch(w, l=l, topk=topk, mask=mask)
    _assert_same(got, _old_lsm_answer(index, w, i_m, topk, mask))
    return got


@pytest.mark.parametrize("tables", [1, 4])
@pytest.mark.parametrize("topk", [1, 3, 1000])
def test_the_read_back_equals_the_host_lists(tables, topk):
    index = _index(900, tables)
    res = _check(index, _queries(6), 48, topk)
    sizes = [c.size for c in res.candidates]
    assert all(0 < s <= tables * 48 for s in sizes)
    if tables > 1:      # rows in more than one table's top-l
        assert min(sizes) < tables * 48


@pytest.mark.parametrize("tables", [1, 4])
def test_scan_depth_past_the_live_rows(tables):
    """l > n: the scan's empty (-1) slots sort first and are dropped."""
    index = _index(40, tables)
    res = _check(index, _queries(5), 64, topk=3)
    assert all(c.size == 40 for c in res.candidates)
    _check(index, _queries(3, seed=2), 64, topk=tables * 64 + 7)


def test_a_mask_narrows_answers_not_lists():
    index = _index(500, 2)
    mask = np.random.default_rng(3).random(500) < 0.3
    res = _check(index, _queries(7), 40, topk=3, mask=mask)
    live = res.ids[res.ids >= 0]
    assert mask[live].all()
    # a mask that admits nothing: every query is empty, its list is not
    none = _check(index, _queries(4), 40, topk=2,
                  mask=np.zeros(500, dtype=bool))
    assert not none.nonempty.any() and (none.ids == -1).all()
    assert all(c.size > 0 for c in none.candidates)


def test_after_insert_delete_and_compact():
    index = _index(600, 3)
    w = _queries(6)
    _check(index, w, 32, topk=3)
    new = index.insert(np.random.default_rng(4).normal(
        size=(80, D)).astype(np.float32))
    _check(index, w, 32, topk=3)
    index.delete(np.concatenate([np.arange(0, 600, 3), new[::2]]))
    res = _check(index, w, 32, topk=3)
    alive = set(index.ids_np[index.active].tolist())
    assert all(set(c.tolist()) <= alive for c in res.candidates)
    index.compact()
    _check(index, w, 32, topk=3)
    _check(index, w, 32, topk=3, mask=np.arange(index._next_id) % 2 == 0)


@pytest.mark.parametrize("shards", [2, 3])
def test_the_row_sharded_scan(shards):
    index = _index(700, 2)
    mesh = make_mesh((shards,), ("data",), devices=["cpu"] * shards)
    _check(index, _queries(5), 36, topk=3, mesh=mesh)
    index.delete(np.arange(1, 700, 4))
    _check(index, _queries(5), 36, topk=3, mesh=mesh)


def _lsm_states(index):
    """Drive an LSM index through its segment states, naming each."""
    yield "base only"
    index.insert(_queries(80, seed=11))
    yield "base and delta"
    index.delete(np.concatenate([np.arange(0, 600, 4), index.ids_np[-80::3]]))
    yield "tombstones in both"
    assert index.begin_compaction()
    index.compaction_step(max_rows=200)
    index.insert(_queries(30, seed=12))
    index.delete(index.ids_np[index.active][1::7])
    seg = index.segments()
    assert seg["compaction_active"] and seg["frozen_rows"] > 0
    yield "mid-compaction"
    index.compact()
    assert not index.segments()["compaction_active"]
    yield "after compact"
    index.compact()
    assert index.segments()["delta_rows"] == 0
    yield "folded"


@pytest.mark.parametrize("tables", [1, 4])
@pytest.mark.parametrize("fused_rows", [16, 1 << 20])
def test_the_lsm_answers_through_the_shared_path(tables, fused_rows):
    """Every field as the LSM's old answer path gave it, in each state,
    with the delta scanned past and below ``lsm_delta_fused_rows``: a
    mask, l past the live rows, topk past L·l."""
    index = _lsm(600, tables, fused_rows=fused_rows)
    w = _queries(6)
    mask = np.random.default_rng(3).random(1000) < 0.4
    for state in _lsm_states(index):
        res = _check_lsm(index, w, 40, topk=3)
        assert all(c.size > 0 for c in res.candidates), state
        live = _check_lsm(index, w, 32, topk=2, mask=mask).ids
        assert mask[live[live >= 0]].all(), state
        res = _check_lsm(index, w, 1024, topk=3)
        assert all(c.size == index.n for c in res.candidates), state
        _check_lsm(index, _queries(3, seed=2), 8, topk=tables * 8 + 5)


@pytest.mark.parametrize("cls", [MultiTableIndex, LSMMultiTableIndex])
def test_an_index_with_no_live_row(cls):
    """Both indexes give the one empty answer, with no host timer."""
    index = cls(IndexConfig(method="bh", bits=12, tables=3, seed=5,
                            compact_threshold=None), device="cpu")
    index.fit(_queries(50, seed=4))
    index.delete(np.arange(50))
    for topk in (1, 4):
        res = index.query_scan_batch(_queries(5), l=8, topk=topk)
        assert (res.ids == -1).all() and np.isinf(res.margins).all()
        assert not res.nonempty.any() and res.lookup_s == res.rerank_s == 0
        assert [c.size for c in res.candidates] == [0] * 5
        assert np.array_equal(res.table_hits, np.zeros(3, np.int64))
        assert (res.ids_topk is None) == (topk == 1)
        if topk > 1:
            assert res.ids_topk.shape == (5, topk)
            assert (res.ids_topk == -1).all()
            assert np.isinf(res.margins_topk).all()


@pytest.mark.parametrize("kind", ["monolithic", "lsm"])
def test_a_batch_keeps_its_arrays_after_later_batches(kind):
    index = _make(kind, 800, 2)
    first = index.query_scan_batch(_queries(6), l=40, topk=3)
    kept = [c.copy() for c in first.candidates]
    ids, margins = first.ids_topk.copy(), first.margins_topk.copy()
    for s in range(5):
        index.query_scan_batch(_queries(6, seed=100 + s), l=40, topk=3)
    assert all(np.array_equal(a, b) for a, b in zip(first.candidates, kept))
    assert np.array_equal(first.ids_topk, ids)
    assert np.array_equal(first.margins_topk, margins)


@pytest.mark.parametrize("kind", ["monolithic", "lsm"])
def test_one_read_a_micro_batch(kind):
    index = _make(kind, 800, 2)
    service = HashQueryService(index, mode="scan", scan_l=32, max_batch=4)
    with trace.session() as sess:
        res = service.query_batch(_queries(10))
    reads = [s for s in sess.spans if s.name == "index.readback"]
    assert len(reads) == 3
    assert all(s.counts["reads"] == 1 for s in reads)
    assert sum(s.counts["candidates"] for s in reads) == sum(
        r.candidates.size for r in res)


def _slots(rng, b, c, n_live):
    """Sorted union slots with empty slots, repeats and rows of many
    queries; valid a subset of the kept slots; an increasing id map."""
    flat = rng.integers(-1, n_live, size=(b, c))
    flat[:, : c // 5] = rng.integers(0, max(1, n_live // 50), size=(b, c // 5))
    flat[0, :] = -1                         # a query with no candidate
    flat = np.sort(flat, axis=1).astype(np.int32)
    keep = flat >= 0
    keep[:, 1:] &= flat[:, 1:] != flat[:, :-1]
    valid = keep & (rng.random((b, c)) < 0.7)
    id_map = np.cumsum(rng.integers(1, 4, size=n_live)).astype(np.int64)
    return flat, valid, id_map


@pytest.mark.parametrize("b,c", [(1, 1), (4, 7), (10, 300), (3, 1025)])
def test_plain_lists_match_their_definition(b, c):
    rng = np.random.default_rng(b * 1000 + c)
    flat, valid, id_map = _slots(rng, b, c, 5000)
    out = cl.candidate_lists(torch.from_numpy(flat), torch.from_numpy(valid),
                             torch.from_numpy(id_map)).numpy()
    assert out.shape == (b, c + 2) and out.dtype == np.int64
    for q in range(b):
        want = id_map[np.unique(flat[q][flat[q] >= 0])]
        n = out[q, c]
        assert n == want.size
        assert np.array_equal(out[q, :n], want)
        assert (out[q, n:c] == -1).all()
        assert out[q, c + 1] == int(valid[q].any())


def _no_slots(b, c, device=None):
    """Sorted union slots of a batch with no slots to take: b == 0 or
    c == 0; the result is known without a launch."""
    want = torch.full((b, c + 2), -1, dtype=torch.int64)
    want[:, c:] = 0
    args = (torch.zeros((b, c), dtype=torch.int32, device=device),
            torch.zeros((b, c), dtype=torch.bool, device=device),
            torch.arange(5, dtype=torch.int64, device=device))
    return args, want


@pytest.mark.parametrize("b,c", [(0, 5), (3, 0), (0, 0)])
def test_plain_lists_with_no_slots(b, c):
    args, want = _no_slots(b, c)
    assert torch.equal(cl.candidate_lists(*args), want)


# -- on a card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(1, 1), (4, 7), (10, 6264), (20, 201),
                                 (3, 1025), (7, 4096), (2, 33000)])
def test_lists_kernel_vs_plain(cuda, b, c):
    rng = np.random.default_rng(b * 7 + c)
    flat, valid, id_map = _slots(rng, b, c, 1_060_000)
    args = [torch.from_numpy(a) for a in (flat, valid, id_map)]
    want = cl.candidate_lists_plain(*args)
    before = cl.candidate_lists.launches
    got = cl.candidate_lists(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert cl.candidate_lists.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(0, 5), (3, 0), (0, 0)])
def test_lists_kernel_with_no_slots(cuda, b, c):
    args, want = _no_slots(b, c, device=cuda)
    before = cl.candidate_lists.launches
    got = cl.candidate_lists(*args)
    assert cl.candidate_lists.launches == before
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["monolithic", "lsm"])
@pytest.mark.parametrize("tables", [1, 4])
def test_the_read_back_on_the_card(cuda, tables, kind):
    index = _make(kind, 3000, tables, device=cuda)
    mask = np.random.default_rng(6).random(3000) < 0.5
    # answer_from_scan and query_scan_batch; the LSM's reference has none
    check, launches = (_check, 2) if kind == "monolithic" else (_check_lsm, 1)
    for topk, m in ((1, None), (3, mask), (tables * 64 + 5, None)):
        before = cl.candidate_lists.launches
        check(index, _queries(10), 64, topk, m)
        assert cl.candidate_lists.launches == before + launches
    first = index.query_scan_batch(_queries(10), l=64, topk=3)
    kept = [c.copy() for c in first.candidates]
    ids = first.ids_topk.copy()
    for s in range(8):
        index.query_scan_batch(_queries(10, seed=50 + s), l=64, topk=3)
    torch.cuda.synchronize()
    assert all(np.array_equal(a, b) for a, b in zip(first.candidates, kept))
    assert np.array_equal(first.ids_topk, ids)
