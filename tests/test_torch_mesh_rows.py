"""The index fit from row shards (``MultiTableIndex.fit_sharded``) on the
CPU, its shards co-located (``make_mesh(S, "data", ["cpu"] * S)``): its
answers, margins, candidate lists and table hits equal the single-device
index's over the same rows bit for bit, for S = 1 to 4, n no multiple of
S, the cutoff's ties across a shard boundary, l past one shard's rows and
past n, top-k and a mask; it keeps no host copy of the rows; what it
cannot do raises NotImplementedError; its micro-batches record the mesh
spans; and the cutoff exchange's pieces agree with a plain top-l.  On a
card (tests marked ``cuda``, skipped without one; ``pytest -m cuda
tests/test_torch_mesh_rows.py``) the shard kernels equal their plain
versions and a co-located sharded index answers as the one-card index."""
import numpy as np
import pytest
import torch

from repro_torch.core.indexer import IndexConfig
from repro_torch.core.search import cutoff_exchange, shard_rows
from repro_torch.kernels import shard_select as ss
from repro_torch.kernels.shard_select import block_histogram, select_rows
from repro_torch.serving.multi_table import MultiTableIndex
from repro_torch.serving.service import HashQueryService
from repro_torch.utils import trace
from repro_torch.utils.mesh import make_mesh

D = 19


def _rows(n, kind, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    if kind == "ties":
        # a handful of distinct rows repeated: every distance is shared by
        # rows of every shard, so the cutoff's ties straddle boundaries
        x = x[rng.integers(0, 5, size=n)]
    return x


def _pair(x, s, **cfg):
    config = IndexConfig(method="bh", seed=5, **cfg)
    single = MultiTableIndex(config, device="cpu").fit(x)
    mesh = make_mesh(s, "data", ["cpu"] * s)
    parts = shard_rows(torch.from_numpy(x), mesh)
    sharded = MultiTableIndex(config, device="cpu").fit_sharded(
        parts, mesh, n=x.shape[0])
    return single, sharded, mesh


def _same(a, b, topk):
    assert np.array_equal(a.ids, b.ids)
    assert np.array_equal(a.margins, b.margins)
    assert np.array_equal(a.nonempty, b.nonempty)
    assert np.array_equal(a.table_hits, b.table_hits)
    assert len(a.candidates) == len(b.candidates)
    for p, q in zip(a.candidates, b.candidates):
        assert p.dtype == q.dtype and np.array_equal(p, q)
    if topk > 1:
        assert np.array_equal(a.ids_topk, b.ids_topk)
        assert np.array_equal(a.margins_topk, b.margins_topk)


CASES = [
    # (n, kind, bits, tables, l, topk, masked)
    (1003, "normal", 16, 1, 64, 1, False),
    (1003, "normal", 12, 2, 300, 3, True),
    (998, "ties", 6, 1, 333, 1, False),
    (998, "ties", 4, 2, 401, 2, True),
    (101, "normal", 10, 1, 60, 4, False),      # l past one shard's rows
    (37, "normal", 8, 2, 100, 5, True),        # l past n
]


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_sharded_rows_answer_as_one_device(shards, case):
    n, kind, bits, tables, l, topk, masked = case
    x = _rows(n, kind, seed=n + bits)
    single, sharded, _ = _pair(x, shards, bits=bits, tables=tables)
    rng = np.random.default_rng(shards)
    w = rng.normal(size=(7, D)).astype(np.float32)
    mask = rng.random(n) < 0.6 if masked else None
    _same(single.query_scan_batch(w, l=l, topk=topk, mask=mask),
          sharded.query_scan_batch(w, l=l, topk=topk, mask=mask), topk)


def test_the_service_over_sharded_rows_answers_as_one_device():
    x = _rows(1501, "normal")
    single, sharded, mesh = _pair(x, 3, bits=14, tables=1)
    w = np.random.default_rng(9).normal(size=(23, D)).astype(np.float32)
    a = HashQueryService(single, mode="scan", scan_l=90, max_batch=8)
    b = HashQueryService(sharded, mode="scan", scan_l=90, max_batch=8,
                         mesh=mesh)
    for r, s in zip(a.query_batch(w), b.query_batch(w)):
        assert (r.index, r.margin, r.nonempty) == (s.index, s.margin,
                                                   s.nonempty)
        assert np.array_equal(r.candidates, s.candidates)
    other = make_mesh(3, "rows", ["cpu"] * 3)
    with pytest.raises(ValueError, match="sharded over"):
        sharded.query_scan_batch(w, l=90, mesh=other, shard_axis="rows")


def test_the_sharded_fit_keeps_no_host_copy_of_the_rows():
    x = _rows(1000, "normal")
    _, sharded, _ = _pair(x, 4, bits=12, tables=2)
    assert sharded.x_np is None and sharded.codes == []
    for value in vars(sharded).values():
        assert not (isinstance(value, np.ndarray) and value.ndim == 2), \
            "a host array of the rows' shape"
    assert sharded._x_parts[0].shape == (250, D)
    assert sharded.n == 1000 and sharded.stats()["n"] == 1000


REFUSED = [
    ("insert", lambda idx, w: idx.insert(w[:2])),
    ("delete", lambda idx, w: idx.delete([0])),
    ("compact", lambda idx, w: idx.compact()),
    ("lookup_batch", lambda idx, w: idx.lookup_batch(w)),
    ("query_batch", lambda idx, w: idx.query_batch(w)),
    ("query", lambda idx, w: idx.query(w[0])),
    ("rerank_rows", lambda idx, w: idx.rerank_rows(w, [np.arange(3)] * 4)),
    ("scan_table_topk", lambda idx, w: idx.scan_table_topk(w, l=8)),
    ("candidate_margins",
     lambda idx, w: idx.candidate_margins(w, np.zeros((4, 2), np.int64))),
    ("x", lambda idx, w: idx.x),
    ("answer_from_scan",
     lambda idx, w: idx.answer_from_scan(w, torch.zeros((1, 4, 2),
                                                        dtype=torch.int32))),
]


@pytest.mark.parametrize("op,call", REFUSED, ids=[r[0] for r in REFUSED])
def test_what_needs_whole_rows_raises(op, call):
    _, sharded, _ = _pair(_rows(400, "normal"), 2, bits=10, tables=1)
    w = np.random.default_rng(1).normal(size=(4, D)).astype(np.float32)
    with pytest.raises(NotImplementedError, match=op):
        call(sharded, w)
    # the probe service is refused too, through its index
    if op == "query_batch":
        with pytest.raises(NotImplementedError):
            HashQueryService(sharded, mode="probe").query_batch(w)


def test_fit_sharded_checks_its_shards_and_families():
    mesh = make_mesh(2, "data", ["cpu"] * 2)
    x = torch.from_numpy(_rows(100, "normal"))
    idx = MultiTableIndex(IndexConfig(method="bh", bits=8, seed=1),
                          device="cpu")
    with pytest.raises(ValueError, match="row shards"):
        idx.fit_sharded(shard_rows(x, mesh)[:1], mesh)
    with pytest.raises(ValueError):
        idx.fit_sharded((x[:50], x[50:].double()), mesh)
    with pytest.raises(ValueError, match="do not fit"):
        idx.fit_sharded(shard_rows(x, mesh), mesh, n=101)
    ah = MultiTableIndex(IndexConfig(method="ah", bits=8, seed=1),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="seeded BH"):
        ah.fit_sharded(shard_rows(x, mesh), mesh)


def test_a_sharded_batch_records_the_mesh_spans():
    """Per micro-batch: the hash, three exchanges, two selects and a
    re-rank per shard, the union, the re-rank and the read-back; two
    blocking reads; the select spans count the rows each shard selected,
    the read-back the unique candidates; co-located shards exchange no
    bytes."""
    x = _rows(1003, "normal")
    _, sharded, mesh = _pair(x, 3, bits=14, tables=1)
    service = HashQueryService(sharded, mode="scan", scan_l=50, max_batch=5,
                               mesh=mesh)
    w = np.random.default_rng(4).normal(size=(5, D)).astype(np.float32)
    with trace.session() as sess:
        res = service.query_batch(w)
    kids = [s for s in sess.spans if s.parent is not None]
    names = [s.name for s in kids]
    assert names == (["index.hash", "index.exchange"]
                     + ["index.shard_select"] * 3 + ["index.exchange"]
                     + ["index.shard_select"] * 3
                     + ["index.shard_rerank"] * 3
                     + ["index.exchange", "index.union", "index.rerank",
                        "index.readback"])
    selects = [s for s in kids if s.name == "index.shard_select"]
    assert all(s.device == torch.device("cpu") for s in selects)
    assert sum((s.counts or {}).get("candidates", 0) for s in selects) == \
        5 * 50
    summ = trace.summary(sess)
    assert summ["index.exchange"]["counts"] == {"reads": 1}
    assert summ["index.readback"]["counts"] == {
        "reads": 1, "candidates": sum(r.candidates.size for r in res)}


def test_the_cutoff_exchange_gives_the_plain_top_l():
    """Shards' histograms, the cutoff exchange and each shard's selection
    together give the rows of the l smallest (distance, row) of the whole
    row range, ties to the lowest row, padding rows never."""
    rng = np.random.default_rng(3)
    bins, shards, rows = 9, 3, 40
    n = shards * rows - 7
    d = torch.from_numpy(rng.integers(0, bins, size=(2, 3, shards * rows))
                         ).to(torch.int32)
    valid = [min(max(n - s * rows, 0), rows) for s in range(shards)]
    parts = [d[..., s * rows:s * rows + v] for s, v in enumerate(valid)]
    for l in (1, 17, 40, 41, n):
        hists = torch.stack([block_histogram(p, bins)[0] for p in parts])
        cut, take, counts = cutoff_exchange(hists, l)
        sels = [select_rows(p, cut, take[s], rows, rows)
                for s, p in enumerate(parts)]
        got = torch.cat([torch.where(sel < rows, sel + s * rows, -1)
                         for s, sel in enumerate(sels)], dim=-1)
        key = d[..., :n].to(torch.int64) * (1 << 20) + torch.arange(n)
        want = torch.sort(torch.topk(key, l, largest=False).values
                          % (1 << 20)).values
        got = torch.sort(torch.where(got < 0, 1 << 30, got).to(
            torch.int64)).values[..., :l]
        assert torch.equal(got, want)
        assert torch.equal(counts.sum(0), torch.full((2, 3), l))


def test_the_blocks_sum_to_the_histogram():
    """The plain histogram's row blocks: BLOCK_ROWS rows each, the last
    short, summing to the whole histogram; padding rows never counted."""
    rng = np.random.default_rng(4)
    rows, n_valid = 2 * ss.BLOCK_ROWS + 77, 2 * ss.BLOCK_ROWS + 70
    codes = torch.from_numpy(rng.integers(0, 1 << 12, size=(2, rows, 1),
                                          dtype=np.int32))
    q = torch.from_numpy(rng.integers(0, 1 << 12, size=(2, 5, 1),
                                      dtype=np.int32))
    hist, blocks = ss.shard_histogram(codes, q, n_valid)
    assert blocks.shape == (2, 5, 3, 33) and blocks.dtype == torch.int32
    assert torch.equal(blocks.sum(2).to(torch.int64), hist)
    assert bool((blocks.sum(-1)[..., :2] == ss.BLOCK_ROWS).all())
    assert bool((blocks.sum(-1)[..., 2] == 70).all())


# -- on a card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("g,rows,n_valid,w,b,bits", [
    (1, 100_003, 100_003, 1, 10, 20), (2, 9000, 8191, 1, 3, 8),
    (1, 4096, 1, 1, 1, 20), (3, 20_000, 19_999, 2, 7, 40),
    (1, 50_000, 45_000, 1, 300, 12), (1, 6000, 6000, 13, 40, 416)])
def test_the_shard_kernels_equal_their_plain_versions(cuda, g, rows, n_valid,
                                                      w, b, bits):
    gen = torch.Generator(device=cuda).manual_seed(rows + b)

    def draw(shape):
        t = torch.randint(-(1 << 31), (1 << 31) - 1, shape, generator=gen,
                          device=cuda, dtype=torch.int32)
        return t & ((1 << bits) - 1) if bits < 32 else t
    codes, q = draw((g, rows, w)), draw((g, b, w))
    h0, s0 = ss.shard_histogram.launches, ss.shard_select.launches
    hist, blocks = ss.shard_histogram(codes, q, n_valid)
    hp, bp = ss.shard_histogram_plain(codes, q, n_valid)
    assert torch.equal(hist, hp) and torch.equal(blocks, bp)
    for t in sorted({1, n_valid // 3 + 1, n_valid}):
        cut, take, counts = cutoff_exchange(hist[None], t)
        width = int(counts.max())
        got = ss.shard_select(codes, q, n_valid, blocks, cut,
                              take[0].contiguous(), width)
        want = ss.shard_select_plain(codes, q, n_valid, blocks, cut, take[0],
                                     width)
        assert torch.equal(got, want), t
    assert ss.shard_histogram.launches == h0 + 1
    assert ss.shard_select.launches == s0 + 2 * len({1, n_valid // 3 + 1,
                                                     n_valid})


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_colocated_shards_on_the_card_answer_as_one_card(cuda, shards):
    x = _rows(30_011, "normal")
    config = IndexConfig(method="bh", seed=5, bits=16, tables=2)
    single = MultiTableIndex(config, device=cuda).fit(x)
    mesh = make_mesh(shards, "data", [cuda] * shards)
    parts = shard_rows(torch.from_numpy(x).to(cuda), mesh)
    sharded = MultiTableIndex(config, device=cuda).fit_sharded(
        parts, mesh, n=x.shape[0])
    w = np.random.default_rng(1).normal(size=(10, D)).astype(np.float32)
    mask = np.random.default_rng(2).random(x.shape[0]) < 0.6
    for l, topk, m in ((900, 1, None), (4000, 3, mask), (20_000, 2, None)):
        h0 = ss.shard_histogram.launches
        _same(single.query_scan_batch(w, l=l, topk=topk, mask=m),
              sharded.query_scan_batch(w, l=l, topk=topk, mask=m), topk)
        assert ss.shard_histogram.launches == h0 + shards
