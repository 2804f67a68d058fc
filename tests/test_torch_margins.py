"""The exact re-rank's margins (``repro_torch.kernels.margins``): on the
CPU its plain version against the margins the port computed before it
had the kernel (kept below as ``_margins_before``), bit for bit, one
segment and two; the wrapper's refusals; and the re-rank functions of
``core.search`` through it.  On a card (tests marked ``cuda``, skipped
without one; ``pytest -m cuda tests/test_torch_margins.py``) kernel 11
(csrc/row_margins.cu) against float64 and its plain version, its
invalid slots, the independence of a margin from its slot, batch and
segment, and its launches, one a call and one a micro-batch on the
serving path."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import search  # noqa: E402
from repro_torch.kernels import margins  # noqa: E402
from repro_torch.kernels.ref import (row_margins_limit,  # noqa: E402
                                     row_margins_lossy)

DS = (65, 385, 26_215)


def _margins_before(x, w, rows, valid, delta=None, split=None):
    """The margins ``core.search`` computed before kernel 11: the rows
    gathered, multiplied by w, zero-padded to a multiple of 8 floats,
    summed, divided by ||w||; +inf at invalid slots."""
    if delta is None:
        cx = x[torch.clamp(rows, 0, x.shape[0] - 1)]
    else:
        cb = x[torch.clamp(rows, 0, x.shape[0] - 1)]
        cd = delta[torch.clamp(rows - split, 0, delta.shape[0] - 1)]
        cx = torch.where((rows < split)[..., None], cb, cd)
    prod = cx * w[:, None, :]
    pad = -prod.shape[-1] % 8
    if pad:
        prod = torch.nn.functional.pad(prod, (0, pad))
    m = torch.abs(torch.sum(prod, dim=-1))
    m = m / torch.clamp(torch.linalg.vector_norm(w, dim=1, keepdim=True),
                        min=1e-12)
    return torch.where(valid, m, torch.inf)


def _inputs(d, b=4, c=37, n=500, m=120, seed=0, device="cpu"):
    """x (n, d), delta (m, d), w (b, d), rows (b, c) over the n + m rows
    of both segments (split = n), valid (b, c) with a quarter invalid."""
    rng = np.random.default_rng(seed + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    delta = rng.normal(size=(m, d)).astype(np.float32)
    w = rng.normal(size=(b, d)).astype(np.float32)
    rows = rng.integers(0, n + m, (b, c))
    valid = rng.random((b, c)) < 0.75
    return tuple(torch.from_numpy(a).to(device)
                 for a in (x, delta, w, rows, valid))


# -- CPU ----------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 33, 65, 385])
def test_plain_equals_the_margins_before_the_kernel(d):
    x, delta, w, rows, valid = _inputs(d)
    n = x.shape[0]
    one = torch.clamp(rows, max=n - 1)
    assert torch.equal(margins.row_margins(x, w, one, valid),
                       _margins_before(x, w, one, valid))
    assert torch.equal(
        margins.row_margins(x, w, rows, valid, delta=delta, split=n),
        _margins_before(x, w, rows, valid, delta, n))
    # invalid slots may hold ids out of range
    bad = torch.where(valid, one, -7)
    assert torch.equal(margins.row_margins(x, w, bad, valid),
                       _margins_before(x, w, one, valid))


def test_search_functions_take_their_margins_from_the_wrapper():
    x, delta, w, rows, valid = _inputs(65)
    n = x.shape[0]
    one = torch.clamp(rows, max=n - 1)
    want = _margins_before(x, w, one, valid)
    assert torch.equal(search.margin_batch(x, w, one, valid), want)
    m, top = search.margin_rerank_batch(x, w, one, valid, 5)
    order = torch.argsort(want, dim=1, stable=True)[:, :5]
    assert torch.equal(m, torch.gather(want, 1, order))
    assert torch.equal(top, torch.gather(one, 1, order))
    seg = _margins_before(x, w, rows, valid, delta, n)
    assert torch.equal(search.margin_batch_segmented(x, delta, n, w, rows,
                                                     valid), seg)
    m, top = search.margin_rerank_segmented(x, delta, n, w, rows, valid, 5)
    order = torch.argsort(seg, dim=1, stable=True)[:, :5]
    assert torch.equal(m, torch.gather(seg, 1, order))
    assert torch.equal(top, torch.gather(rows, 1, order))


def _refusals(x, delta, w, rows, valid):
    n = x.shape[0]
    yield "x float64", (x.double(), w, rows, valid), {}
    yield "w float64", (x, w.double(), rows, valid), {}
    yield "rows int32", (x, w, rows.int(), valid), {}
    yield "valid uint8", (x, w, rows, valid.to(torch.uint8)), {}
    yield "delta float64", (x, w, rows, valid), dict(delta=delta.double(),
                                                     split=n)
    yield "w short", (x, w[:, :-1], rows, valid), {}
    yield "w rows", (x, w[:-1], rows, valid), {}
    yield "valid shape", (x, w, rows, valid[:, :-1]), {}
    yield "rows 1-D", (x, w, rows[0], valid[0]), {}
    yield "delta width", (x, w, rows, valid), dict(delta=delta[:, :-1],
                                                   split=n)
    yield "delta 1-D", (x, w, rows, valid), dict(delta=delta[0], split=n)
    yield "split alone", (x, w, rows, valid), dict(split=n)
    yield "delta alone", (x, w, rows, valid), dict(delta=delta, split=None)
    yield "split < 0", (x, w, rows, valid), dict(delta=delta, split=-1)
    yield "x strided", (x[::2], w, rows, valid), {}
    yield "w strided", (x, w.t().contiguous().t(), rows, valid), {}
    yield "rows strided", (x, w, rows.t().contiguous().t(), valid), {}
    yield "w on meta", (x, w.to("meta"), rows, valid), {}
    yield "x on meta", (x.to("meta"), w.to("meta"), rows.to("meta"),
                        valid.to("meta")), {}


@pytest.mark.parametrize("case", [c for c, _, _ in _refusals(
    *_inputs(9, b=3, c=5, n=20, m=6))])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, delta, w, rows, valid = _inputs(9, b=3, c=5, n=20, m=6)
    args, kw = next((a, k) for c, a, k in _refusals(x, delta, w, rows,
                                                    valid) if c == case)
    with pytest.raises(ValueError):
        margins.row_margins(*args, **kw)


@pytest.mark.parametrize("d", DS)
def test_plain_version_within_the_float32_limit(d):
    """The plain version against float64 within ``row_margins_limit``,
    one segment and two; +inf at invalid slots."""
    x, delta, w, rows, valid = _inputs(d)
    n = x.shape[0]
    one = torch.clamp(rows, max=n - 1)
    for kw, r in (({}, one), (dict(delta=delta, split=n), rows)):
        got = margins.row_margins(x, w, r, valid, **kw)
        tol, want = row_margins_limit(x, w, r, valid, **kw)
        assert torch.isinf(got[~valid]).all() and torch.isinf(
            want[~valid]).all()
        err = (got[valid].double() - want[valid]).abs()
        assert bool(err.le(tol[valid]).all()), kw
        # the limit is no worst case: float32's own error lies far inside
        assert float((err / tol[valid]).max()) < 0.25, kw


@pytest.mark.parametrize("kind", ["tf32", "bf16", "lost_partial"])
@pytest.mark.parametrize("d", DS)
def test_the_limit_refuses_a_lossy_sum(d, kind):
    """What a kernel would give that multiplied in TF32 or bf16, or lost
    one warp's partial (one lane's where a warp sums the row), lies past
    ``row_margins_limit`` on most slots, at every d of the cells."""
    x, _, w, rows, valid = _inputs(d)
    one = torch.clamp(rows, max=x.shape[0] - 1)
    tol, want = row_margins_limit(x, w, one, valid)
    xl, wl = row_margins_lossy(x, w, kind)
    got = margins.row_margins(xl, wl, one, valid)
    past = (got[valid].double() - want[valid]).abs() > tol[valid]
    assert float(past.double().mean()) > 0.5, kind


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", DS)
def test_kernel_against_float64_and_the_plain_version(cuda, d):
    x, delta, w, rows, valid = _inputs(d, device=cuda)
    n = x.shape[0]
    one = torch.clamp(rows, max=n - 1)
    for kw, r in (({}, one), (dict(delta=delta, split=n), rows)):
        got = margins.row_margins(x, w, r, valid, **kw)
        plain = margins.row_margins_plain(x, w, r, valid, **kw)
        tol, want = row_margins_limit(x, w, r, valid, **kw)
        torch.cuda.synchronize()
        assert torch.isinf(got[~valid]).all() and (got[~valid] > 0).all()
        assert bool((got[valid].double() - want[valid]).abs().le(
            tol[valid]).all()), kw
        assert bool((got[valid].double() - plain[valid].double()).abs().le(
            2 * tol[valid]).all()), kw


@pytest.mark.cuda
@pytest.mark.parametrize("d", DS)
def test_invalid_slots_read_no_row(cuda, d):
    """Invalid slots hold +inf whatever their id, and ids far out of
    range there fault nothing; a valid slot whose row lies in neither
    segment reads NaN."""
    x, delta, w, rows, valid = _inputs(d, device=cuda)
    n = x.shape[0]
    far = torch.where(valid, torch.clamp(rows, max=n - 1),
                      torch.full_like(rows, 2 ** 40))
    far[0, :3] = -(2 ** 40)
    valid[0, :3] = False
    got = margins.row_margins(x, w, far, valid)
    torch.cuda.synchronize()
    assert torch.isinf(got[~valid]).all()
    assert torch.isfinite(got[valid]).all()
    lost = valid.clone()
    lost[1:] = False
    lost[0, 3] = True
    bad = far.clone()
    bad[0, 3] = n + delta.shape[0]
    got = margins.row_margins(x, w, bad, lost, delta=delta, split=n)
    torch.cuda.synchronize()
    assert torch.isnan(got[0, 3]) and torch.isinf(got[~lost]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", DS)
def test_a_margin_depends_on_its_row_w_and_d_alone(cuda, d):
    """The same rows one slot further along, in another batch (one query
    alone, or among more queries), or read through the second segment
    give bit-identical margins."""
    x, delta, w, rows, valid = _inputs(d, device=cuda)
    n = x.shape[0]
    one = torch.clamp(rows, max=n - 1)
    valid = torch.ones_like(valid)
    m0 = margins.row_margins(x, w, one, valid)
    for shift in (1, 2, 3, 5, 300):
        pad = torch.zeros((4, shift), dtype=one.dtype, device=cuda)
        m = margins.row_margins(x, w, torch.cat([pad, one], 1).contiguous(),
                                torch.ones((4, 37 + shift), dtype=torch.bool,
                                           device=cuda))
        assert torch.equal(m[:, shift:], m0), shift
    for i in range(4):
        m = margins.row_margins(x, w[i:i + 1].contiguous(),
                                one[i:i + 1].contiguous(),
                                valid[i:i + 1].contiguous())
        assert torch.equal(m[0], m0[i])
    many = margins.row_margins(x, w.repeat(3, 1), one.repeat(3, 1),
                               valid.repeat(3, 1))
    assert torch.equal(many, m0.repeat(3, 1))
    # the base's rows from 200 on moved into a delta segment
    seg = margins.row_margins(x[:200].contiguous(), w, one, valid,
                              delta=x[200:].contiguous(), split=200)
    assert torch.equal(seg, m0)


@pytest.mark.cuda
def test_one_launch_a_call_and_one_a_scan_micro_batch(cuda):
    from repro_torch.core.indexer import IndexConfig
    from repro_torch.serving.multi_table import MultiTableIndex
    from repro_torch.serving.service import HashQueryService
    from repro_torch.utils import trace
    x, delta, w, rows, valid = _inputs(385, device=cuda)
    n = x.shape[0]
    before = margins.row_margins.launches
    margins.row_margins(x, w, torch.clamp(rows, max=n - 1), valid)
    margins.row_margins(x, w, rows, valid, delta=delta, split=n)
    assert margins.row_margins.launches == before + 2
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(3000, 33)).astype(np.float32)
    idx = MultiTableIndex(IndexConfig(method="bh", bits=20, tables=2,
                                      batch=8, seed=3), device=cuda).fit(xs)
    svc = HashQueryService(idx, mode="scan", scan_l=32, max_batch=8)
    ws = rng.normal(size=(20, 33)).astype(np.float32)
    before = margins.row_margins.launches
    with trace.session() as sess:
        svc.query_batch(ws)
    assert margins.row_margins.launches == before + 3
    counts = trace.summary(sess)["index.rerank"]["counts"]
    assert counts["row_margins"] == 3
