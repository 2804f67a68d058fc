"""The row-sharded cell (``tinyimages80m-mesh4-round10``) on the CPU, its
four shards co-located: the same seed and shard count draw the same rows;
the sharded reference equals ``HyperplaneReference`` on the concatenated
rows; a small run reads correct, the TF32 control and a broken timed
path do not; and the four readers of its per-card spans read exact
values on synthetic sessions (100 / 25 for cards that select at once /
in turn), stay in [0, 100], and read None where there is nothing to
read; the kernels' ``shard_select_roofline`` reads their device time
against the frozen bound, which equals the program's."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench import check as chk  # noqa: E402
from perfbench import costs, costs_mesh, data_mesh, spans, spec  # noqa: E402
from perfbench.harness import run  # noqa: E402
from perfbench.reference.hyperplane import HyperplaneReference  # noqa: E402
from perfbench.reference.hyperplane_mesh import (  # noqa: E402
    MeshHyperplaneReference)
from perfbench.tools.control_mesh import control  # noqa: E402
from repro_torch.serving.service import HashQueryService  # noqa: E402

ROOT = __import__("pathlib").Path(__file__).resolve().parents[2]
CELL = "tinyimages80m-mesh4-round10"
SIZE = {"data": {"n_labeled": 600, "n_unlabeled": 5003, "d": 32},
        "traffic": {"scan_l": 97, "pool_batches": 4},
        "check": {"sample_batches": 3}}
CPU = torch.device("cpu")
METRICS = ("shard_overlap", "shard_select_wall_roofline",
           "shard_rerank_wall_roofline", "exchange_bytes_per_batch")


def _draw(seed, shards, n_unl=1003):
    return data_mesh.tiny1m_shards(seed, [CPU] * shards, 60, n_unl, 12, 10)


@pytest.mark.parametrize("shards", (1, 3, 4))
def test_the_same_seed_and_shards_draw_the_same_rows(shards):
    parts, labels, n = _draw(2_147_483_659, shards)
    again, labels2, _ = _draw(2_147_483_659, shards)
    other, _, _ = _draw(2_147_483_660, shards)
    rows, valid = data_mesh.shard_layout(n, shards)
    assert n == 1063 and all(p.shape == (rows, 13) for p in parts)
    for p, q, r, v in zip(parts, again, other, valid):
        assert torch.equal(p, q) and not torch.equal(p[:v], r[:v])
        assert torch.all(p[v:] == 0)
        norms = torch.linalg.vector_norm(p[:v], dim=1)
        assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    for (pos, cls), (pos2, cls2) in zip(labels, labels2):
        assert torch.equal(pos, pos2) and torch.equal(cls, cls2)
    assert sum(pos.numel() for pos, _ in labels) == 60
    assert torch.equal(torch.sort(torch.cat([c for _, c in labels])).values,
                       torch.arange(10).repeat_interleave(6))


@pytest.mark.parametrize("precision", ("float64", "tf32"))
@pytest.mark.parametrize("shards", (1, 2, 4))
def test_the_sharded_reference_is_the_reference_on_the_concatenation(
        precision, shards):
    parts, labels, n = _draw(5, shards, n_unl=2003)
    rows, valid = data_mesh.shard_layout(n, shards)
    x = torch.cat([p[:v] for p, v in zip(parts, valid)])
    seeds = [11, 2_000_000_011]
    mesh = MeshHyperplaneReference(parts, n, seeds, 20, precision)
    one = HyperplaneReference(x, seeds, 20, precision)
    w = data_mesh.normals_sharded(parts, labels, n, 10, 7, 5, 1.0, CPU)
    for l in (1, 97, rows + 3, n + 10):
        assert torch.equal(mesh.table_topl(w, l), one.table_topl(w, l))
        got, want = mesh.unions(w, l), one.unions(w, l)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    ids = np.random.default_rng(0).integers(0, n, size=(7, 40))
    m, s = mesh.margins(w, ids)
    m1, s1 = one.margins(w, torch.from_numpy(ids))
    assert torch.allclose(m, m1.double(), rtol=1e-12, atol=0)
    assert torch.allclose(s, s1.double(), rtol=1e-12, atol=0)
    a, b = mesh.answer(w, 97), one.answer(w, 97)
    assert np.array_equal(a[0], b[0]) and np.allclose(a[1], b[1], rtol=1e-6)


def test_a_small_run_on_cpu_shards_is_correct():
    out = run(ROOT, CELL, 2_147_483_659, 0.3, False, require_cuda=False,
              device="cpu", size=SIZE)
    assert out["correct"], out["checks"]
    assert out["attempted"] % 10 == 0 and out["failed"] == 0
    assert set(out["checks"]) == {"unanswered", "margin_err",
                                  "cand_mismatch", "cand_id_share",
                                  "rerank_gap"}
    assert set(out["metrics"]) == {"qps", "setup_s"}


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_the_control_is_not_correct(seed):
    numbers, limits = control(CELL, seed, CPU, SIZE, root=ROOT)
    correct, checks = chk.verdict(numbers, limits)
    assert not correct, checks


def _altered(real):
    def query_batch(self, ws, mask=None):
        out = real(self, ws, mask)
        out[len(out) // 2].index += 1
        return out
    return query_batch


def _half_left_out(real):
    def query_batch(self, ws, mask=None):
        ws = np.atleast_2d(ws)
        out = real(self, ws[:max(1, ws.shape[0] // 2)], mask)
        return (out * 3)[:ws.shape[0]]
    return query_batch


@pytest.mark.parametrize("fault", (_altered, _half_left_out))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(HashQueryService, "query_batch",
                        fault(HashQueryService.query_batch))
    out = run(ROOT, CELL, 31_337, 0.3, False, require_cuda=False,
              device="cpu", size=SIZE)
    assert not out["correct"], out["checks"]


# -- the readers of the per-card spans -----------------------------------------

SHAPE = {"n": 79_362_017, "d": 385, "k": 20, "w": 1, "g": 1, "b": 10,
         "l": 468_947, "shards": 4, "shard_rows": 19_840_505}


def _span(name, sid, parent, batch, device=None, dev=(None, None),
          counts=None):
    return SimpleNamespace(name=name, id=sid, parent=parent, batch=batch,
                           device=device, host_start=0, host_end=1,
                           device_start=dev[0], device_end=dev[1],
                           counts=counts, marks=None)


def _batch(root, t0, serial):
    """A root and, on each of four cards, a shard select of 100 ns (at
    once, or one card after another), 80 ns of re-rank and 1,000 + card
    candidates; 5,000 bytes exchanged."""
    out = [_span("service.batch", root, None, root),
           _span("index.exchange", root + 1, root, root, "cuda:0",
                 counts={"exchange_bytes": 5000})]
    for c in range(4):
        start = t0 + (100 * c if serial else 0)
        out.append(_span("index.shard_select", root + 2 + c, root, root,
                         f"cuda:{c}", (start, start + 100),
                         {"candidates": 1000 + c}))
        out.append(_span("index.shard_rerank", root + 6 + c, root, root,
                         f"cuda:{c}", (start + 400, start + 480)))
    return out


def _session(serial):
    stale = _batch(1, -5000, serial)       # an earlier profiler try's
    return SimpleNamespace(device=True, dropped=0, spans=stale + _batch(
        20, 0, serial) + _batch(40, 1000, serial))


def _ctx(batches=2):
    return {"phases": {"traced": {"batches": batches}}, "shape": SHAPE,
            "costs": costs}


@pytest.mark.parametrize("serial", (False, True))
def test_the_readers_are_exact_on_a_synthetic_session(serial, monkeypatch):
    monkeypatch.setattr(spans, "last_session", lambda: _session(serial))
    read = {m: spec.metric_module(m).read(_ctx()) for m in METRICS}
    assert read["shard_overlap"] == pytest.approx(25.0 if serial else 100.0)
    select = costs_mesh.shard_select_bound(SHAPE["shard_rows"], 1, 10, 1003)
    assert read["shard_select_wall_roofline"] == pytest.approx(
        100 * select.seconds / 100e-9)
    rerank = costs.rerank_bound(1003, SHAPE["d"])
    assert read["shard_rerank_wall_roofline"] == pytest.approx(
        100 * rerank.seconds / 80e-9)
    assert read["exchange_bytes_per_batch"] == 5000.0


def test_the_shares_stay_within_0_and_100_on_realistic_walls(monkeypatch):
    """At walls no shorter than their bounds, each share lies in [0, 100]:
    a select of 1 ms (its bound ~0.05 ms) and a re-rank of 3 ms (its bound
    at the most candidates ~0.2 ms)."""
    sess = _session(True)
    for s in sess.spans:
        if s.name == "index.shard_select":
            s.device_end = s.device_start + 1_000_000
            s.counts = {"candidates": 10 * 117_237}
        if s.name == "index.shard_rerank":
            s.device_end = s.device_start + 3_000_000
    monkeypatch.setattr(spans, "last_session", lambda: sess)
    for m in METRICS[:3]:
        assert 0 <= spec.metric_module(m).read(_ctx()) <= 100


@pytest.mark.parametrize("metric", METRICS)
def test_the_readers_read_none_without_spans(metric, monkeypatch):
    mod = spec.metric_module(metric)
    monkeypatch.setattr(spans, "last_session", lambda: None)
    assert mod.read(_ctx()) is None
    no_device = _session(False)
    no_device.device = False
    monkeypatch.setattr(spans, "last_session", lambda: no_device)
    assert mod.read(_ctx()) is None
    # a single-device program's session: no per-card spans
    single = SimpleNamespace(device=True, dropped=0, spans=[
        s for s in _session(False).spans if s.name == "service.batch"])
    monkeypatch.setattr(spans, "last_session", lambda: single)
    assert mod.read(_ctx()) is None
    monkeypatch.setattr(spans, "last_session", lambda: _session(False))
    assert mod.read(_ctx(batches=5)) is None


def test_the_card_clock_check_counts_each_cards_violations(monkeypatch):
    """``tools/mesh_span_check``: a card event before its batch's host
    start or past its first read (+ 20 us) is a violation of that card;
    the read-back's candidates are counted apart from the cards'."""
    from perfbench.tools import mesh_span_check as msc
    sess = _session(True)
    for s in sess.spans:
        if s.parent is None:
            s.host_start, s.host_end = s.id * 100 - 6000, s.id * 100 + 5000
    sess.spans += [_span("index.readback", r + 20, r, r,
                         counts={"candidates": 7}) for r in (1, 20, 40)]
    for s in sess.spans[-3:]:
        s.marks = {"first_read": s.batch * 100 + 4000}
    late = next(s for s in sess.spans if s.batch == 40
                and s.name == "index.shard_rerank" and s.device == "cuda:3")
    late.device_end = 40 * 100 + 4000 + 25_000
    monkeypatch.setattr(spans, "last_session", lambda: sess)
    got = msc.card_clock(_ctx())
    assert {k: v["violations"] for k, v in got.items()} == {
        "cuda:0": 0, "cuda:1": 0, "cuda:2": 0, "cuda:3": 1}
    assert msc._readback_candidates(sess, [0, 0]) == 14


@pytest.mark.parametrize("n,w,b,selected,g", [
    (19_840_505, 1, 10, 1_172_370, 1), (79_362_017, 1, 10, 4_689_470, 1),
    (1_060_000, 1, 32, 4096, 4), (100_000, 13, 7, 0, 2)])
def test_the_select_bound_is_the_programs(n, w, b, selected, g):
    from repro_torch.kernels import ops
    assert costs_mesh.shard_select_bound(n, w, b, selected, g=g) == tuple(
        ops.shard_select_bound(n, w, b, selected, g=g))


def test_the_select_kernels_roofline_reads_their_device_time():
    """100 when the three kernels took the summed bound, a share of it
    when they took longer; None where they did not run (the parent, or
    a profile without them)."""
    mod = spec.metric_module("shard_select_roofline")
    bound = costs_mesh.shard_select_bound(SHAPE["n"], 1, 10, 10 * SHAPE["l"])
    per = 2 * bound.seconds / 3

    def ctx(kernels):
        return dict(_ctx(), profile={"kernels": kernels})
    kernels = {"(anonymous namespace)::shard_hist_kernel(...)": [per, 8],
               "(anonymous namespace)::shard_offsets_kernel(...)": [per, 8],
               "(anonymous namespace)::shard_select_kernel(...)": [per, 8],
               "void at::native::index_elementwise_kernel": [1.0, 8]}
    assert mod.read(ctx(kernels)) == pytest.approx(100.0)
    kernels = {k: [4 * v[0], v[1]] for k, v in kernels.items()}
    assert mod.read(ctx(kernels)) == pytest.approx(25.0)
    assert mod.read(ctx({"void at::cuda::kernelHistogram1D": [1.0, 8]})) \
        is None


def test_cand_mismatch_counts_the_unions_past_the_slack():
    """A union that misses the reference's by a share of its ids above
    ``check_mesh.UNION_SLACK`` counts; one within it does not."""
    from perfbench import check_mesh
    ref_ids = np.arange(100_000)

    class Ref:
        def unions(self, w, l):
            return [ref_ids] * w.shape[0]

        def margins(self, w, ids):
            m = torch.zeros(ids.shape, dtype=torch.float64)
            return m, m + 1

    got = [ref_ids, np.delete(ref_ids, [5]), np.delete(ref_ids, range(10))]
    out = check_mesh.sample_numbers(Ref(), torch.zeros(3, 4), 7,
                                    np.zeros(3, np.int64), got)
    assert 1e-5 <= check_mesh.UNION_SLACK < 1e-4
    assert out["cand_mismatch"] == 1
    assert out["cand_id_share"] == pytest.approx(1e-4)
