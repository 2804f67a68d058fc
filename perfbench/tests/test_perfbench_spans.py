"""The readers of the program's spans (``perfbench/spans.py`` and the six
metrics that use it): exact values on a synthetic session, the last
``batches`` roots when the profiler was tried more than once, and None
where there is nothing to read (no session, no tracer in the program, or
a session without device times, as on the CPU)."""
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import costs, spec, spans

METRICS = ("idle_issue_share", "idle_readback_share", "idle_client_share",
           "merge_wall_roofline", "rerank_wall_roofline",
           "device_reads_per_batch")
SHAPE = {"n": 1_060_000, "d": 385, "k": 20, "w": 1, "g": 1, "b": 10,
         "l": 6264}
BUSY_NS = 800


def _span(name, sid, parent, batch, host, device, counts=None, marks=None):
    return SimpleNamespace(name=name, id=sid, parent=parent, batch=batch,
                           host_start=host[0], host_end=host[1],
                           device_start=device[0], device_end=device[1],
                           counts=counts, marks=marks)


def _batch(root, h0, h3, merge, union, rerank, d1, counts):
    """A root (host only) and its hash and scan (host only), merge, union,
    re-rank and read-back spans (ns; the read-back's device entry only,
    its first read returning 10 ns after D1)."""
    return [_span("service.batch", root, None, root, (h0, h3), (None, None)),
            _span("index.hash", root + 5, root, root, (h0, h0 + 1),
                  (None, None)),
            _span("index.scan", root + 6, root, root, (h0, h0 + 1),
                  (None, None)),
            _span("index.merge", root + 1, root, root, (h0, h0 + 1), merge),
            _span("index.union", root + 2, root, root, (h0, h0 + 1), union),
            _span("index.rerank", root + 3, root, root, (h0, h0 + 1),
                  rerank),
            _span("index.readback", root + 4, root, root, (d1 - 50, h3),
                  (d1, None), counts, {"first_read": d1 + 10})]


def _session():
    # an earlier profiler try's batch, then the segment's two
    stale = _batch(1, -900, -100, (-800, -200), (0, 0), (0, 0), -150,
                   {"reads": 99, "candidates": 7})
    one = _batch(10, 0, 1000, (200, 400), (400, 450), (450, 550), 600,
                 {"reads": 6, "candidates": 100})
    two = _batch(20, 1100, 2000, (1300, 1500), (1500, 1550), (1550, 1650),
                 1800, {"reads": 6, "candidates": 120})
    return SimpleNamespace(device=True, dropped=0, spans=stale + one + two)


def _ctx():
    return {"profile": {"busy_s": BUSY_NS * 1e-9},
            "phases": {"traced": {"batches": 2, "candidates": 220}},
            "shape": SHAPE, "costs": costs}


def _expected():
    w = 2000
    merge = costs.merge_bound(SHAPE["n"], 1, SHAPE["b"], SHAPE["l"])
    return {
        "idle_issue_share": 100 * (600 + 700 - BUSY_NS) / w,
        "idle_readback_share": 100 * (400 + 200) / w,
        "idle_client_share": 100 * 100 / w,
        "merge_wall_roofline": 100 * 2 * merge.seconds / 400e-9,
        "rerank_wall_roofline": 100 * costs.rerank_bound(
            220, SHAPE["d"]).seconds / 300e-9,
        "device_reads_per_batch": 6.0}


@pytest.mark.parametrize("metric", METRICS)
def test_reader_exact_on_a_synthetic_session(metric, monkeypatch):
    monkeypatch.setattr(spans, "last_session", _session)
    got = spec.metric_module(metric).read(_ctx())
    assert got == pytest.approx(_expected()[metric], rel=1e-12)


def test_the_idle_shares_sum_to_the_idle_time_of_the_window(monkeypatch):
    """Where each batch's host end follows its device work, the three
    shares add up to 1 - busy / (span window)."""
    monkeypatch.setattr(spans, "last_session", _session)
    total = sum(spec.metric_module(m).read(_ctx()) for m in METRICS[:3])
    assert total == pytest.approx(100 * (1 - BUSY_NS / 2000))


@pytest.mark.parametrize("metric", METRICS)
def test_reader_none_without_a_session(metric, monkeypatch):
    monkeypatch.setattr(spans, "last_session", lambda: None)
    assert spec.metric_module(metric).read(_ctx()) is None
    no_device = _session()
    no_device.device = False
    monkeypatch.setattr(spans, "last_session", lambda: no_device)
    assert spec.metric_module(metric).read(_ctx()) is None
    short = _ctx()
    short["phases"]["traced"]["batches"] = 4     # more than the session has
    monkeypatch.setattr(spans, "last_session", _session)
    assert spec.metric_module(metric).read(short) is None


def test_a_program_without_the_tracer_gives_none(monkeypatch):
    import repro_torch.utils
    monkeypatch.setitem(sys.modules, "repro_torch.utils.trace", None)
    monkeypatch.delattr(repro_torch.utils, "trace", raising=False)
    assert spans.last_session() is None
    assert all(spec.metric_module(m).read(_ctx()) is None for m in METRICS)


def test_the_cpu_session_has_no_device_times():
    """The program's real spans on the CPU: the session has every micro-
    batch, and the readers, finding no device times, give None."""
    from repro_torch.core.indexer import IndexConfig
    from repro_torch.serving.multi_table import MultiTableIndex
    from repro_torch.serving.service import HashQueryService
    from repro_torch.utils import trace
    rng = np.random.default_rng(0)
    x = rng.normal(size=(800, 17)).astype(np.float32)
    index = MultiTableIndex(IndexConfig(method="bh", bits=16, tables=1,
                                        batch=4, seed=5),
                            device="cpu").fit(x)
    svc = HashQueryService(index, mode="scan", scan_l=16, max_batch=4)
    with trace.session() as sess:
        svc.query_batch(rng.normal(size=(8, 17)).astype(np.float32))
    assert spans.last_session() is sess and not sess.device
    roots = [s for s in sess.spans if s.name == spans.ROOT]
    assert len(roots) == 2
    ctx = _ctx()
    assert all(spec.metric_module(m).read(ctx) is None for m in METRICS)


def test_a_session_that_dropped_spans_gives_none(monkeypatch):
    capped = _session()
    capped.dropped = 1
    monkeypatch.setattr(spans, "last_session", lambda: capped)
    assert spans.batches(_ctx()) is None
    assert all(spec.metric_module(m).read(_ctx()) is None for m in METRICS)


def test_clock_check_on_a_synthetic_session(monkeypatch):
    """H0 <= D1 <= H2 + slack per batch: counted exactly, and a batch
    whose D1 falls outside either side is a violation."""
    monkeypatch.setattr(spans, "last_session", _session)
    bs = spans.batches(_ctx())
    assert [b["h2"] for b in bs] == [610, 1810]
    assert spans.clock_check(bs) == {
        "batches": 2, "violations": 0, "unmarked": 0,
        "min_d1_minus_h0_ns": 600, "min_h2_minus_d1_ns": 10}
    bs[0]["h2"] = 600 - spans.CLOCK_SLACK_NS - 1     # D1 after H2 + slack
    bs[1]["d1"] = 1099                               # D1 before H0
    got = spans.clock_check(bs)
    assert got["violations"] == 2 and got["min_d1_minus_h0_ns"] == -1
    bs[0]["h2"] = None
    assert spans.clock_check(bs)["unmarked"] == 1


def test_span_check_reads_a_traced_run(monkeypatch):
    """``tools/span_check.checks`` on a synthetic run: every check holds,
    and a run missing a metric or with a count off fails."""
    from perfbench.tools import span_check
    monkeypatch.setattr(spans, "last_session", _session)
    ctx = _ctx()
    values = {m: spec.metric_module(m).read(ctx) for m in METRICS}
    values["device_idle_share"] = sum(values[m] for m in METRICS[:3]) + 1.5
    values["merge_roofline"] = values["merge_wall_roofline"] * 1.25
    result = {"metrics": {k: {"value": v} for k, v in values.items()}}
    got = span_check.checks(result, ctx)
    # the session holds an earlier profiler try's root besides the two
    assert got["roots"] == 3 and not got["ok"]
    monkeypatch.setattr(spans, "last_session", lambda: SimpleNamespace(
        device=True, dropped=0, spans=_session().spans[7:]))
    got = span_check.checks(result, ctx)
    assert got["ok"] and got["roots"] == 2 and got["candidates"] == 220
    assert got["clock"]["violations"] == 0
    del result["metrics"]["idle_client_share"]
    assert span_check.checks(result, ctx)["missing"] == [
        "idle_client_share"]
    assert not span_check.checks(result, ctx)["ok"]
