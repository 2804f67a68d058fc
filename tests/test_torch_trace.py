"""The port's spans (``repro_torch.utils.trace``) on the scan path, on the
CPU: nothing records without a session or a profiler; under either, a
scan-mode ``query_batch`` records the seven spans of each micro-batch with
the right parents, one batch id per micro-batch and host times nested
without overlap; the profiler flag the tracer reads is torch's; no
profiler event is the program's; answers are identical with tracing on
and off; the scan path's device events (five a batch, stand-ins on the
CPU) are resolved onto the host clock from the anchor; a service's
stats hold its own spans and wait for nothing; threads keep their own
stacks; spans given a card take that card's stream and are placed by that
card's own anchor (a fake clock per card).  Device times themselves need the card
(``perfbench/run.py --trace 1``)."""
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core.indexer import IndexConfig  # noqa: E402
from repro_torch.serving.multi_table import MultiTableIndex  # noqa: E402
from repro_torch.serving.service import HashQueryService  # noqa: E402
from repro_torch.utils import trace  # noqa: E402

MAX_BATCH = 8
CHILDREN = ("index.hash", "index.scan", "index.merge", "index.union",
            "index.rerank", "index.readback")
SPANS = ("service.batch",) + CHILDREN


@pytest.fixture(scope="module")
def service():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 33)).astype(np.float32)
    idx = MultiTableIndex(IndexConfig(method="bh", bits=20, tables=2,
                                      batch=MAX_BATCH, seed=3),
                          device="cpu").fit(x)
    return HashQueryService(idx, mode="scan", scan_l=32,
                            max_batch=MAX_BATCH)


@pytest.fixture(scope="module")
def ws():
    # 20 queries: micro-batches of 8, 8 and 4
    return np.random.default_rng(1).normal(size=(20, 33)).astype(np.float32)


def _same(a, b):
    return all(r.index == s.index and r.margin == s.margin
               and np.array_equal(r.candidates, s.candidates)
               and r.nonempty == s.nonempty for r, s in zip(a, b)) and \
        len(a) == len(b)


def test_nothing_records_without_a_session_or_a_profiler(service, ws):
    assert not torch.autograd.profiler._is_profiler_enabled
    before = trace.last_session()
    n = None if before is None else len(before.spans)
    service.query_batch(ws)
    after = trace.last_session()
    assert after is before
    assert n is None or len(after.spans) == n
    assert trace.root("service.batch") is trace.OFF
    assert trace.span("index.hash", entry=True, exit=True) is trace.OFF
    trace.add("reads")      # no open span: nothing to count into
    trace.mark("first_read")
    trace.anchor()


def _profiled(fn):
    """fn() under the profiler in a session of its own: a root span with
    the profiler closed ends the session an earlier profiler opened."""
    with trace.root("service.batch"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _record(how, service, ws):
    if how == "session":
        with trace.session() as sess:
            res = service.query_batch(ws)
        assert trace.last_session() is sess
    else:
        res, _ = _profiled(lambda: service.query_batch(ws))
        sess = trace.last_session()
    return res, sess


@pytest.mark.parametrize("how", ["session", "profiler"])
def test_a_scan_batch_records_the_seven_spans(how, service, ws):
    res, sess = _record(how, service, ws)
    assert not sess.device and sess.dropped == 0
    roots = [s for s in sess.spans if s.parent is None]
    assert [r.name for r in roots] == ["service.batch"] * 3
    assert len({r.batch for r in roots}) == 3
    assert all(r.batch == r.id for r in roots)
    sizes = [MAX_BATCH, MAX_BATCH, 4]
    for i, root in enumerate(roots):
        kids = [s for s in sess.spans if s.parent == root.id]
        assert tuple(k.name for k in kids) == CHILDREN
        assert all(k.batch == root.batch for k in kids)
        # host times nest in the root, children one after another
        assert root.host_start <= kids[0].host_start
        for a, b in zip(kids, kids[1:]):
            assert a.host_start <= a.host_end <= b.host_start
        assert kids[-1].host_end <= root.host_end
        assert all(k.device_start is None for k in kids)
        rb = kids[-1]
        first = sum(sizes[:i])
        assert rb.counts == {"reads": 1, "candidates": sum(
            r.candidates.size for r in res[first:first + sizes[i]])}
        assert rb.host_start <= rb.marks["first_read"] <= rb.host_end
        assert all(k.counts is None for k in kids[:-1])
    for a, b in zip(roots, roots[1:]):
        assert a.host_end <= b.host_start
    assert all(s.resolved for s in sess.spans)
    assert {s.name for s in sess.spans} == set(SPANS)
    assert len(sess.spans) == 3 * len(SPANS)


def test_the_profiler_flag_the_tracer_reads_is_torchs(monkeypatch):
    """The tracer reads ``torch.autograd.profiler._is_profiler_enabled``;
    a torch that renames it fails here."""
    import torch.autograd.profiler as tp
    assert tp._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert tp._is_profiler_enabled is True
    assert tp._is_profiler_enabled is False
    monkeypatch.setattr(tp, "_is_profiler_enabled", True)
    with trace.root("service.batch") as root:
        assert root is not trace.OFF
    monkeypatch.setattr(tp, "_is_profiler_enabled", False)
    assert trace.root("service.batch") is trace.OFF


def test_no_profiler_event_comes_from_the_program(service, ws):
    _, prof = _profiled(lambda: service.query_batch(ws))
    names = {e.name for e in prof.events()}
    assert names and not names & set(SPANS)
    assert not [n for n in names if n.startswith(("service.", "index."))]
    assert len(trace.last_session().spans) == 3 * len(SPANS)


def test_answers_are_identical_with_tracing_on_and_off(service, ws):
    off = service.query_batch(ws)
    with trace.session():
        on = service.query_batch(ws)
    prof, _ = _profiled(lambda: service.query_batch(ws))
    assert _same(off, on) and _same(off, prof)


def test_profiler_sessions_with_no_root_between_share_a_session():
    """A session opened under the profiler lasts until a root span finds
    the profiler closed."""
    def roots(n):
        for _ in range(n):
            with trace.root("service.batch"):
                pass
    _profiled(lambda: roots(2))
    first = trace.last_session()
    with profile(activities=[ProfilerActivity.CPU]):
        roots(1)
    assert trace.last_session() is first and len(first.spans) == 3
    _profiled(lambda: roots(1))
    assert trace.last_session() is not first
    assert len(trace.last_session().spans) == 1


def test_stats_summarise_the_last_session(service, ws, monkeypatch):
    """stats()["spans"] is this service's share of the last session,
    resolved when the session closed; reading it waits for nothing."""
    other = HashQueryService(service.index, mode="scan", scan_l=32,
                             max_batch=MAX_BATCH)
    with trace.session() as sess:
        service.query_batch(ws)
        other.query_batch(ws[:4])
    monkeypatch.setattr(torch.cuda, "synchronize", _no_wait)
    got = service.stats()["spans"]
    assert set(got) == set(SPANS)
    assert all(got[n]["count"] == 3 for n in SPANS)
    assert all(got[n]["device_wall_s"] is None for n in SPANS)
    assert got["index.readback"]["counts"]["reads"] == 3
    mine = [s for s in sess.spans if s.scope == id(service)]
    assert len(mine) == 3 * len(SPANS)
    roots = [s for s in mine if s.parent is None]
    kids_ns = sum(s.host_end - s.host_start for s in mine
                  if s.parent is not None)
    root_ns = sum(s.host_end - s.host_start for s in roots)
    assert got["service.batch"]["host_self_s"] == pytest.approx(
        1e-9 * (root_ns - kids_ns))
    assert all(got[n]["host_self_s"] >= 0 for n in SPANS)
    assert other.stats()["spans"]["service.batch"]["count"] == 1
    assert trace.summary(sess)["service.batch"]["count"] == 4
    assert len(service.latencies_s) <= service.latencies_s.maxlen == 65536


def _no_wait():
    raise AssertionError("waited for the device")


def test_children_inherit_the_root():
    """A root that records keeps its children recording after the session
    closes."""
    with trace.session() as sess:
        root = trace.root("service.batch")
        root.__enter__()
    with trace.span("index.hash"):
        trace.add("reads", 2)
    root.__exit__(None, None, None)
    assert [s.name for s in sess.spans] == ["service.batch", "index.hash"]
    assert sess.spans[1].parent == root.id
    assert sess.spans[1].counts == {"reads": 2}
    assert trace.root("service.batch") is trace.OFF


def test_a_second_session_inside_one_raises():
    with trace.session():
        with pytest.raises(RuntimeError):
            with trace.session():
                pass


class _Event:
    """A CUDA event's stand-in: ``record`` takes the next instant of a fake
    device clock (ms), ``elapsed_time`` the signed difference."""

    clock = iter(range(10**9))

    def __init__(self, enable_timing=True):
        self.ms = None
        self.records = 0

    def record(self, stream=None):
        self.ms = 100.0 + 0.25 * next(_Event.clock)
        self.records += 1

    def elapsed_time(self, other):
        return other.ms - self.ms


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA as the tracer sees it, with stand-in events and streams: every
    event recorded is kept, in order."""
    made = []

    def event(enable_timing=True):
        e = _Event()
        made.append(e)
        return e
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(trace._tracer, "pool", [])
    return made


def test_the_scan_path_records_five_device_events_a_batch(service, ws,
                                                          fake_cuda):
    """Roots, the hash and the scan are host-only; the merge and the union
    record entry and exit, the re-rank's entry is the union's exit, the
    read-back's entry the re-rank's exit; the first read-back takes the
    session's anchor."""
    with trace.session() as sess:
        res = service.query_batch(ws)
    assert sess.device and len(sess.spans) == 3 * len(SPANS)
    # 5 events a batch and the anchor, all taken from the pool after the
    # first batch's resolution returned nothing yet: 3 x 5 + 1 made
    assert len(fake_cuda) == 3 * 5 + 1
    assert all(e.records == 1 for e in fake_cuda)
    anchor = sess.anchor[0]
    assert anchor is fake_cuda[5]       # recorded in the first read-back
    by = {}
    for s in sess.spans:
        by.setdefault(s.batch, {})[s.name] = s
    for spans_ in by.values():
        for name in ("service.batch", "index.hash", "index.scan"):
            assert spans_[name].device_start is None
            assert spans_[name].device_end is None
        m, u, r, rb = (spans_[n] for n in ("index.merge", "index.union",
                                           "index.rerank", "index.readback"))
        assert m.device_start < m.device_end <= u.device_start
        assert u.device_start < u.device_end == r.device_start
        assert r.device_start < r.device_end == rb.device_start
        assert rb.device_end is None
    rb0 = sess.spans[len(SPANS) - 1]
    assert rb0.name == "index.readback"
    assert sess.anchor[1] >= rb0.marks["first_read"]
    # on the fake clock, an event's device time is the anchor's host time
    # plus its ms after the anchor
    m0 = sess.spans[3]
    assert m0.name == "index.merge"
    assert m0.device_start == sess.anchor[1] + round(1e6 * (
        fake_cuda[0].ms - anchor.ms)) < sess.anchor[1]
    assert len(trace._tracer.pool) == 3 * 5
    assert _same(res, service.query_batch(ws))


def test_device_times_are_placed_on_the_host_clock(monkeypatch):
    """Resolving turns each closed span's events into host-clock ns (the
    anchor's host time plus the event's time after it, negative before
    it), leaves a span whose parent is open for later, and returns each
    event to the pool once, a shared one by the span that borrowed it."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "stream")
    monkeypatch.setattr(trace._tracer, "pool", [])
    sess = trace.Session()
    sess.started = sess.device = True
    anchor = _Event()
    anchor.ms = 100.0
    sess.anchor = (anchor, 5_000_000)

    def ev(ms):
        e = _Event()
        e.ms = ms
        return e
    root = trace.Span("service.batch", sess, None)
    union = trace.Span("index.union", sess, root)
    rerank = trace.Span("index.rerank", sess, root)
    root.host_start, root.host_end = 0, 10
    union.host_start, union.host_end = 1, 2
    rerank.host_start, rerank.host_end = 3, 4
    shared = ev(100.75)
    union._e0, union._e1, union._own0 = ev(99.5), shared, True
    rerank._e0, rerank._e1 = shared, ev(102.0)
    rerank._own0 = rerank._own1 = True
    late = trace.Span("service.batch", sess, None)
    late.host_start = 20
    kid = trace.Span("index.union", sess, late)
    kid.host_start, kid.host_end = 21, 22
    kid._e0, kid._own0 = ev(103.0), True
    sess.spans = [root, union, rerank, late, kid]
    monkeypatch.setattr(trace._tracer, "last", sess)
    assert trace.last_session() is sess
    assert (union.device_start, union.device_end) == (4_500_000, 5_750_000)
    assert (rerank.device_start, rerank.device_end) == (5_750_000,
                                                        7_000_000)
    assert root.device_start is None and root.resolved
    assert not kid.resolved and kid.device_start is None
    assert sess._resolved == 3
    assert sorted(e.ms for e in trace._tracer.pool) == [99.5, 100.75, 102.0]
    got = trace.summary(sess)
    assert got["index.union"]["device_wall_s"] == pytest.approx(1.25e-3)
    assert got["index.rerank"]["device_wall_s"] == pytest.approx(1.25e-3)
    assert got["service.batch"]["device_wall_s"] is None
    assert got["service.batch"]["host_self_s"] == pytest.approx(8e-9)
    late.host_end = 30
    trace.last_session()
    assert kid.device_start == 8_000_000 and sess._resolved == 5
    assert trace.summary(sess)["service.batch"]["count"] == 2


def test_a_span_outside_a_root_records_nothing(service, ws):
    """The index layer called without the service opens no spans of its
    own, under a session too."""
    with trace.session() as sess:
        assert trace.span("index.scan") is trace.OFF
        service.index.query_scan_batch(ws[:4], l=32)
    assert sess.spans == []


def test_threads_keep_their_own_stacks():
    """Many threads open roots and children in one session at once, with a
    short switch interval: every span is kept, ids are unique, and each
    child's parent is its own thread's root."""
    threads, per = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def work(k):
        try:
            for _ in range(per):
                with trace.root("service.batch") as root:
                    with trace.span("index.hash") as child:
                        trace.add("thread", k)
                    assert child.parent == root.id
                    assert child.batch == root.batch
        except AssertionError as e:
            errors.append(e)

    try:
        with trace.session() as sess:
            ts = [threading.Thread(target=work, args=(k,))
                  for k in range(threads)]
            for t in ts:
                t.start()
            deadline = time.monotonic() + 60
            for t in ts:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert len(sess.spans) == 2 * threads * per
    assert len({s.id for s in sess.spans}) == len(sess.spans)
    by_id = {s.id: s for s in sess.spans}
    kids = [s for s in sess.spans if s.parent is not None]
    assert len(kids) == threads * per
    assert all(by_id[s.parent].name == "service.batch" for s in kids)
    per_thread = {}
    for s in kids:
        per_thread[s.counts["thread"]] = per_thread.get(
            s.counts["thread"], 0) + 1
    assert per_thread == {k: per for k in range(threads)}


def test_a_session_keeps_at_most_max_spans(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with trace.session() as sess:
        for _ in range(2):
            with trace.root("service.batch"):
                with trace.span("index.hash"):
                    pass
    assert [s.name for s in sess.spans] == ["service.batch", "index.hash",
                                            "service.batch"]
    assert sess.dropped == 1
    assert trace.summary(sess)["index.hash"]["count"] == 1


class _Stream:
    """A CUDA stream's stand-in: one per device index."""

    def __init__(self, index):
        self.device = torch.device("cuda", index)


@pytest.fixture
def fake_cards(monkeypatch):
    """Three cards as the tracer sees them: a stream each, and events on a
    fake clock of each card's own, card i's running 1,000 i ms ahead (no
    two cards' clocks agree).  Returns (every event made, the devices
    synchronised)."""
    streams = {i: _Stream(i) for i in range(3)}
    made, synced = [], []
    tick = iter(range(10**9))

    class Event(_Event):
        def record(self, stream=None):
            self.card = stream.device.index
            self.ms = 1000.0 * self.card + 0.25 * next(tick)
            self.records += 1

        def elapsed_time(self, other):
            assert other.card == self.card, "events of two cards compared"
            return other.ms - self.ms

    def event(enable_timing=True):
        e = Event()
        made.append(e)
        return e

    def current_stream(device=None):
        return streams[0 if device is None else torch.device(device).index]

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(trace._tracer, "pool", [])
    monkeypatch.setattr(trace._tracer, "pools", {})
    return made, synced


def test_each_card_takes_its_own_anchor(fake_cards):
    """Spans given ``device=`` record on that card's stream and are placed
    on the host clock by that card's anchor, taken where the program says
    its work is done (card 1) or when the session is resolved after
    waiting for the card (card 2); a span given the roots' own card shares
    the roots' anchor, taken at the blocking read; the events go back to
    each card's own pool; and the totals add every card's wall."""
    made, synced = fake_cards
    with trace.session() as sess:
        for _ in range(2):
            with trace.root("service.batch"):
                with trace.span("index.exchange", entry=True, exit=True,
                                device="cuda:0") as ex:
                    pass
                for card in (1, 2):
                    with trace.span("index.shard_select", entry=True,
                                    exit=True, device=f"cuda:{card}"):
                        trace.add("candidates", card)
                with trace.span("index.readback", entry=ex):
                    trace.anchor()
                    trace.anchor("cuda:1")      # card 1's work is done
                    trace.anchor("cuda:0")      # the roots' own: no-op
                    trace.anchor("cpu")
                card1 = sess.anchors[1][0]
    assert sess.device and set(sess.anchors) == {1, 2}
    assert sess.anchor[0].card == 0
    assert sess.anchors[1][0] is card1 and 1 not in synced[:1]
    assert {1, 2} <= set(synced)
    by_card = {}
    for s in sess.spans:
        if s.name == "index.shard_select":
            assert s.device == torch.device("cuda", int(s.counts[
                "candidates"]))
            by_card.setdefault(s.device.index, []).append(s)
    for card, spans_ in by_card.items():
        ev, host = sess.anchors[card]
        assert ev.card == card
        for s in spans_:
            assert s.device_start < s.device_end
        # card 1's anchor lies between its two batches' spans, card 2's
        # after both
        first, second = spans_
        assert first.device_end < host
        assert (second.device_start > host) == (card == 1)
    ex0 = sess.spans[1]
    assert ex0.name == "index.exchange" and ex0.device == torch.device(
        "cuda", 0)
    assert ex0.device_end <= sess.anchor[1]
    # 4 events for each card's two spans, 2 exchange events each batch
    # (the read-back borrows one), three anchors
    assert len(made) == 2 * (2 + 2 + 2) + 3
    assert sorted(len(p) for p in trace._tracer.pools.values()) == [4, 4]
    assert len(trace._tracer.pool) == 4
    assert all(e.card == k for k, p in trace._tracer.pools.items()
               for e in p)
    got = trace.summary(sess)
    walls = sum(s.device_end - s.device_start for s in sess.spans
                if s.name == "index.shard_select")
    assert got["index.shard_select"]["count"] == 4
    assert got["index.shard_select"]["device_wall_s"] == pytest.approx(
        1e-9 * walls)
    assert got["index.shard_select"]["counts"] == {"candidates": 6}


def test_card_spans_are_placed_by_their_cards_anchor(monkeypatch):
    """Resolving places an event of card k at card k's anchor's host time
    plus its ms after that anchor; the roots' anchor places the others;
    a later resolve waits for each card again and reuses its anchor."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: "stream")
    monkeypatch.setattr(trace._tracer, "pool", [])
    monkeypatch.setattr(trace._tracer, "pools", {})
    sess = trace.Session()
    sess.started = sess.device = True

    def ev(ms):
        e = _Event()
        e.ms = ms
        return e
    sess.anchor = (ev(100.0), 5_000_000)
    sess.anchors = {3: (ev(7_000.0), 9_000_000)}
    root = trace.Span("service.batch", sess, None)
    root.host_start, root.host_end = 0, 10
    own = trace.Span("index.union", sess, root)
    card = trace.Span("index.shard_select", sess, root)
    card._key, card.device = 3, torch.device("cuda", 3)
    own.host_start, own.host_end = 1, 2
    card.host_start, card.host_end = 3, 4
    own._e0, own._e1, own._own0, own._own1 = ev(99.0), ev(101.0), True, True
    card._e0, card._e1 = ev(6_999.5), ev(7_001.25)
    card._own0 = card._own1 = True
    sess.spans = [root, own, card]
    monkeypatch.setattr(trace._tracer, "last", sess)
    trace.last_session()
    assert (own.device_start, own.device_end) == (4_000_000, 6_000_000)
    assert (card.device_start, card.device_end) == (8_500_000, 10_250_000)
    assert synced == [None, 3]
    assert len(trace._tracer.pool) == 2 and len(trace._tracer.pools[3]) == 2
    assert trace.summary(sess)["index.shard_select"]["device_wall_s"] == \
        pytest.approx(1.75e-3)
