"""Spans at the layer boundaries of the query path, on one clock with the
device.

``root(name)`` opens the span of one unit of work (a micro-batch) and
``span(name)`` a span inside the calling thread's innermost open span;
both are context managers.  A recorded span keeps its name, its own id,
its parent's id, the id of its micro-batch (the root's id, shared by
every span under one root) and its host start and end
(``time.perf_counter_ns``).  ``add(key, n)`` adds a count to the
innermost open span of the calling thread, and ``mark(name)`` the host
time of an instant inside it.  Each thread has its own stack of open
spans.

Device times are opt-in: ``span(name, entry=True, exit=True)`` records a
CUDA timing event at entry and at exit, on the stream that was current
when its root opened, or with ``device=`` on that device's current stream
(a span of one card's work in a program that drives several);
``entry=<a closed sibling>`` takes that sibling's exit event as its own
entry event (the caller enqueues no device work between them).  Roots
record none.  The events come from a pool and nothing waits on them on
the hot path.

Spans record inside ``session()`` and while a ``torch.profiler`` session
is open.  The check is made once per root and its children inherit it;
off, a root is one shared object that does nothing, and so is a span
with no open root (so a layer called outside a root opens none).  A
session opened under the profiler lasts until a root finds the profiler
closed, so two profiler sessions with no root between them share one.
The spans are not profiler ranges: the profiler would draw a range on
the device's timeline too, where it would be taken for device work.

One clock: a session takes one anchor for each device its events are on,
an event on that device's clock and the host time at which the device
reached it (two devices' events cannot be compared with each other).
``anchor()``, called where the program has just waited for a stream (the
first blocking read of a micro-batch's answers), records the anchor of
the innermost span's device, or of a device it names whose work the
program knows is done, with no further wait, once a session; a device
without one takes it when the session is resolved, after waiting for
that device.  Resolving (at the end of ``session()``, and in
``last_session()``) waits for the devices once and places every event of
the closed spans on the host clock: its device's anchor's host time plus
the event's time after that anchor (negative before it).  The same pass adds
each span into the session's totals, which ``summary`` reads without
waiting for anything.

>>> with trace.session():
...     service.query_batch(ws)
>>> summary(trace.last_session())["index.merge"]["device_wall_s"]
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 1 << 20     # a session records no more; later ones are dropped
POOL_MAX = 1 << 16      # resolved events kept for reuse


class Session:
    """The spans of one session, in the order they opened.  ``device``:
    whether its spans may carry device times (CUDA was initialised when
    it started); ``dropped``: spans not recorded past ``MAX_SPANS``;
    ``anchor``: (event, host ns) once taken, for the roots' streams;
    ``anchors``: {device index: (event, host ns)} for the other devices
    that spans given ``device=`` recorded on."""

    def __init__(self):
        self.spans: list[Span] = []
        self.dropped = 0
        self.device = False
        self.started = False
        self.anchor: tuple | None = None
        self.anchors: dict = {}
        self.totals: dict = {}   # (scope, name) -> sums over resolved spans
        self._resolved = 0       # spans before this index are resolved

    def start(self) -> None:
        self.device = torch.cuda.is_initialized()
        self.started = True

    def resolve(self) -> None:
        """Resolve every closed span whose parent has closed too, not yet
        resolved: device times on the host clock (waiting for the device
        once), then the totals; return the events to the pool."""
        todo = [s for s in self.spans[self._resolved:]
                if s.host_end is not None and not s.resolved
                and (s._up is None or s._up.host_end is not None)]
        timed = [s for s in todo if s._e0 is not None or s._e1 is not None]
        if timed:
            torch.cuda.synchronize()
            streams = {}        # a stream of each anchor key's spans
            for s in timed:
                streams.setdefault(s._key, s._stream)
            if None in streams and self.anchor is None:
                self.anchor = _take_anchor(streams[None])
            for key, stream in streams.items():
                if key is not None:
                    torch.cuda.synchronize(key)
                    if key not in self.anchors:
                        self.anchors[key] = _take_anchor(stream)

            def at(s, ev):
                anchor, anchor_ns = (self.anchor if s._key is None
                                     else self.anchors[s._key])
                return anchor_ns + round(1e6 * anchor.elapsed_time(ev))
            for s in timed:
                if s._e0 is not None:
                    s.device_start = at(s, s._e0)
                if s._e1 is not None:
                    s.device_end = at(s, s._e1)
        free = []
        for s in todo:
            self._add(s)
            if s._own0:
                free.append((s._key, s._e0))
            if s._own1:
                free.append((s._key, s._e1))
            s._e0 = s._e1 = None
            s.resolved = True
        _tracer.release(free)
        spans, i = self.spans, self._resolved
        while i < len(spans) and spans[i].resolved:
            i += 1
        self._resolved = i

    def _add(self, s: Span) -> None:
        """Add a resolved span into the totals: its count, host time less
        its direct children's (each child takes its time off its
        parent's), device wall and counts."""
        t = self._total(s.scope, s.name)
        host = s.host_end - s.host_start
        t["count"] += 1
        t["host_self_ns"] += host
        if s._up is not None:
            self._total(s.scope, s._up.name)["host_self_ns"] -= host
        if s.device_start is not None and s.device_end is not None:
            t["device_wall_ns"] = ((t["device_wall_ns"] or 0)
                                   + s.device_end - s.device_start)
        for k, v in (s.counts or {}).items():
            t["counts"][k] = t["counts"].get(k, 0) + v

    def _total(self, scope, name: str) -> dict:
        t = self.totals.get((scope, name))
        if t is None:
            t = self.totals[(scope, name)] = {
                "count": 0, "host_self_ns": 0, "device_wall_ns": None,
                "counts": {}}
        return t


def _take_anchor(stream) -> tuple:
    """(event, host ns): an event recorded on ``stream``, which the caller
    has just waited for, and the host time."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev, time.perf_counter_ns()


class Span:
    """One recorded span; its own context manager.  Times are ns on the
    host clock; ``device_start`` / ``device_end`` are None until resolved,
    and stay None where the span records no event (and off CUDA).
    ``scope``: its root's, which a summary can select.  ``device``: the
    device it was given (``span(..., device=)``, inherited by its
    children), None on its root's stream."""

    __slots__ = ("name", "id", "parent", "batch", "scope", "device",
                 "host_start", "host_end", "device_start", "device_end",
                 "counts", "marks", "resolved", "_up", "_session",
                 "_stream", "_key", "_entry", "_exit", "_e0", "_e1",
                 "_own0", "_own1")

    def __init__(self, name: str, session: Session, parent: Span | None,
                 scope=None, entry=False, exit=False, device=None):
        self.name = name
        self.id = next(_tracer.ids)
        self._up = parent
        # _key: the anchor of this span's events, None for the roots'
        # streams, else its device's index
        self._key = None
        if parent is None:
            self.parent, self.batch, self.scope = None, self.id, scope
            self.device = None
            self._stream = (torch.cuda.current_stream() if session.device
                            else None)
        else:
            self.parent, self.batch = parent.id, parent.batch
            self.scope, self._stream = parent.scope, parent._stream
            self._key, self.device = parent._key, parent.device
            if device is not None:
                self.device = device = torch.device(device)
                self._stream = self._key = None
                if session.device and device.type == "cuda":
                    root = _root_stream(parent)
                    self._stream = torch.cuda.current_stream(device)
                    if self._stream != root:
                        self._key = self._stream.device.index
        self.host_start = self.host_end = None
        self.device_start = self.device_end = None
        self.counts: dict | None = None
        self.marks: dict | None = None
        self.resolved = False
        self._session = session
        self._entry, self._exit = entry, exit and self._stream is not None
        self._e0 = self._e1 = None
        self._own0 = self._own1 = False

    def __enter__(self):
        _local.stack.append(self)
        self.host_start = time.perf_counter_ns()
        entry = self._entry
        if entry is True:
            if self._stream is not None:
                self._e0 = _tracer.event(self._key)
                self._e0.record(self._stream)
                self._own0 = True
        elif isinstance(entry, Span) and entry._e1 is not None:
            # the sibling's exit event is this span's entry; this span
            # returns it to the pool, after both are resolved
            self._e0, self._own0 = entry._e1, entry._own1
            entry._own1 = False
        return self

    def __exit__(self, *exc) -> bool:
        if self._exit:
            self._e1 = _tracer.event(self._key)
            self._e1.record(self._stream)
            self._own1 = True
        self.host_end = time.perf_counter_ns()
        _local.stack.pop()
        return False


def _root_stream(span: Span):
    while span._up is not None:
        span = span._up
    return span._stream


class _Off:
    """The span of a root that does not record, shared by every such call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class _Local(threading.local):
    def __init__(self):
        self.stack: list[Span] = []


_local = _Local()       # each thread's stack of open spans


class _Tracer:
    """The process's sessions, the event pools and the span ids.  An
    event stays on the device it was first recorded on: ``pool`` keeps
    the roots' streams' events, ``pools`` the other devices' by index."""

    def __init__(self):
        self.ids = itertools.count(1)
        self.lock = threading.Lock()
        self.explicit: Session | None = None    # session() in force
        self.profiled: Session | None = None    # opened under the profiler
        self.last: Session | None = None
        self.pool: list = []
        self.pools: dict = {}

    def root(self, name: str, scope):
        """A root span, once ``root`` found that a session records."""
        sess = self.explicit or self.profiled
        if sess is None or not sess.started:
            with self.lock:
                if self.explicit is None and self.profiled is None:
                    self.profiled = self.last = Session()
                sess = self.explicit or self.profiled
                if not sess.started:
                    sess.start()
        return self.open(name, sess, None, scope)

    def open(self, name: str, sess: Session, parent: Span | None,
             scope=None, entry=False, exit=False, device=None):
        if len(sess.spans) >= MAX_SPANS:
            sess.dropped += 1
            return OFF
        s = Span(name, sess, parent, scope, entry, exit, device)
        sess.spans.append(s)
        return s

    def _pool(self, key) -> list:
        return self.pool if key is None else self.pools.setdefault(key, [])

    def event(self, key=None):
        try:
            return self._pool(key).pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def release(self, events: list) -> None:
        """Return (anchor key, event) pairs to their pools."""
        for key, ev in events:
            pool = self._pool(key)
            if len(pool) < POOL_MAX:
                pool.append(ev)


_tracer = _Tracer()


def root(name: str, scope=None):
    """A root span named ``name`` (host times only), or the shared ``OFF``
    when nothing records.  ``scope``: any hashable its spans carry into
    the totals (a service's own, so its summary leaves others' out)."""
    stack = _local.stack
    if stack:
        parent = stack[-1]
        return _tracer.open(name, parent._session, parent)
    # torch's own process-wide flag, set on a profiler's start and
    # cleared on its stop
    if _tracer.explicit is None and not _profiler._is_profiler_enabled:
        if _tracer.profiled is not None:
            _tracer.profiled = None
        return OFF
    return _tracer.root(name, scope)


def span(name: str, *, entry=False, exit: bool = False, device=None):
    """A span named ``name`` under the calling thread's innermost open
    span, or the shared ``OFF`` when none is open.  entry / exit: record
    a device event there; ``entry`` may instead be a closed sibling span,
    whose exit event then marks this span's entry.  device: the events go
    on that device's current stream (default: the parent's stream)."""
    stack = _local.stack
    if not stack:
        return OFF
    parent = stack[-1]
    return _tracer.open(name, parent._session, parent, None, entry, exit,
                        device)


def add(key: str, n: int = 1) -> None:
    """Add n to the count ``key`` of the calling thread's innermost open
    span (nothing when none is open)."""
    stack = _local.stack
    if stack:
        s = stack[-1]
        if s.counts is None:
            s.counts = {}
        s.counts[key] = s.counts.get(key, 0) + n


def mark(name: str) -> None:
    """Record the host time (ns) of the instant ``name`` in the calling
    thread's innermost open span (nothing when none is open)."""
    stack = _local.stack
    if stack:
        s = stack[-1]
        if s.marks is None:
            s.marks = {}
        s.marks[name] = time.perf_counter_ns()


def anchor(device=None) -> None:
    """Take the anchor of the innermost open span's device, or of
    ``device``, here, once a session: call it where that device's stream
    has no work left (the calling thread has just waited for it, or for
    work that followed all of it), so the device reaches the event as it
    is recorded.  Nothing when no span is open, off CUDA, or the session
    has that anchor."""
    stack = _local.stack
    if stack:
        s = stack[-1]
        sess = s._session
        stream, key = s._stream, s._key
        if device is not None and stream is not None:
            device = torch.device(device)
            if device.type != "cuda":
                return
            stream = torch.cuda.current_stream(device)
            key = (None if stream == _root_stream(s)
                   else stream.device.index)
        if stream is None:
            return
        if key is None:
            if sess.anchor is None:
                sess.anchor = _take_anchor(stream)
        elif key not in sess.anchors:
            sess.anchors[key] = _take_anchor(stream)


@contextlib.contextmanager
def session():
    """Record every root opened while the block runs, in any thread, into
    a new session, resolved when the block ends; it stays the last
    session after the block."""
    with _tracer.lock:
        if _tracer.explicit is not None:
            raise RuntimeError("a trace session is already open")
        sess = _tracer.explicit = _tracer.last = Session()
        _tracer.profiled = None
    try:
        yield sess
    finally:
        _tracer.explicit = None
        with _tracer.lock:
            sess.resolve()


def last_session(resolve: bool = True) -> Session | None:
    """The newest session, or None when no session has recorded; with
    ``resolve``, its closed spans resolved first (this waits for the
    device once where they have events)."""
    sess = _tracer.last
    if sess is not None and resolve:
        with _tracer.lock:      # one resolver: an event is released once
            sess.resolve()
    return sess


def summary(sess: Session | None, scope=None) -> dict:
    """Per span name, over the resolved spans of ``sess`` (of ``scope``
    alone where given): its count, host self time (its host time less its
    direct children's), device wall (device end - start; None where it
    records no events) and summed counts.  Reads the session's totals:
    waits for nothing."""
    out: dict = {}
    if sess is None:
        return out
    for (sc, name), t in list(sess.totals.items()):
        if scope is not None and sc != scope:
            continue
        o = out.setdefault(name, {"count": 0, "host_self_s": 0.0,
                                  "device_wall_s": None, "counts": {}})
        o["count"] += t["count"]
        o["host_self_s"] += 1e-9 * t["host_self_ns"]
        if t["device_wall_ns"] is not None:
            o["device_wall_s"] = ((o["device_wall_s"] or 0.0)
                                  + 1e-9 * t["device_wall_ns"])
        for k, v in t["counts"].items():
            o["counts"][k] = o["counts"].get(k, 0) + v
    return out
