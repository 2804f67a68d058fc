"""The program's own spans in the traced segment, per micro-batch, for the
readers of ``program_span`` and ``program_counter`` metrics.

The program records spans (``repro_torch.utils.trace``) while the
profiler is open, so the traced segment is the last trace session of the
run's process.  Its ``service.batch`` roots are the segment's
micro-batches; if the profiler was tried more than once, the session
holds every try's and the last ``batches`` of them are the segment's.
Every time is ns on the host's clock; device times are the program's
CUDA events, placed on that clock by the session's anchor.

A program without spans, a session without device times (the CPU), one
that dropped spans past its cap or one that lacks a micro-batch of the
segment gives None: the metric is then left out of the result line.
``clock_check`` holds the device times to the host's own clock;
``perfbench/tools/span_check.py`` applies it to a traced run.
"""
from __future__ import annotations

ROOT = "service.batch"
READBACK = "index.readback"
FIRST_READ = "first_read"
CLOCK_SLACK_NS = 20_000     # D1 may pass H2 by this much (the anchor's error)


def last_session():
    """The program's last trace session, or None (none, or no tracer)."""
    try:
        from repro_torch.utils import trace
    except ImportError:
        return None
    return trace.last_session()


def batches(ctx) -> list[dict] | None:
    """The traced segment's micro-batches in order, each {"h0": root's host
    start, "h3": its host end, "d1": the device time of the read-back's
    entry event (all of the batch's device work done before it), "h2":
    the host time the read-back's first blocking read returned (its mark
    ``first_read``; None without it), "wall": {span name: device end -
    start, for the spans that record both}, "counts": {key: summed
    counts}}, or None."""
    sess = last_session()
    n = ctx["phases"]["traced"]["batches"]
    if sess is None or not sess.device or sess.dropped or n <= 0:
        return None
    roots = [s for s in sess.spans if s.name == ROOT and s.parent is None
             and s.host_end is not None]
    if len(roots) < n:
        return None
    out = {r.batch: {"h0": r.host_start, "h3": r.host_end, "d1": None,
                     "h2": None, "wall": {}, "counts": {}}
           for r in roots[-n:]}
    for s in sess.spans:
        b = out.get(s.batch)
        if b is None or s.parent is None:
            continue
        if s.device_start is not None and s.device_end is not None:
            b["wall"][s.name] = (b["wall"].get(s.name, 0)
                                 + s.device_end - s.device_start)
        for k, v in (s.counts or {}).items():
            b["counts"][k] = b["counts"].get(k, 0) + v
        if s.name == READBACK:
            b["d1"] = s.device_start
            b["h2"] = (s.marks or {}).get(FIRST_READ)
    if any(b["d1"] is None for b in out.values()):
        return None
    return [out[r.batch] for r in roots[-n:]]


def clock_check(bs: list[dict], slack_ns: int = CLOCK_SLACK_NS) -> dict:
    """Whether the device times sit on the host clock: for each batch, H0
    <= D1 (the device cannot finish the batch's work before the host
    began it) and D1 <= H2 + slack (the first blocking read returned
    after the device finished).  {"batches", "violations", "unmarked"
    (batches with no H2), "min_d1_minus_h0_ns", "min_h2_minus_d1_ns"}."""
    marked = [b for b in bs if b["h2"] is not None]
    bad = sum(1 for b in bs if b["d1"] < b["h0"]) + sum(
        1 for b in marked if b["d1"] > b["h2"] + slack_ns)
    return {"batches": len(bs), "violations": bad,
            "unmarked": len(bs) - len(marked),
            "min_d1_minus_h0_ns": min(b["d1"] - b["h0"] for b in bs),
            "min_h2_minus_d1_ns": (min(b["h2"] - b["d1"] for b in marked)
                                   if marked else None)}


def window_ns(bs: list[dict]) -> int:
    """The span window: the first batch's host start to the last's end."""
    return bs[-1]["h3"] - bs[0]["h0"]


def total(bs: list[dict], kind: str, key: str) -> int:
    """The sum over the batches of ``b[kind][key]`` (0 where absent)."""
    return sum(b[kind].get(key, 0) for b in bs)
