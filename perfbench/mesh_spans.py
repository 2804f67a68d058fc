"""The program's per-card spans in the traced segment of a cell whose rows
are sharded over several devices, per micro-batch, for the readers of
its ``program_span`` and ``program_counter`` metrics.

The segment's micro-batches are its last ``service.batch`` roots, as in
``spans.batches``.  Under each, the program records, on each card,
``index.shard_select`` spans (its scan to its share of the top-l, counted
``candidates``) and ``index.shard_rerank`` spans, each span's device
times on the host clock by its own card's anchor, and, on the index's
card, ``index.exchange`` spans counting ``exchange_bytes``.  A span's
card is its ``device``.  A program without such spans, a session
without device times, or one that dropped spans gives None.
"""
from __future__ import annotations

from perfbench import spans

SELECT = "index.shard_select"
RERANK = "index.shard_rerank"
EXCHANGE = "index.exchange"


def batches(ctx) -> list[dict] | None:
    """The traced segment's micro-batches in order, each {"select": {card:
    [(device start, end), ...]}, "rerank": the same for the re-rank,
    "candidates": {card: summed count}, "exchange_bytes": summed count},
    or None where a batch has no timed shard-select span."""
    sess = spans.last_session()
    n = ctx["phases"]["traced"]["batches"]
    if sess is None or not sess.device or sess.dropped or n <= 0:
        return None
    roots = [s for s in sess.spans if s.name == spans.ROOT
             and s.parent is None and s.host_end is not None]
    if len(roots) < n:
        return None
    out = {r.batch: {"select": {}, "rerank": {}, "candidates": {},
                     "exchange_bytes": 0} for r in roots[-n:]}
    for s in sess.spans:
        b = out.get(s.batch)
        if b is None or s.parent is None:
            continue
        card = str(getattr(s, "device", None))
        counts = s.counts or {}
        if s.name == EXCHANGE:
            b["exchange_bytes"] += counts.get("exchange_bytes", 0)
        if s.name not in (SELECT, RERANK):
            continue
        if s.name == SELECT and "candidates" in counts:
            b["candidates"][card] = (b["candidates"].get(card, 0)
                                     + counts["candidates"])
        if s.device_start is not None and s.device_end is not None:
            kind = "select" if s.name == SELECT else "rerank"
            b[kind].setdefault(card, []).append((s.device_start,
                                                 s.device_end))
    got = [out[r.batch] for r in roots[-n:]]
    if any(not b["select"] for b in got):
        return None
    return got


def wall(intervals) -> int:
    """The summed length of a card's spans (ns)."""
    return sum(e - s for s, e in intervals)


def longest(per_card: dict) -> int:
    """The largest summed length of any card's spans (ns)."""
    return max((wall(v) for v in per_card.values()), default=0)
