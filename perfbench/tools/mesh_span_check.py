"""The checks of the per-card spans in traced runs of a row-sharded cell:
for each seed, one ``--trace 1`` run as ``perfbench/run.py`` makes it
(``span_check.traced_run``), then

- the clock check of every card: for every micro-batch of the traced
  segment, each device time of its ``index.shard_select``,
  ``index.shard_rerank`` and ``index.exchange`` spans, placed on the host
  clock by its own card's anchor, lies in [H0, H2 + 20 us], H0 the
  root's host start, H2 when the read-back's first blocking read
  returned (every card's work of the batch is done before it);
- ``spans.clock_check`` of the index's card (H0 <= D1 <= H2 + 20 us);
- the session's roots against the traced phase's ``batches``, the
  read-back spans' summed ``candidates`` against the phase's (the
  shard-select spans' own, the rows each card selected, are reported
  beside them).

    python3 perfbench/tools/mesh_span_check.py --workload <cell> \
        --seeds 1 2 3 [--seconds 20] [--out FILE]

One JSON line a seed on standard output (appended to FILE too), with the
run's metrics, its correct flag, each card's violations and the least
margins; exit 1 where a check fails.  Needs the cards.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import mesh_spans, spans  # noqa: E402
from perfbench.tools.span_check import traced_run  # noqa: E402

CARD_SPANS = ("index.shard_select", "index.shard_rerank", "index.exchange")


def _readback_candidates(sess, bs) -> int:
    """The read-back spans' summed ``candidates`` over the segment's
    batches (the shard-select spans count theirs apart)."""
    n = len(bs)
    roots = {s.batch for s in sess.spans if s.name == spans.ROOT
             and s.parent is None and s.host_end is not None}
    keep = sorted(roots)[-n:]
    return sum((s.counts or {}).get("candidates", 0) for s in sess.spans
               if s.name == spans.READBACK and s.batch in keep)


def card_clock(ctx, slack_ns: int = spans.CLOCK_SLACK_NS) -> dict | None:
    """{card: {"events", "violations", "min_after_h0_ns",
    "min_before_h2_ns"}} over the traced segment's micro-batches."""
    sess = spans.last_session()
    n = ctx["phases"]["traced"]["batches"]
    roots = [s for s in sess.spans if s.name == spans.ROOT
             and s.parent is None and s.host_end is not None][-n:]
    by_batch = {r.batch: {"h0": r.host_start, "h2": None} for r in roots}
    for s in sess.spans:
        b = by_batch.get(s.batch)
        if b is not None and s.name == spans.READBACK:
            b["h2"] = (s.marks or {}).get(spans.FIRST_READ)
    out = {}
    for s in sess.spans:
        b = by_batch.get(s.batch)
        if b is None or s.name not in CARD_SPANS or b["h2"] is None:
            continue
        c = out.setdefault(str(s.device), {
            "events": 0, "violations": 0, "min_after_h0_ns": None,
            "min_before_h2_ns": None})
        for t in (s.device_start, s.device_end):
            if t is None:
                continue
            c["events"] += 1
            c["violations"] += int(t < b["h0"] or t > b["h2"] + slack_ns)
            after, before = t - b["h0"], b["h2"] - t
            c["min_after_h0_ns"] = (after if c["min_after_h0_ns"] is None
                                    else min(c["min_after_h0_ns"], after))
            c["min_before_h2_ns"] = (
                before if c["min_before_h2_ns"] is None
                else min(c["min_before_h2_ns"], before))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    ok = True
    for seed in args.seeds:
        result, ctx = traced_run(args.workload, seed, args.seconds)
        bs = spans.batches(ctx)
        sess = spans.last_session()
        ph = ctx["phases"]["traced"]
        cards = card_clock(ctx)
        line = {"cell": args.workload, "seed": seed,
                "correct": result["correct"],
                "checks": {k: v["value"] for k, v in result["checks"].items()},
                "metrics": {k: v["value"]
                            for k, v in result["metrics"].items()},
                "device": result["device"],
                "idle_gaps": result["breakdown"]["idle_gaps"],
                "device_ops": result["breakdown"]["device_ops"],
                "batches": ph["batches"],
                "roots": sum(1 for s in sess.spans if s.name == spans.ROOT
                             and s.parent is None),
                "candidates": _readback_candidates(sess, bs),
                "shard_candidates": sum(sum(b["candidates"].values())
                                        for b in mesh_spans.batches(ctx)),
                "phase_candidates": ph["candidates"],
                "index_clock": spans.clock_check(bs),
                "cards": cards}
        line["ok"] = (bool(cards) and line["roots"] == ph["batches"]
                      and line["candidates"] == ph["candidates"]
                      and line["index_clock"]["violations"] == 0
                      and all(c["violations"] == 0 for c in cards.values()))
        ok &= line["ok"] and result["correct"]
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
