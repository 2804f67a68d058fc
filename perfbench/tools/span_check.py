"""The checks of the program's spans in traced runs of a cell: for each
seed, one ``--trace 1`` run as ``perfbench/run.py`` makes it, then

- the clock check (``spans.clock_check``): for every micro-batch of the
  traced segment H0 <= D1 <= H2 + 20 us, H0 the root's host start, D1
  the device time of the read-back's entry, H2 when the read-back's
  first blocking read returned;
- the session's roots and summed ``candidates`` against the traced
  phase's ``batches`` and ``candidates``;
- the three idle shares' sum against ``device_idle_share``, and
  ``merge_wall_roofline`` against ``merge_roofline``.

    python3 perfbench/tools/span_check.py --workload <cell> --seeds 1 2 3 \
        [--seconds 20] [--out FILE]

One JSON line a seed on standard output (appended to FILE too), with the
traced segment's micro-batches; exit 1 where a run misses a metric or a
check fails (as a program without spans does).  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness, spans, spec  # noqa: E402

IDLE = ("idle_issue_share", "idle_readback_share", "idle_client_share")
SPAN_METRICS = IDLE + ("merge_wall_roofline", "rerank_wall_roofline",
                       "device_reads_per_batch")
IDLE_SUM_POINTS = 2.0   # the three shares sum to device_idle_share within


def checks(result: dict, ctx: dict) -> dict:
    """The span checks of one traced run's result line and context."""
    m = {k: v["value"] for k, v in result["metrics"].items()}
    ph = ctx["phases"]["traced"]
    out = {"missing": [k for k in SPAN_METRICS if k not in m],
           "batches": ph["batches"]}
    bs = spans.batches(ctx)
    if bs is None:
        out["ok"] = False
        return out
    sess = spans.last_session()
    roots = sum(1 for s in sess.spans if s.name == spans.ROOT
                and s.parent is None)
    clock = spans.clock_check(bs)
    idle = sum(m.get(k, 0.0) for k in IDLE)
    out.update(
        clock=clock, roots=roots,
        candidates=spans.total(bs, "counts", "candidates"),
        phase_candidates=ph["candidates"],
        idle_sum=idle, device_idle_share=m.get("device_idle_share"),
        merge_wall_roofline=m.get("merge_wall_roofline"),
        merge_roofline=m.get("merge_roofline"),
        reads_per_batch=m.get("device_reads_per_batch"))
    out["ok"] = (not out["missing"] and clock["violations"] == 0
                 and not clock["unmarked"] and roots == ph["batches"]
                 and out["candidates"] == ph["candidates"]
                 and abs(idle - m["device_idle_share"]) <= IDLE_SUM_POINTS
                 and m["merge_wall_roofline"] <= m["merge_roofline"])
    return out


def traced_run(cell: str, seed: int, seconds: float) -> tuple[dict, dict]:
    """(the result line, the entry's context) of one traced run."""
    held = {}
    make = spec.entry

    def entry(name):
        cls = make(name)

        def build(*a, **k):
            held["entry"] = cls(*a, **k)
            return held["entry"]
        return build
    spec.entry = entry
    try:
        result = harness.run(ROOT, cell, seed, seconds, True)
    finally:
        spec.entry = make
    return result, held["entry"].context()


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
        line = {"cell": args.workload, "seed": seed,
                "correct": result["correct"],
                "metrics": {k: v["value"]
                            for k, v in result["metrics"].items()},
                "device": result["device"],
                "idle_gaps": result["breakdown"]["idle_gaps"],
                "spans": checks(result, ctx)}
        ok &= bool(line["spans"]["ok"])
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
