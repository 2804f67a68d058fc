#!/usr/bin/env python3
"""The dry-run records of ``python -m repro_torch.launch.dryrun --all
--mesh both`` as one markdown table, a row per (arch, shape) cell with
the single-mesh (16 x 16) and multi-mesh (2 x 16 x 16) values side by
side as "single / multi".

    python3 tools/dryrun_table.py [--dir experiments/dryrun_torch]

Columns, per device: FLOPs (and the bf16 share of them), min_bytes (the
floor's bytes), eager op-boundary bytes, launches of the step, the floor
(step_floor_s) and what bounds it, useful_flops_fraction, the peak GiB
and whether it fits 80 GB.  The numbers are an account at the NVIDIA H100
80GB HBM3's data-sheet rates, not a measurement.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def g(x: float) -> str:
    return f"{x:.3g}"


def row(single: dict, multi: dict) -> str:
    def both(fn):
        return f"{fn(single)} / {fn(multi)}"

    def bf16_share(r):
        f = r["flops_by_dtype"]
        return f"{f.get('bfloat16', 0.0) / max(sum(f.values()), 1):.2f}"

    def floor(r):
        rf = r["roofline"]
        return f"{rf['step_floor_s']:.4g} {rf['bound'][:4]}"

    cells = [
        single["arch"], single["shape"],
        both(lambda r: g(r["flops_per_device"])), both(bf16_share),
        both(lambda r: g(r["roofline"]["min_bytes"])),
        both(lambda r: g(r["eager_bytes"])), str(single["launches"]),
        both(floor), both(lambda r: f"{r['useful_flops_fraction']:.3f}"),
        both(lambda r: f"{r['memory']['peak_bytes'] / 2**30:.2f}"),
        both(lambda r: "yes" if r["fits_80g"] else "no")]
    return "| " + " | ".join(cells) + " |"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=str(ROOT / "experiments" /
                                         "dryrun_torch"))
    args = ap.parse_args(argv)
    recs = {}
    for p in sorted(Path(args.dir).glob("*.json")):
        r = json.loads(p.read_text())
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    cells = sorted({(a, s) for a, s, _ in recs},
                   key=lambda c: (c[0], SHAPES.index(c[1])))
    print("| arch | shape | FLOPs / dev | bf16 share | min_bytes / dev | "
          "eager bytes / dev | launches | floor s, bound | useful FLOPs | "
          "peak GiB / dev | fits 80 GB |")
    print("|" + "---|" * 11)
    missing = 0
    for a, s in cells:
        if (a, s, "single") not in recs or (a, s, "multi") not in recs:
            missing += 1
            continue
        print(row(recs[(a, s, "single")], recs[(a, s, "multi")]))
    print(f"\n{len(recs)} records, {len(cells)} cells"
          + (f", {missing} without both meshes" if missing else ""))
    return 1 if missing or not recs else 0


if __name__ == "__main__":
    sys.exit(main())
