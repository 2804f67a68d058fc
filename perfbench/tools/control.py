"""The control of a cell's check: the plain reference put in the
program's place and computed one precision below the configuration's
(TF32 for its strict float32), judged by the same comparison as a run.
A sound check reads it as not correct.

    python3 perfbench/tools/control.py --workload <cell> --seeds 1 2 3

For each seed it makes the cell's data and normals as a run does, answers
as many queries as a run's check samples with the TF32 reference, and
prints the numbers beside the cell's limits, one JSON line a seed.  It
needs no program and no measured window.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import check as chk  # noqa: E402
from perfbench import data, spec  # noqa: E402
from perfbench.reference.generator import M32, table_seed  # noqa: E402
from perfbench.reference.hyperplane import HyperplaneReference  # noqa: E402


def control(cell_name: str, seed: int, device, size=None,
            root=ROOT) -> tuple[dict, dict]:
    """The control's numbers for one seed of ``cell_name`` (a cell of
    ``root``'s BENCHMARK.json) and the cell's limits: the reference in
    TF32 answers the queries of as many micro-batches as a run's
    check samples, judged by ``check.judge`` as a run's answers are."""
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    if size:
        cfg["data"].update(size.get("data", {}))
        mix.update(size.get("traffic", {}))
        cell["check"].update(size.get("check", {}))
    q = int(cell["check"]["sample_batches"]) * int(mix["batch"])
    x, y = data.make(cfg, seed, device)
    w = data.normals(x, y, q, seed, float(mix["normal_noise"]))
    k, l = int(cfg["index"]["bits"]), int(mix["scan_l"])
    seeds = [table_seed(int(seed) & M32, t)
             for t in range(int(cfg["index"]["tables"]))]
    low = HyperplaneReference(x, seeds, k, "tf32")
    ref = HyperplaneReference(x, seeds, k, "float64")
    ids, margins, unions = low.answer(w, l)
    rows = torch.from_numpy(ids).to(device)
    return chk.judge(ref, l, (w, rows, margins), (w, rows, unions)), \
        cell["limits"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for seed in args.seeds:
        t = time.perf_counter()
        numbers, limits = control(args.workload, seed, dev)
        correct, checks = chk.verdict(numbers, limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": "tf32", "correct": correct,
                          "seconds": time.perf_counter() - t,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
