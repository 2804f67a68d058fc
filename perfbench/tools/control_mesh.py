"""The control of a row-sharded cell's check: the plain reference over the
cell's shards put in the program's place and computed one precision below
the configuration's (TF32 for its strict float32), judged by the same
comparison as a run (``check_mesh``).  A sound check reads it as not
correct.

    python3 perfbench/tools/control_mesh.py --workload <cell> --seeds 1 2 3

For each seed it draws the cell's shards on its cards and the normals as
a run does, answers as many queries as a run's check samples with the
TF32 reference, and prints the numbers beside the cell's limits, one JSON
line a seed.  It needs no program and no measured window.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import check_mesh, data_mesh, spec  # noqa: E402
from perfbench.reference.generator import M32, table_seed  # noqa: E402
from perfbench.reference.hyperplane_mesh import (  # noqa: E402
    MeshHyperplaneReference)


def control(cell_name: str, seed: int, device, size=None,
            root=ROOT) -> tuple[dict, dict]:
    """The control's numbers for one seed of ``cell_name`` and the cell's
    limits; ``device`` "cpu" co-locates the shards there."""
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    if size:
        cfg["data"].update(size.get("data", {}))
        mix.update(size.get("traffic", {}))
        cell["check"].update(size.get("check", {}))
    shards = int(cfg["mesh"]["shards"])
    devices = ([torch.device("cuda", i) for i in range(shards)]
               if device.type == "cuda" else [device] * shards)
    q = int(cell["check"]["sample_batches"]) * int(mix["batch"])
    data = dict(cfg["data"])
    data.pop("generator")
    parts, labels, n = data_mesh.tiny1m_shards(seed, devices, **data)
    w = data_mesh.normals_sharded(parts, labels, n, int(data["classes"]), q,
                                  seed, float(mix["normal_noise"]),
                                  devices[0])
    del labels
    k, l = int(cfg["index"]["bits"]), int(mix["scan_l"])
    seeds = [table_seed(int(seed) & M32, t)
             for t in range(int(cfg["index"]["tables"]))]
    low = MeshHyperplaneReference(parts, n, seeds, k, "tf32")
    ids, margins, unions = low.answer(w, l)
    del low
    ref = MeshHyperplaneReference(parts, n, seeds, k, "float64")
    ok = ids >= 0
    numbers = {"unanswered": int((~ok).sum())}
    numbers.update(check_mesh.judge(
        ref, l, (w[torch.from_numpy(np.flatnonzero(ok)).to(devices[0])],
                 ids[ok], margins[ok]), (w, ids, unions)))
    return numbers, cell["limits"]


def main(argv=None) -> int:
    from perfbench import check as chk
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        numbers, limits = control(args.workload, seed, torch.device("cuda"))
        correct, checks = chk.verdict(numbers, limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": "tf32", "correct": correct,
                          "seconds": time.perf_counter() - t,
                          "checks": checks}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
