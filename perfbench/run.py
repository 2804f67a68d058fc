"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout (``BENCHMARK.json`` beside ``perfbench/``
and the program under ``src/``) on a machine with the cell's CUDA cards.
The last line of standard output is the result's JSON; the last lines of
standard error give each number the check compared beside its limit.
Without a card, without the program, or with a module loaded that the
benchmark may not load, it prints no result and exits with 2.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from perfbench.harness import RunError, run
    try:
        out = run(ROOT, args.workload, args.seed, args.seconds,
                  bool(args.trace))
    except RunError as e:
        print(f"perfbench: no result: {e}", file=sys.stderr, flush=True)
        return 2
    return report(out)


def report(out: dict) -> int:
    """Print the result line, then each compared number beside its limit
    on standard error; or, where this process has loaded JAX, flax or the
    JAX package, name them and print no result."""
    from perfbench.harness import forbidden_modules
    found = forbidden_modules()
    if found:
        print(f"perfbench: no result: modules that must not load are "
              f"loaded: {found}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
