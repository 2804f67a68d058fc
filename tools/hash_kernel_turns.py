#!/usr/bin/env python3
"""Time the bilinear hash kernels of this checkout against those of another
checkout, in turns on one card.

    python3 tools/hash_kernel_turns.py --baseline DIR [--seed 0]

DIR is another commit's tree (for example the parent, unpacked with
``git archive``).  The script builds ``bilinear_hash_seeded.cu`` (kernel 1)
and ``bilinear_hash.cu`` (kernel 4) of both trees with the same nvcc flags,
checks that both trees give the same codes bit for bit, and times each
kernel at the shapes of its paths (unit rows from ``--seed``): on the
Tiny-1M geometry (385 float32 features with the bias column, 20 bits, 4
tables for kernel 1) the fit (1,060,000 rows), an insert batch of the
streaming path (2,000 rows) and a micro-batch of 32 query normals; then
the one-card benchmark cells' shapes, one table: news20's fit (18,846 x
26,215 at 16 bits) and the query micro-batches of both cells
(``chip_smoke.QUERY_HASH_SHAPES``: news20's 20 normals, tiny1m's 10).  At
each, in the order baseline, this tree, this tree, baseline: CUDA events
over back-to-back calls, then the profiler's device time per call (every
kernel the call launches).  Both libraries take the same C arguments
(``bh_seeded_launch``, ``bh_launch``).  The last line is a JSON record of
the times and the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# label: (rows, d, k, kernel 1's tables, calls timed)
SHAPES = {"fit": (1_060_000, 385, 20, 4, 5),
          "insert batch": (2000, 385, 20, 4, 50),
          "query": (32, 385, 20, 4, 200),
          "news20 fit": (18_846, 26_215, 16, 1, 5)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hash_kernel_turns: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from chip_smoke import (QUERY_HASH_REPS, QUERY_HASH_SHAPES, cuda_ms,
                            device_profile)
    from repro_torch.core.functions import seeded_projections, table_seed
    from repro_torch.kernels import _build
    from repro_torch.kernels.bilinear_hash import (
        _FACTORS_SIGNATURES, _SIGNATURES, FACTORS_LIBRARY, LIBRARY,
        seeds_as_int32)
    from repro_torch.utils.bits import n_words
    from scan_kernel_turns import build

    dev = torch.device("cuda")
    out_dir = _build.BUILD_DIR / "turns"
    libs = {}
    for label, tree in (("baseline", args.baseline.resolve()),
                        ("this", ROOT)):
        (out_dir / label).mkdir(parents=True, exist_ok=True)
        for name, sigs in ((LIBRARY, _SIGNATURES),
                           (FACTORS_LIBRARY, _FACTORS_SIGNATURES)):
            so = build(tree, name, out_dir / label, _build.nvcc_path(),
                       _build.NVCC_FLAGS)
            lib = ctypes.CDLL(str(so))
            for fn, (res, argt) in sigs.items():
                getattr(lib, fn).restype, getattr(lib, fn).argtypes = res, argt
            libs[(label, name)] = lib

    shapes = dict(SHAPES)
    for label, n, d, k, tables in QUERY_HASH_SHAPES:
        shapes[f"{label} query"] = (n, d, k, tables, QUERY_HASH_REPS)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows_of = {}                       # d -> the most rows a shape takes
    for n, d, *_ in shapes.values():
        rows_of[d] = max(rows_of.get(d, 0), n)
    x_of = {}
    for d, n in rows_of.items():
        x_of[d] = torch.randn((n, d), generator=gen, device=dev)
        x_of[d] /= torch.linalg.vector_norm(x_of[d], dim=1, keepdim=True)
    stream = torch.cuda.current_stream().cuda_stream

    def seeded(lib, x, k, tables):
        seeds = [table_seed(0, t) for t in range(tables)]
        seeds_dev = torch.tensor(seeds_as_int32(seeds), dtype=torch.int32,
                                 device=dev)
        out = torch.empty((tables, x.shape[0], n_words(k)),
                          dtype=torch.int32, device=dev)

        def run():
            err = lib.bh_seeded_launch(x.data_ptr(), seeds_dev.data_ptr(),
                                       out.data_ptr(), x.shape[0],
                                       x.shape[1], k, tables, stream)
            if err:
                raise RuntimeError(f"bh_seeded_launch: CUDA error {err}")
            return out
        return run

    def factors(lib, x, k, tables):
        u0, v0 = seeded_projections(table_seed(0, 0), x.shape[1], k, dev)
        out = torch.empty((x.shape[0], n_words(k)), dtype=torch.int32,
                          device=dev)

        def run():
            err = lib.bh_launch(x.data_ptr(), u0.data_ptr(), v0.data_ptr(),
                                out.data_ptr(), x.shape[0], x.shape[1], k,
                                stream)
            if err:
                raise RuntimeError(f"bh_launch: CUDA error {err}")
            return out
        return run

    results = []
    for kernel, name, make in (("1 (seeded)", LIBRARY, seeded),
                               ("4 (factors)", FACTORS_LIBRARY, factors)):
        for shape, (rows, d, k, tables, reps) in shapes.items():
            x = x_of[d][:rows]
            runs = {lab: make(libs[(lab, name)], x, k, tables)
                    for lab in ("baseline", "this")}
            a, b = (runs[lab]().clone() for lab in ("baseline", "this"))
            torch.cuda.synchronize()
            same = torch.equal(a, b)
            if not same:
                diff = int((a != b).sum())
                raise RuntimeError(f"kernel {kernel} at {shape}: {diff} code "
                                   f"words differ between the trees")
            turns = [cuda_ms(torch, runs[lab], reps)
                     for lab in ("baseline", "this", "this", "baseline")]
            dev_ms = {}
            for lab in ("baseline", "this"):
                busy, kern = device_profile(
                    torch, lambda r=runs[lab]: [r() for _ in range(reps)])
                dev_ms[lab] = busy / reps
                dev_ms[f"{lab}_kernels"] = {
                    kn: v[0] / reps for kn, v in sorted(kern.items())}
            rec = dict(kernel=kernel, shape=shape, rows=rows, d=d, k=k,
                       tables=tables if name == LIBRARY else 1,
                       turns_ms_baseline_this_this_baseline=turns,
                       device_ms_per_call=dev_ms, identical=same)
            results.append(rec)
            print(json.dumps(rec), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
