#!/usr/bin/env python3
"""Time the fused-scan kernels of this checkout against those of another
checkout, in turns on one card.

    python3 tools/scan_kernel_turns.py --baseline DIR [--seed 0]

DIR is another commit's tree (for example the parent, unpacked with
``git archive``).  The script builds ``hamming_topk_hist.cu`` and
``hamming_topk_fused.cu`` of both trees with the same nvcc flags, checks
that both give the same block-local output bit for bit, and times each
kernel at the shapes of its paths (1,060,000 rows of 20-bit codes from
``--seed``, pack 16) in the order baseline, this tree, this tree, baseline:
CUDA events over back-to-back launches and the profiler's device time.
The pipelined kernel (``topk_hist_dma``) is timed at the serving shape, at
B = 1 and, beside the hist kernel, at wide codes (W = 13 and 32: two
groups of 100,000 rows, B = 32, 5% tombstones), where its time is held
against the hist kernel's.
Both libraries take the same C arguments (``topk_*_launch``).  The last
line is a JSON record of the times and the card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N, TABLES, BATCH = 1_060_000, 4, 32
KERNELS = {  # library: (entry prefix, kernel name fragment in the profiler)
    "hamming_topk_hist": [("topk_hist", "topk_hist_kernel"),
                          ("topk_hist_dma", "topk_hist_dma_kernel")],
    "hamming_topk_fused": [("topk_fused", "topk_fused_kernel")],
}


def build(tree: Path, name: str, out_dir: Path, nvcc: str, flags) -> Path:
    """nvcc one csrc source of `tree` into out_dir; returns the library."""
    csrc = tree / "src" / "repro_torch" / "kernels" / "csrc"
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.read_bytes())
    so = out_dir / f"{name}-{h.hexdigest()[:16]}.so"
    if not so.exists():
        subprocess.run([nvcc, *flags, "-o", str(so), str(csrc / f"{name}.cu")],
                       check=True, capture_output=True, text=True)
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("scan_kernel_turns: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, hamming, ops
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, device_profile, kernel_device_ms

    dev = torch.device("cuda")
    out_dir = _build.BUILD_DIR / "turns"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for label, tree in (("baseline", args.baseline.resolve()),
                        ("this", ROOT)):
        (out_dir / label).mkdir(exist_ok=True)
        for name in KERNELS:
            so = build(tree, name, out_dir / label, _build.nvcc_path(),
                       _build.NVCC_FLAGS)
            lib = ctypes.CDLL(str(so))
            for fn, (res, argt) in hamming._SIGNATURES[name].items():
                getattr(lib, fn).restype, getattr(lib, fn).argtypes = res, argt
            libs[(label, name)] = lib

    rng = np.random.default_rng(args.seed)
    t = lambda a: torch.from_numpy(a.view(np.int32)).to(dev)  # noqa: E731
    codes = t(rng.integers(0, 2**20, (TABLES, N, 1), dtype=np.uint32))
    queries = t(rng.integers(0, 2**20, (TABLES, BATCH, 1), dtype=np.uint32))
    act5 = torch.from_numpy((rng.random(N) >= 0.05).astype(np.int32)).to(dev)
    shapes = {
        "serving": (codes, queries, 128, None),
        "base, 5% tombstoned": (codes, queries, 128, act5),
        "LBH query_scan": (codes[:1].contiguous(),
                           queries[:1, :1].contiguous(), 256, None),
        "delta of 20000 rows, 5% tombstoned": (
            codes[:, -20_000:].contiguous(), queries, 128,
            act5[-20_000:].contiguous()),
    }
    act_w = torch.from_numpy(
        (rng.random(100_000) >= 0.05).astype(np.int32)).to(dev)
    for w in (13, 32):
        shapes[f"W={w}, 5% tombstoned"] = (
            t(rng.integers(0, 2**32, (2, 100_000, w), dtype=np.uint32)),
            t(rng.integers(0, 2**32, (2, BATCH, w), dtype=np.uint32)), 128,
            act_w)
    # the shapes each kernel is timed at (kernel 3: its own path's and the
    # wide codes, where it is held against kernel 2)
    dma_shapes = ("serving", "LBH query_scan", "W=13, 5% tombstoned",
                  "W=32, 5% tombstoned")

    def launcher(lib, prefix, c, qc, l, act):
        g, n, w = c.shape
        b = qc.shape[1]
        bn = ops._block_rows(n, 4096)
        l_k = min(l, bn)
        grid = -(-n // bn)
        od = torch.empty((g, grid, b, l_k), dtype=torch.int16, device=dev)
        oi = torch.empty_like(od)
        fn = getattr(lib, f"{prefix}_launch")

        def run():
            err = fn(c.data_ptr(), qc.data_ptr(),
                     None if act is None else act.data_ptr(), od.data_ptr(),
                     oi.data_ptr(), g, n, w, b, l_k, bn, grid, 1, 0x7FFF,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{prefix}_launch: CUDA error {err}")
            return od, oi
        return run

    results = []
    for name, entries in KERNELS.items():
        for prefix, frag in entries:
            for shape, (c, qc, l, act) in shapes.items():
                if (shape not in dma_shapes if prefix == "topk_hist_dma"
                        else prefix == "topk_fused" and shape.startswith("W=")):
                    continue
                runs = {lab: launcher(libs[(lab, name)], prefix, c, qc, l,
                                      act) for lab in ("baseline", "this")}
                a, b = (tuple(x.clone() for x in runs[lab]())
                        for lab in ("baseline", "this"))
                same = all(torch.equal(x, y) for x, y in zip(a, b))
                if not same:
                    raise RuntimeError(f"{prefix} at {shape}: outputs differ")
                turns = [cuda_ms(torch, runs[lab], 20)
                         for lab in ("baseline", "this", "this", "baseline")]
                dev_ms = {}
                for lab in ("baseline", "this"):
                    _, prof = device_profile(
                        torch, lambda r=runs[lab]: [r() for _ in range(5)])
                    dev_ms[lab] = kernel_device_ms(prof, frag)
                rec = dict(kernel=prefix, shape=shape,
                           turns_ms_baseline_this_this_baseline=turns,
                           device_ms=dev_ms, identical=same)
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
