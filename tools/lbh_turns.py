#!/usr/bin/env python3
"""Time the LBH chain kernel and one bit's Nesterov step loop of this
checkout against another checkout's, in turns on one card.

    python3 tools/lbh_turns.py --baseline DIR [--seed 0]

DIR is another commit's tree (for example the parent, unpacked with
``git archive``).  The script builds ``lbh_chain.cu`` (kernel 8) of both
trees with the same nvcc flags and, on the learner's shapes (a 1,000-row
sample of ``tiny1m_like`` features with the bias column, d = 385, its
residue R = 20 S):

- the chain at m = 1,000 in the order baseline, this tree, this tree,
  baseline: CUDA events over back-to-back calls (paced by the host), then
  the profiler's device time per launch; each tree's output must lie
  within the chain's rounding bound of the plain version;
- one bit's 150 steps: the eager loop with the baseline's kernel (the
  loop as the baseline runs it, ``core.learning._nesterov_bit`` without a
  graph) against this tree's ``BitLoop`` replay, in turns eager, graphed,
  graphed, eager: wall time per bit (ending in a synchronise) and the
  device time the profiler sees.  The graphed bit must give this tree's
  eager loop's u, v and costs bit for bit.

Both libraries take the same C arguments (``lbh_chain_launch``); the
wrapper loads its library through ``_build.load``, whose cache the script
points at each tree's build in turn.  The last line is a JSON record of
the times and the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
M, D_GIST, BITS, STEPS = 1000, 384, 20, 150


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("lbh_turns: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from chip_smoke import cuda_ms, device_profile, kernel_device_ms
    from repro_torch.core import learning
    from repro_torch.core.functions import (seeded_projections, strict_fp32,
                                            table_seed)
    from repro_torch.data.synthetic import tiny1m_like
    from repro_torch.kernels import _build, lbh_grad
    from repro_torch.kernels.ref import lbh_chain_bound
    from scan_kernel_turns import build

    dev = torch.device("cuda")
    out_dir = _build.BUILD_DIR / "turns"
    libs = {}
    for label, tree in (("baseline", args.baseline.resolve()),
                        ("this", ROOT)):
        (out_dir / label).mkdir(parents=True, exist_ok=True)
        so = build(tree, lbh_grad.LIBRARY, out_dir / label,
                   _build.nvcc_path(), _build.NVCC_FLAGS)
        lib = ctypes.CDLL(str(so))
        for fn, (res, argt) in lbh_grad._SIGNATURES.items():
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = res, argt
        libs[label] = lib

    def use(label):
        _build._LIBS[lbh_grad.LIBRARY] = libs[label]

    corpus = tiny1m_like(n_labeled=1000, n_unlabeled=9000, d=D_GIST,
                         seed=args.seed)
    x = torch.from_numpy(corpus.x).to(dev)
    x_m = x[learning.sample_rows(x.shape[0], M, table_seed(0, 0)).to(dev)]
    t1, t2 = learning.auto_thresholds(x_m, x)
    r = BITS * learning.similarity_matrix(x_m, t1, t2)
    u0, v0 = seeded_projections(table_seed(0, 0), x.shape[1], BITS, dev)
    with strict_fp32():
        p, q = x_m @ u0[:, 0], x_m @ v0[:, 0]
    lr = 0.03 / M
    results = []

    # kernel 8 alone
    bounds = lbh_chain_bound(p, q, r)
    want = lbh_grad.lbh_chain_plain(p, q, r)
    for label in ("baseline", "this"):
        use(label)
        got = lbh_grad.lbh_chain(p, q, r)
        torch.cuda.synchronize()
        for g, w, b in zip(got, want, bounds):
            if not bool(((g - w).abs() <= b).all()):
                raise RuntimeError(f"{label}: the chain lies outside its "
                                   f"rounding bound")

    def chain_run(label):
        def run():
            use(label)
            return lbh_grad.lbh_chain(p, q, r)
        return run

    turns = [cuda_ms(torch, chain_run(lab), 200, warmup=5)
             for lab in ("baseline", "this", "this", "baseline")]
    dev_ms = {}
    for lab in ("baseline", "this"):
        _, prof = device_profile(
            torch, lambda f=chain_run(lab): [f() for _ in range(200)])
        dev_ms[lab] = kernel_device_ms(prof, "lbh_chain_kernel")
    rec = dict(kernel="8 (lbh_chain)", m=M,
               turns_ms_baseline_this_this_baseline=turns,
               device_ms_per_launch=dev_ms, within_bound=True)
    results.append(rec)
    print(json.dumps(rec), flush=True)

    # one bit's step loop: eager with the baseline's kernel, graphed here
    use("this")
    loop = learning.BitLoop(x_m, STEPS, lr)

    def bit(label):
        def run():
            use("baseline" if label == "eager" else "this")
            return learning._nesterov_bit(u0[:, 0], v0[:, 0], x_m, r, STEPS,
                                          lr, loop if label == "graphed"
                                          else None)
        return run

    use("this")
    eager_this = learning._nesterov_bit(u0[:, 0], v0[:, 0], x_m, r, STEPS, lr)
    graphed = bit("graphed")()
    same = all(torch.equal(a, b) for a, b in zip(eager_this, graphed))
    if not same:
        raise RuntimeError("the graphed bit differs from the eager loop")
    bit("eager")()          # warm the baseline's eager path
    walls = []
    for lab in ("eager", "graphed", "graphed", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bit(lab)()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    busy = {}
    for lab in ("eager", "graphed"):
        busy_ms, prof = device_profile(torch, bit(lab))
        busy[lab] = dict(busy_ms=busy_ms or None,
                         chain_ms=kernel_device_ms(prof, "lbh_chain_kernel"))
    rec = dict(loop="one bit", m=M, d=x.shape[1], steps=STEPS,
               wall_ms_eager_graphed_graphed_eager=walls,
               device_ms=busy, graphed_equals_eager=same)
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
