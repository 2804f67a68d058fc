#!/usr/bin/env python3
"""Time the first scan batch after a refresh's swap with the shadow warmed
by its base upload alone (what ``RefreshManager._warm`` does) and with the
upload plus one scan batch of the serving size before the swap (the JAX
package's warm-up), in turns on one index on the card.

    python3 tools/refresh_warm_turns.py [--rows 1000000] [--rounds 6] [--seed 0]

The index is tiny1m-refresh's configuration (385 float32 features with the
bias column, BH 20 bits x 4 tables, LBH re-learned at each refresh) over
--rows unit rows from --seed, with 20,000 more rows in its delta, no
compactor and no inline compaction.  Each round runs one refresh with
wait=True (turns: upload, upload + scan, upload + scan, upload, ...), then
times two scan batches of 32 query normals at l = 128, synchronised: the
first pays whatever the warm-up left undone, the second is the steady
state.  The last line is a JSON record of the times, the refreshes' build
and swap times and the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
D, BITS, TABLES, BATCH, SCAN_L, DELTA = 385, 20, 4, 32, 128, 20_000


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from repro_torch.core.indexer import IndexConfig
    from repro_torch.serving.lsm import LSMMultiTableIndex
    from repro_torch.serving.refresh import RefreshManager
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)

    def unit_rows(n):
        x = rng.standard_normal((n, D - 1), dtype=np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return np.hstack([x, np.ones((n, 1), np.float32)])

    cfg = IndexConfig(method="bh", bits=BITS, tables=TABLES, batch=BATCH,
                      lsm_delta_threshold=0.02, refresh_method="lbh",
                      lsm_auto=False)
    idx = LSMMultiTableIndex(cfg, device="cuda").fit(unit_rows(args.rows))
    idx.insert(unit_rows(DELTA))
    ws = rng.standard_normal((BATCH, D)).astype(np.float32)
    mgr = RefreshManager(idx)
    upload_only = mgr._warm

    def upload_and_scan(shadow):
        upload_only(shadow)
        shadow.query_scan_batch(ws, l=SCAN_L)

    def timed_batch():
        torch.cuda.synchronize()
        t = time.perf_counter()
        idx.query_scan_batch(ws, l=SCAN_L)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

    timed_batch()            # the base before any refresh
    out = {"upload": [], "upload + scan": []}
    for i in range(args.rounds):
        turn = "upload" if i % 4 in (0, 3) else "upload + scan"
        mgr._warm = upload_only if turn == "upload" else upload_and_scan
        assert mgr.refresh(wait=True, warm=True)
        st = mgr.stats()
        first, second = timed_batch(), timed_batch()
        out[turn].append({"first_ms": first, "second_ms": second,
                          "build_s": st["last_build_s"],
                          "swap_pause_ms": st["last_swap_pause_ms"]})
        print(f"round {i} ({turn}): first batch {first:.3f} ms, second "
              f"{second:.3f} ms, build {st['last_build_s']:.3f} s, swap "
              f"pause {st['last_swap_pause_ms']:.3f} ms", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"rows": args.rows, "delta": DELTA, "card": card,
                      **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
