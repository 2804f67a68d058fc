#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--batches 16]

Run from the repository root.  It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc``, holds each against its plain PyTorch
version at the main path's shapes, then drives the serving main path at
full size — the Tiny-1M geometry (1,060,000 x 385 float32 features from
``--seed``), ``MultiTableIndex(method="bh", bits=20, tables=4)`` fitted on
the card and ``HashQueryService(mode="scan", scan_l=128)`` answering
micro-batches of 32 hyperplane normals — and checks the answers against the
plain scan and an exhaustive scan.  Every phase that fails stops the run
with a non-zero exit.  The second-to-last line of its output is the
kernels' JSON record, the last ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when no CUDA card is usable or when
the repository's sources are not beside it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_LABELED, N_UNLABELED, D_GIST = 60_000, 1_000_000, 384
BITS, TABLES, BATCH, SCAN_L = 20, 4, 32, 128
# H100 SXM data-sheet peaks (700 W): HBM rate, float32 outside the tensor
# cores; popcount issues 16 results per clock per SM (CUDA programming
# guide, compute capability 9.0), at the card's maximum SM clock.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
POPC_PER_CLK_SM = 16


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn over reps back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=16)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import search
    from repro_torch.core.functions import (seeded_projections, strict_fp32,
                                            table_seed)
    from repro_torch.core.indexer import IndexConfig
    from repro_torch.data.synthetic import tiny1m_like
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.bilinear_hash import (
        LIBRARY as HASH_LIB, bilinear_hash_seeded,
        bilinear_hash_seeded_plain)
    from repro_torch.kernels.hamming import (
        LIBRARY as SCAN_LIB, cand_encoding, hamming_topk_hist,
        hamming_topk_hist_plain)
    from repro_torch.kernels.ref import sign_flip_ratios
    from repro_torch.serving import batch_query as bq
    from repro_torch.serving.multi_table import MultiTableIndex
    from repro_torch.serving.service import HashQueryService
    from repro_torch.utils.bits import flip_packed, from_numpy_u32

    dev = torch.device("cuda")

    # -- 1. device ----------------------------------------------------------
    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    max_clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"device: {kind} x{count}, {sms} SMs, max SM clock "
          f"{max_clock_mhz:.0f} MHz, torch {torch.__version__} "
          f"CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # -- 2. build -----------------------------------------------------------
    phase("2 build")
    t0 = time.perf_counter()
    _build.build([HASH_LIB, SCAN_LIB])
    print(f"built both kernels in {time.perf_counter() - t0:.1f} s")
    for lib in (HASH_LIB, SCAN_LIB):
        log = _build.build_log(lib)
        check("sm_90a" in log, f"{lib} compiled for sm_90a")
        for line in log.splitlines():
            if any(s in line for s in ("for 'sm_", "registers",
                                       "spill", "smem")):
                print(f"  {lib}: {line.strip()}")

    # -- corpus (set-up) ----------------------------------------------------
    t0 = time.perf_counter()
    corpus = tiny1m_like(n_labeled=N_LABELED, n_unlabeled=N_UNLABELED,
                         d=D_GIST, seed=args.seed)
    x_np = corpus.x
    n, d = x_np.shape
    x = torch.from_numpy(x_np).to(dev)
    rng = np.random.default_rng(args.seed + 1)
    ws = rng.normal(size=(args.batches * BATCH, d)).astype(np.float32)
    seeds = [table_seed(0, t) for t in range(TABLES)]
    print(f"corpus: tiny1m-like {n} x {d} float32 "
          f"({x_np.nbytes / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    records = {}

    # -- 3. hash kernel vs plain at the fit and query shapes ---------------
    phase("3 hash kernel vs plain")
    codes_k = bilinear_hash_seeded(x, seeds, BITS)
    torch.cuda.synchronize()
    codes_p = bilinear_hash_seeded_plain(x, seeds, BITS)
    factors = [seeded_projections(s, d, BITS, dev) for s in seeds]
    ratios = sign_flip_ratios(x, factors, codes_k, codes_p)
    n_bits = TABLES * n * BITS
    print(f"hash: {ratios.numel()} of {n_bits} bits differ from the plain "
          f"version; largest |proj| / rounding bound among them: "
          f"{ratios.max().item() if ratios.numel() else 0.0:.4f}")
    check(bool((ratios <= 1.0).all()),
          "every differing hash bit lies within the near-zero bound")
    # and at the query shape: one micro-batch of normals
    w0 = torch.from_numpy(ws[:BATCH]).to(dev)
    q_ratios = sign_flip_ratios(w0, factors,
                                bilinear_hash_seeded(w0, seeds, BITS),
                                bilinear_hash_seeded_plain(w0, seeds, BITS))
    print(f"hash at the query shape ({BATCH} normals): {q_ratios.numel()} "
          f"of {TABLES * BATCH * BITS} bits differ")
    check(bool((q_ratios <= 1.0).all()),
          "every differing query-hash bit lies within the near-zero bound")
    hash_ms = cuda_ms(torch, lambda: bilinear_hash_seeded(x, seeds, BITS), 5)
    hash_plain_ms = cuda_ms(
        torch, lambda: bilinear_hash_seeded_plain(x, seeds, BITS), 3)
    w_words = codes_k.shape[-1]

    def hash_bound(rows):
        """(bound ms, bound_by) of hashing rows x d for all tables."""
        t_bytes = (rows * d * 4 + TABLES * 4
                   + TABLES * rows * w_words * 4) / HBM_BYTES_S
        t_ops = 4 * rows * d * BITS * TABLES / FP32_FLOP_S
        return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                           else "bytes")

    # the query shape is where serving launches it: once per micro-batch
    q_hash_ms = cuda_ms(torch, lambda: bilinear_hash_seeded(w0, seeds, BITS),
                        50)
    q_hash_plain_ms = cuda_ms(
        torch, lambda: bilinear_hash_seeded_plain(w0, seeds, BITS), 50)
    q_bound_ms, q_bound_by = hash_bound(BATCH)
    print(f"hash at the query shape ({BATCH} x {d}): kernel {q_hash_ms} ms, "
          f"plain {q_hash_plain_ms} ms, bound {q_bound_ms} ms "
          f"({q_bound_by})")
    bound_ms, bound_by = hash_bound(n)
    print(f"hash at the fit shape ({n} x {d}): kernel {hash_ms} ms, "
          f"plain {hash_plain_ms} ms, bound {bound_ms} ms ({bound_by})")
    records["bilinear_hash_seeded"] = dict(
        name="bilinear_hash_seeded", route="cuda",
        source="src/repro_torch/kernels/csrc/bilinear_hash_seeded.cu",
        replaces="src/repro/kernels/bilinear_hash.py:125",
        # codes are bits: the largest difference is 1 if any bit differs
        max_abs_err=int(ratios.numel() + q_ratios.numel() > 0), ms=hash_ms,
        plain_ms=hash_plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None)

    # -- 4. scan kernel vs plain at the query shape -------------------------
    phase("4 scan kernel vs plain")
    q = flip_packed(bilinear_hash_seeded(w0, seeds, BITS), BITS)
    bn = ops._block_rows(n, 4096)
    l_k = min(SCAN_L, bn)

    scan_err = 0   # largest |kernel - plain| over every output compared

    def scan_case(label, codes, queries, l, active=None, packs=("16",)):
        nonlocal scan_err
        nb = ops._block_rows(codes.shape[1], 4096)
        lk = min(l, nb)
        act_i = None if active is None else active.to(torch.int32)
        want = search.hamming_topk_grouped(codes, queries, l, active=active)
        for pack in packs:
            kd, ki = hamming_topk_hist(codes, queries, lk, nb, act_i, pack)
            pd, pi = hamming_topk_hist_plain(codes, queries, lk, nb, act_i,
                                             pack)
            got = ops.hamming_topk_grouped(codes, queries, l, pack=pack,
                                           active=active)
            for a, b in ((kd, pd), (ki, pi), (got[0], want[0]),
                         (got[1], want[1])):
                scan_err = max(scan_err,
                               int((a.long() - b.long()).abs().max()))
            check(torch.equal(kd, pd) and torch.equal(ki, pi),
                  f"{label} pack {pack}: block output equals the plain one")
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1]),
                  f"{label} pack {pack}: merged top-l equals the plain scan")
            print(f"scan {label} pack {pack}: identical "
                  f"(G={codes.shape[0]} n={codes.shape[1]} "
                  f"W={codes.shape[2]} B={queries.shape[1]} l={l})")

    scan_case("main", codes_k, q, SCAN_L, packs=("none", "16", "8"))
    dead = torch.from_numpy(rng.random(n) < 0.1).to(dev)
    scan_case("10% tombstoned", codes_k, q, SCAN_L, active=~dead)
    scan_case("l > n", codes_k[:, :100].contiguous(), q, SCAN_L)
    codes48 = bilinear_hash_seeded(x[:200_000], seeds, 48)
    q48 = flip_packed(bilinear_hash_seeded(w0, seeds, 48), 48)
    scan_case("W=2 (k=48)", codes48, q48, SCAN_L, packs=("16", "8"))
    scan_ms = cuda_ms(torch, lambda: hamming_topk_hist(codes_k, q, l_k, bn,
                                                       None, "16"), 20)
    scan_plain_ms = cuda_ms(torch, lambda: hamming_topk_hist_plain(
        codes_k, q, l_k, bn, None, "16"), 3)
    grid = -(-n // bn)
    d_dtype, i_dtype, _ = cand_encoding("16", w_words, bn)
    cand_bytes = TABLES * grid * BATCH * l_k * (
        torch.empty(0, dtype=d_dtype).element_size()
        + torch.empty(0, dtype=i_dtype).element_size())
    scan_bytes = TABLES * (n + BATCH) * w_words * 4 + cand_bytes
    scan_popc = TABLES * n * BATCH * w_words
    popc_s = POPC_PER_CLK_SM * sms * max_clock_mhz * 1e6
    records["hamming_topk_hist"] = dict(
        name="hamming_topk_hist", route="cuda",
        source="src/repro_torch/kernels/csrc/hamming_topk_hist.cu",
        replaces="src/repro/kernels/hamming.py:429",
        max_abs_err=scan_err, ms=scan_ms, plain_ms=scan_plain_ms,
        bound_ms=1e3 * max(scan_bytes / HBM_BYTES_S, scan_popc / popc_s),
        bound_by=("operations" if scan_popc / popc_s
                  > scan_bytes / HBM_BYTES_S else "bytes"),
        library_ms=None)
    del codes_p, codes48
    torch.cuda.synchronize()

    # -- 5. main path end to end --------------------------------------------
    phase("5 main path")
    cfg = IndexConfig(method="bh", bits=BITS, tables=TABLES, batch=BATCH)
    torch.cuda.reset_peak_memory_stats()
    bilinear_hash_seeded.launches = 0
    hamming_topk_hist.launches = 0
    index = MultiTableIndex(cfg, device="cuda").fit(x_np)
    service = HashQueryService(index, mode="scan", scan_l=SCAN_L)
    answers = []
    for i in range(args.batches):
        answers.extend(service.query_batch(ws[i * BATCH:(i + 1) * BATCH]))
    torch.cuda.synchronize()
    launches = {"bilinear_hash_seeded": bilinear_hash_seeded.launches,
                "hamming_topk_hist": hamming_topk_hist.launches}
    print(f"fit {index.fit_s:.2f} s; launches on the main path: {launches}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB (with the {x.nbytes / 2**30:.2f} GiB feature copy of "
          f"phases 3-4)")
    check(all(v > 0 for v in launches.values()),
          "both kernels launched on the main path")
    check([f.seed for f in index.families] == seeds,
          "the index hashes with the seeds checked in phase 3")
    ans_ids = np.array([a.index for a in answers])
    ans_m = np.array([a.margin for a in answers])
    check(bool((ans_ids >= 0).all()), "every query has an answer")

    # the same index answered through the plain scan on the card
    codes_dev = from_numpy_u32(np.stack(index.codes), dev)
    plain_ids = []
    for i in range(args.batches):
        wb = ws[i * BATCH:(i + 1) * BATCH]
        qc = bq.hash_queries_all(index.families, wb)
        _, idx = search.hamming_topk_grouped(codes_dev, qc, SCAN_L)
        plain_ids.append(index.answer_from_scan(wb, idx).ids)
    plain_ids = np.concatenate(plain_ids)
    check(bool((plain_ids == ans_ids).all()),
          "answers identical to the plain scan's")
    print(f"answers identical to the plain scan for {ans_ids.size} queries")

    # exhaustive scan: the smallest margin over all rows, per query
    w_t = torch.from_numpy(ws).to(dev)
    norms = torch.linalg.vector_norm(w_t, dim=1)
    with strict_fp32():
        m_all = (x @ w_t.T).abs() / norms
    m_min, i_min = m_all.min(dim=0)
    ans_t = torch.from_numpy(ans_ids).to(dev)
    # rounding bound of two float32 evaluations of the same dot products
    scale = (d + 8) * 2.0 ** -23
    tol = scale * ((x[ans_t] * w_t).abs().sum(1)
                   + (x[i_min] * w_t).abs().sum(1)) / norms
    ok = torch.from_numpy(ans_m).to(dev) >= m_min - tol
    check(bool(ok.all()), "every answer's margin >= the exhaustive minimum")
    # rank of each answer among all rows by exhaustive margin (0 = the
    # exhaustive minimum itself)
    q_idx = torch.arange(ans_t.numel(), device=dev)
    rank = (m_all < m_all[ans_t, q_idx][None, :]).sum(dim=0).double()
    del m_all
    recall1 = (ans_t == i_min).double().mean().item()
    print(f"recall@1 vs exhaustive scan: {recall1:.4f}; answer's rank among "
          f"{n} rows by margin: median {rank.median().item():.0f}, p90 "
          f"{rank.quantile(0.9).item():.0f}; in the exhaustive top-100: "
          f"{(rank < 100).double().mean().item():.4f}, top-1000: "
          f"{(rank < 1000).double().mean().item():.4f}")
    stats = service.stats()
    print("service stats: " + json.dumps(
        {k: stats[k] for k in ("requests", "batches", "qps",
                               "mean_batch_latency_ms",
                               "p95_batch_latency_ms", "lookup_s",
                               "rerank_s", "index_device_uploads")}))
    print("index stats: " + json.dumps(
        {k: v for k, v in index.stats().items() if k != "per_table"}))

    # where a micro-batch's time goes: the same batches again, each stage
    # ended by a synchronise (host clock), summed over the batches
    codes_scan, _ = index._scan_state()
    stage_s = {"hash": 0.0, "scan_and_merge": 0.0, "union_and_rerank": 0.0}
    for i in range(args.batches):
        wb = ws[i * BATCH:(i + 1) * BATCH]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qc = bq.hash_queries_all(index.families, wb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, idx = ops.hamming_topk_grouped(codes_scan, qc, SCAN_L,
                                          select=cfg.fused_select,
                                          pack=cfg.cand_pack)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        index.answer_from_scan(wb, idx)   # ends in host arrays: synchronised
        t3 = time.perf_counter()
        stage_s["hash"] += t1 - t0
        stage_s["scan_and_merge"] += t2 - t1
        stage_s["union_and_rerank"] += t3 - t2
    print("micro-batch stages, ms per batch (synchronised): " + json.dumps(
        {k: 1e3 * v / args.batches for k, v in stage_s.items()}))

    # -- 6. times -----------------------------------------------------------
    phase("6 times")
    kernels = []
    for name, rec in records.items():
        rec["launches"] = launches[name]
        kernels.append({k: rec[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
