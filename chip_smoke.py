#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--batches 16]

Run from the repository root.  It builds the port's eight CUDA kernels
(six libraries) from ``src/repro_torch/kernels/csrc``, holds each against
its plain PyTorch version at the shapes its path gives it, then drives four
paths at full size on the Tiny-1M geometry (1,060,000 x 385 float32
features, 10 classes, from ``--seed``):

- serving: ``MultiTableIndex(method="bh", bits=20, tables=4)`` fitted on the
  card and ``HashQueryService(mode="scan", scan_l=128)`` answering
  micro-batches of 32 hyperplane normals, checked against the plain scan
  and an exhaustive scan;
- streaming ingest: ``LSMMultiTableIndex`` of the same configuration
  (``lsm_delta_threshold=0.02``) fitted on the 1,000,000 unlabelled rows
  behind ``AsyncHashQueryService(mode="scan", scan_l=128)``, with the
  background compactor, taking the 60,000 labelled rows in 30 insert
  batches and 50,000 deletes while query micro-batches keep flowing;
  checked after every batch that crossed a compaction and at the end
  against a fresh ``MultiTableIndex`` over the same live rows, then
  repeated with ``fused_select="argmin"`` (the masked-argmin kernel);
- the paper's method: ``HyperplaneIndex`` with LBH learned on the card
  (bits 20, 1000-point sample, 150 Nesterov steps per bit, each bit one
  replay of a CUDA graph captured once per fit) answering 32
  SVM normals through its table and its scan, then 10 iterations of SVM
  active learning with all 10 one-vs-all SVMs through an LBH
  ``HashSelector``, checked against the exhaustive selector and the BH
  warm start's Gram-fit error;
- the kernel layer's remaining entry points on the serving path's codes:
  ``ops.hamming_topk_grouped(dma=True)`` (the pipelined hist kernel),
  ``ops.hamming_distances_batch`` per table followed by
  ``core.search.lex_smallest`` (the unfused route, checked against the
  fused scan) and ``ops.hamming_distances`` per query.

Then the widths past the Tiny-1M geometry: ``newsgroups_like(d=26214)``
(18,846 x 26,215, the paper's second dataset at the width the
hyperplane-hashing literature reports) through both hash kernels, and
codes of W = 13 and 32 words through the three scan kernels, each against
its plain version.

Then two more paths at full size:

- online refresh: the streaming path's index and front end take the
  labelled rows and the deletes, then ``refresh(wait=False)`` re-learns LBH
  for the 4 tables on its worker thread (each table's bits one CUDA graph
  captured there) while micro-batches, 20,000 inserts and 1,000 deletes
  keep flowing; checked against a fresh install over the same live rows
  with the adopted families, with recall@1 before and after and the
  micro-batch latencies before, during and across the swap;
- replicated shards: ``ShardReplicaRouter(shards=2, replicas=2)`` over the
  1,000,000 unlabelled rows behind ``HashQueryService(mode="scan")``; its
  healthy, fail-over, degraded and recovered (after 10,000 inserts and
  5,000 deletes with a shard down) answers checked against fresh indexes
  over the covered rows, then a ``FaultPlan.seeded`` soak of 64
  micro-batches with writes.

Then the row-sharded scan (``mesh=``), S shards co-located on the card:
the serving path's index at S = 2 and 3 (hist, and argmin at S = 3) and
its service, ``hamming_topk_sharded``, the streaming path's LSM index
with 40,000 base tombstones and 5,000 delta rows before and after a
fold, and the cluster path's router, each against the same object
without a mesh, bit for bit, with S scan launches per micro-batch.

Then the LM side at full width and depth (qwen3-1.7b: 28 layers,
d_model 2,048, 1.72 B parameters, bf16 weights from ``--seed``):

- LM serving: ``Engine.generate`` on 8 random prompts of 128 tokens, 32
  greedy tokens, twice (first-call and steady seconds, prefill ms, decode
  ms per step, tokens/s, weight and peak memory); gated in float32 (the
  decode step against teacher-forced logits, full depth, < 3e-3; the
  card against the CPU at 2 layers, < 1e-4), with bf16 against fp32
  greedy agreement reported;
- activation index (``examples/al_data_curation.py`` at full width):
  ``ActivationIndexer`` embeds 8,192 sequences of 128 tokens through the
  bf16 model, a seeded BH index (kernel 1) and an LBH index (kernels 8
  and 4) over the 2,048-wide activations answer 32 SVM probe normals
  through ``query_scan`` (kernel 2) and ``query``, each answer's margin
  held to the exhaustive minimum and the codes to the plain versions.

Then the MoE serving path at full width and depth (deepseek-moe-16b: 28
layers, d_model 2,048, 64 routed experts (top 6) and 2 shared, the first
layer dense; 16.38 B parameters in bf16 from ``--seed``):
``Engine.generate`` as above, the decode step and the prefill beside
their bounds at the data-sheet rates, the prefill's drop share at the
published capacity factor; gated at 3 layers and full width: the
dispatch's integers on the card against the CPU's on the same router ids
(bit for bit), fp32 decode against teacher-forced forward at the
drop-free capacity factor E / k (< 3e-3), the card's fp32 and bf16
forward against the CPU's.  It launches none of the eight kernels.

Each path runs with every kernel's launch count set to 0 just before it
and read just after; the kernels' JSON reports kernels 1, 2, 4 and 8 with
the activation index path's launches, 5 with the sharded path's and 3, 6
and 7 with the kernel layer's.  Every phase that fails stops the run with a
non-zero exit.  The second-to-last line of its output is the kernels' JSON
record, the last ``{"ok": true, "device": {...}}``.

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
# the streaming path: 30 insert batches of 2,000 labelled rows, 40,000
# deletes of base rows and 10,000 of inserted rows, at least 4 query
# micro-batches per insert batch
STREAM_BATCHES, STREAM_QUERIES = 30, 4
BASE_DELETES, NEW_DELETES = 40_000, 10_000
LBH_SAMPLE, LBH_STEPS, RADIUS, LBH_SCAN_L = 1000, 150, 4, 256
# the paper's second dataset at the width the hyperplane-hashing
# literature reports for 20 Newsgroups (26,214 tf-idf features + bias)
NG_D = 26_214
# the refresh path: rows inserted (in batches) and deleted while the
# refresh runs; the cluster path: micro-batches, the writes while shard 1
# is down, and the seeded fault soak's micro-batches
REFRESH_INSERTS, REFRESH_INSERT_ROWS, REFRESH_DELETES = 20_000, 500, 1_000
CLUSTER_BATCHES, CLUSTER_INSERTS, CLUSTER_DELETES = 32, 10_000, 5_000
SOAK_BATCHES = 64
# the sharded phase: rows inserted into the LSM index's delta (past
# lsm_delta_fused_rows, so the delta scans on the kernel route)
SHARD_INSERTS = 5_000
# the LM serving path (qwen3-1.7b at full width and depth): batch,
# prompt and generated tokens; the fp32 gates' sequence (prefilled half
# way), and the depth and length of the card-vs-CPU gate
LM_ARCH = "qwen3-1.7b"
LM_BATCH, LM_PROMPT, LM_GEN = 8, 128, 32
GATE_S, CUT_LAYERS, CUT_S = 128, 2, 32
# the MoE serving path (deepseek-moe-16b at full width and depth) takes
# the same batch, prompt, generated tokens and gate lengths; its gates run
# at 3 layers: the dense prelude and two stacked MoE blocks
MOE_ARCH = "deepseek-moe-16b"
MOE_CUT_LAYERS = 3
# the activation index path: sequences, their length, the embedding
# batch, probe normals and their labelled subsets, the scan's l
ACT_N, ACT_S, ACT_BATCH = 8192, 128, 64
ACT_PROBES, ACT_LABELLED, ACT_SCAN_L = 32, 64, 256
# H100 SXM data-sheet peaks (700 W): HBM rate, float32 outside the tensor
# cores, bf16 on the tensor cores (dense); popcount issues 16 results per
# clock per SM (CUDA programming guide, compute capability 9.0), at the
# card's maximum SM clock.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
POPC_PER_CLK_SM = 16


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


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


# Now and then a torch.profiler session comes back with the launches
# recorded but no kernel records; such a session is profiled again.
PROFILE_TRIES = 5
PROFILE_REPEATS = []


def device_profile(torch, fn, need=()):
    """Run fn under torch.profiler.  Returns (device-busy ms,
    {kernel name: (device ms, launches)}) from the CUDA kernel events.
    fn runs again, up to PROFILE_TRIES times in all, until the profiler
    saw device work and, for each fragment in need, a kernel whose name
    holds it; the dict is empty when no try saw device work."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = {e.key: (e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0}
        missing = [f for f in need if kernel_device_ms(kernels, f) is None]
        if kernels and not missing:
            break
        launches = sum(e.count for e in prof.key_averages()
                       if "LaunchKernel" in e.key or "cuLaunch" in e.key)
        PROFILE_REPEATS.append(dict(attempt=attempt + 1,
                                    missing=missing or ["any kernel"],
                                    seen=len(kernels), launch_calls=launches,
                                    at=round(time.perf_counter() - T0, 1)))
    return sum(ms for ms, _ in kernels.values()), kernels


def profiled_ms(torch, fn, reps: int, fragment: str | None = None):
    """Device ms per call of fn over reps calls under torch.profiler: the
    kernels whose name holds fragment, or all device work.  None if no
    try of device_profile saw them."""
    busy, kernels = device_profile(
        torch, lambda: [fn() for _ in range(reps)],
        () if fragment is None else (fragment,))
    if fragment is None:
        return busy / reps if busy > 0 else None
    return kernel_device_ms(kernels, fragment)


def ptxas_lines(log: str, fragment: str):
    """The -Xptxas -v lines of the kernels whose mangled name holds
    fragment: registers, spills, one line per instantiation."""
    out, hit = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            hit = fragment in line
        elif hit and ("registers" in line or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
    return out


def kernel_device_ms(kernels: dict, fragment: str):
    """Mean device ms per launch of the kernel whose name holds fragment
    (None: the profiler did not see it)."""
    hits = [(ms, k) for name, (ms, k) in kernels.items() if fragment in name]
    if not hits:
        return None
    return sum(ms for ms, _ in hits) / sum(k for _, k in hits)


def library_hash(x, factors):
    """Packed codes of x under materialised (u, v) factor pairs through
    the serving path's library route (``serving.batch_query``): two
    stacked strict-fp32 ``torch.matmul``s, the sign and the bit pack."""
    import torch
    from repro_torch.core.functions import _sgn, strict_fp32
    from repro_torch.utils.bits import pack_signs
    u = torch.stack([f[0] for f in factors])
    v = torch.stack([f[1] for f in factors])
    with strict_fp32():
        return pack_signs(_sgn(torch.matmul(x, u) * torch.matmul(x, v)))


def batch_diff(got, want) -> dict:
    """Entries that differ between two lists of BatchQueryResult."""
    diff = dict.fromkeys(("ids", "margins", "ids_topk", "margins_topk",
                          "table_hits", "nonempty", "candidate_lists"), 0)
    for a, b in zip(got, want, strict=True):
        for k in ("ids", "margins", "ids_topk", "margins_topk",
                  "table_hits", "nonempty"):
            diff[k] += int((getattr(a, k) != getattr(b, k)).sum())
        diff["candidate_lists"] += sum(
            not (x.shape == y.shape and (x == y).all())
            for x, y in zip(a.candidates, b.candidates, strict=True))
    return diff


def sharded_phase(args, index, lsm, router, ws, wq, x_extra, deletes,
                  zero_counts, read_counts, records, smi,
                  device="cuda:0") -> dict:
    """The row-sharded scan (``mesh=``) at full size, S shards co-located
    on one card: tiny1m-scan's index at S = 2 and 3 (and under the argmin
    select), its service, ``hamming_topk_sharded``, the streaming path's
    LSM index with base tombstones and a delta, before and after a fold,
    and the cluster path's router; every answer against the same object
    without a mesh, bit for bit.  Returns the launches of the counted
    runs (the index's and the service's micro-batches)."""
    import numpy as np
    import torch
    from repro_torch.core import search
    from repro_torch.kernels import ops
    from repro_torch.kernels.hamming import (
        hamming_topk_fused, hamming_topk_fused_plain, hamming_topk_hist,
        hamming_topk_hist_plain)
    from repro_torch.serving import batch_query as bq
    from repro_torch.serving.lsm import _pow2_at_least
    from repro_torch.serving.service import HashQueryService
    from repro_torch.utils.bits import from_numpy_u32
    from repro_torch.utils.mesh import make_mesh
    meshes = {s: make_mesh((s,), ("data",), devices=[device] * s)
              for s in (2, 3)}
    torch.cuda.reset_peak_memory_stats()
    batches = [ws[i * BATCH:(i + 1) * BATCH] for i in range(args.batches)]
    shard_launches = dict.fromkeys(read_counts(), 0)
    times = {}

    def run(mesh):
        """The micro-batches through index.query_scan_batch: results and
        host seconds per batch (each ends in host arrays)."""
        res, lat = [], []
        for wb in batches:
            t = time.perf_counter()
            res.append(index.query_scan_batch(wb, l=SCAN_L, topk=4,
                                              mesh=mesh))
            lat.append(time.perf_counter() - t)
        return res, lat

    def counted(fn):
        """fn() with every count set to 0 just before and read after."""
        zero_counts()
        out = fn()
        torch.cuda.synchronize()
        c = read_counts()
        for k, v in c.items():
            shard_launches[k] += v
        return out, c

    def rate(lat):
        return {"qps": len(lat) * BATCH / float(np.sum(lat)),
                "p95_ms": 1e3 * float(np.quantile(lat, 0.95)),
                "mean_ms": 1e3 * float(np.mean(lat))}

    index._scan_state()               # the single-device layout (set-up)
    want, lat = run(None)
    times["index_unsharded"] = rate(lat)
    nb = args.batches

    def index_at(shards, label, select="hist"):
        mesh = meshes[shards]
        rebuilds = index.scan_state_rebuilds + (index._scan_key
                                                != (mesh, "data"))
        index._scan_state(mesh, "data")   # the layout build: set-up
        uploads = index.device_uploads
        index.config.fused_select = select
        try:
            (got, lat), c = counted(lambda: run(mesh))
        finally:
            index.config.fused_select = None
        diff = batch_diff(got, want)
        check(not any(diff.values()), f"index at S = {shards} ({select}): "
              f"answers identical to the unsharded scan (differ: {diff})")
        kern = "hamming_topk_hist" if select == "hist" else \
            "hamming_topk_fused"
        other = "hamming_topk_fused" if select == "hist" else \
            "hamming_topk_hist"
        check(c["bilinear_hash_seeded"] == nb and c[kern] == shards * nb
              and c[other] == 0,
              f"index at S = {shards} ({select}): one hash and {shards} "
              f"{kern} launches per micro-batch (counts {c})")
        check(index.scan_state_rebuilds == rebuilds
              and index.device_uploads == uploads,
              f"index at S = {shards}: one layout build for the mesh, no "
              f"upload after it")
        times[label] = rate(lat)
        print(f"index at S = {shards} ({select}): {nb} micro-batches "
              f"identical to the unsharded scan; launches {c}", flush=True)

    index_at(2, "index_S2")
    # the service over the same mesh: phase 5's answers
    svc = HashQueryService(index, mode="scan", scan_l=SCAN_L,
                           mesh=meshes[2])
    svc_res, c = counted(lambda: [a for wb in batches
                                  for a in svc.query_batch(wb)])
    plain = [index.query_scan_batch(wb, l=SCAN_L) for wb in batches]
    check([a.index for a in svc_res]
          == [int(i) for r in plain for i in r.ids]
          and [a.margin for a in svc_res]
          == [float(m) for r in plain for m in r.margins],
          "the service with a mesh answers as the index without one")
    check(c["hamming_topk_hist"] == 2 * nb and c["bilinear_hash_seeded"]
          == nb, f"service at S = 2: 2 scan launches a batch ({c})")
    print(f"service at S = 2: {len(svc_res)} answers identical; launches "
          f"{c}")
    index_at(3, "index_S3")
    index_at(3, "index_S3_argmin", select="argmin")

    # one query through hamming_topk_sharded: table 0's rows (1,060,000,
    # which divide the 2 shards)
    rows0 = index.codes[0].shape[0] // 2 * 2
    codes0 = from_numpy_u32(index.codes[0][:rows0], index.device)
    qc = bq.hash_queries_all(index.families, wq)
    d1, i1 = search.hamming_topk_sharded(codes0, qc[0, 0], SCAN_L,
                                         meshes[2])
    d2, i2 = ops.hamming_topk(codes0, qc[0, 0], SCAN_L)
    check(torch.equal(d1, d2) and torch.equal(i1, i2),
          "hamming_topk_sharded at S = 2 equals ops.hamming_topk")
    print("hamming_topk_sharded at S = 2 (one query, table 0): identical")
    del codes0

    # kernels 2 and 5 against their plain versions at a shard's shape
    parts, _ = index._scan_state(meshes[3], "data")
    rows = parts[0].shape[1]
    l_local = SCAN_L + min(3 * rows - index.n, rows)
    bn = ops._block_rows(rows, 4096)
    for name, kern, plain_fn in (
            ("hamming_topk_hist", hamming_topk_hist, hamming_topk_hist_plain),
            ("hamming_topk_fused", hamming_topk_fused,
             hamming_topk_fused_plain)):
        kd, ki = kern(parts[0], qc, min(l_local, bn), bn, None, "16")
        pd, pi = plain_fn(parts[0], qc, min(l_local, bn), bn, None, "16")
        err = max(int((kd.long() - pd.long()).abs().max()),
                  int((ki.long() - pi.long()).abs().max()))
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                           err)
        check(err == 0, f"{name} at a shard's shape (G=4, n={rows}, B=32, "
              f"l={min(l_local, bn)}) equals its plain version")
        print(f"{name} at a shard's shape (n={rows}, l={min(l_local, bn)}):"
              f" identical to its plain version")
    del parts, kd, ki, pd, pi

    # the streaming path's LSM index: base tombstones and a delta
    lrng = np.random.default_rng(args.seed + 5)
    seg = lsm.segments()
    check(seg["delta_rows"] == 0 and not seg["compaction_active"],
          "the LSM index starts folded")
    lsm.delete(lrng.choice(lsm.ids_np[:seg["base_rows"]], deletes,
                           replace=False))
    lsm.insert(x_extra)
    seg = lsm.segments()
    check(seg["delta_rows"] == x_extra.shape[0]
          and not seg["compaction_active"],
          "the deletes and the inserts began no fold")
    depth = min(_pow2_at_least(SCAN_L + deletes),
                _pow2_at_least(seg["base_rows"], 64))

    def lsm_same(key, label):
        lsm.query_scan_batch(wq, l=SCAN_L, topk=4, mesh=meshes[2])  # warm
        d_m, i_m = lsm.scan_table_topk(wq, l=SCAN_L, mesh=meshes[2])
        d_n, i_n = lsm.scan_table_topk(wq, l=SCAN_L)
        check(np.array_equal(d_m, d_n) and np.array_equal(i_m, i_n),
              f"LSM {label}: per-table lists with a mesh equal those "
              f"without")
        zero_counts()
        a = lsm.query_scan_batch(wq, l=SCAN_L, topk=4, mesh=meshes[2])
        torch.cuda.synchronize()
        c = read_counts()
        b = lsm.query_scan_batch(wq, l=SCAN_L, topk=4)
        diff = batch_diff([a], [b])
        check(not any(diff.values()), f"LSM {label}: answers with a mesh "
              f"equal those without (differ: {diff})")
        delta = lsm.segments()["delta_rows"]
        scans = 2 + (delta >= lsm.config.lsm_delta_fused_rows)
        check(c["hamming_topk_hist"] == scans
              and c["bilinear_hash_seeded"] == 1,
              f"LSM {label}: {scans} scan launches ({c})")
        lat_m, lat_n = [], []
        for _ in range(5):
            t = time.perf_counter()
            lsm.query_scan_batch(wq, l=SCAN_L, topk=4, mesh=meshes[2])
            lat_m.append(time.perf_counter() - t)
            t = time.perf_counter()
            lsm.query_scan_batch(wq, l=SCAN_L, topk=4)
            lat_n.append(time.perf_counter() - t)
        times[key] = {"mesh_batch_ms": 1e3 * float(np.mean(lat_m)),
                      "batch_ms": 1e3 * float(np.mean(lat_n))}
        print(f"LSM {label} (base {lsm.segments()['base_rows']}, delta "
              f"{delta}): lists and answers with a mesh identical; "
              f"launches {c}", flush=True)

    lsm_same("lsm_tombstones", f"with {deletes} base tombstones (overscan "
             f"depth {depth})")
    rebuilds = lsm.scan_state_rebuilds
    lsm.compact()
    check(lsm.segments()["delta_rows"] == 0, "the fold took the delta")
    lsm_same("lsm_folded", "after a fold")
    check(lsm.scan_state_rebuilds >= rebuilds + 1,
          "a mesh query after the fold rebuilt the sharded layout")

    # the cluster path's router: each replica's scan row-sharded
    for s in range(router.shards):
        for r in range(router.replicas):
            router.replica(s, r).scan_table_topk(wq, l=SCAN_L,
                                                 mesh=meshes[2])  # warm
    t_router = {}
    for label, mesh in (("mesh", meshes[2]), ("plain", None)):
        for _ in range(2):     # the first call may rebuild a layout
            t = time.perf_counter()
            res = router.query_scan_batch(wq, l=SCAN_L, topk=4, mesh=mesh)
            t_router[label] = time.perf_counter() - t
        if mesh is None:
            b = res
        else:
            a = res
    diff = batch_diff([a], [b])
    check(a.coverage == b.coverage == 1.0 and not any(diff.values()),
          f"router: answers with a mesh equal those without (coverage "
          f"{a.coverage} / {b.coverage}, differ: {diff})")
    times["router"] = {"mesh_batch_ms": 1e3 * t_router["mesh"],
                       "batch_ms": 1e3 * t_router["plain"]}
    print("router (2 x 2) with a mesh of 2: answers identical")
    times["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print("sharded scan: " + json.dumps(times))
    print(f"card: {smi}")
    print(f"launches on the sharded path (index and service runs): "
          f"{shard_launches}")
    return shard_launches


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rel_err(got, want) -> float:
    """max|got - want| / max|want| over two tensors (on any devices)."""
    got = got.float().cpu()
    want = want.float().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


def serve_timed(cfg, model, prompts, gen, dev, stats):
    """Engine.generate twice on prompts (greedy; the two must agree), then
    the same loop with each step timed alone (host clock around a step
    that ends in a synchronise) and, on the card, one decode step and one
    prefill under torch.profiler.  Fills stats; returns the engine and
    the generated tokens."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import Engine
    batch, prompt = prompts.shape
    cuda = dev.type == "cuda"
    engine = Engine(cfg, model, max_len=prompt + gen, device=dev)
    outs = []
    for label in ("first", "steady"):
        t0 = time.perf_counter()
        outs.append(engine.generate(prompts, gen))
        _sync(torch, dev)
        stats[f"{label}_s"] = time.perf_counter() - t0
    out = outs[1]
    check(tuple(out.shape) == (batch, gen) and torch.equal(outs[0], out),
          "greedy generation has its shape and repeats itself")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generated tokens lie in the vocabulary")
    stats["tokens_per_s"] = batch * gen / stats["steady_s"]

    with torch.inference_mode():
        _sync(torch, dev)
        t0 = time.perf_counter()
        last, caches = engine.prefill_step(model, {"tokens": prompts})
        nxt = torch.argmax(last, dim=-1)
        _sync(torch, dev)
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        check(last.dtype == torch.bfloat16
              and all(c[kv].dtype == torch.bfloat16 for c in caches
                      for kv in ("k", "v")),
              "bf16 weights give bf16 logits and KV caches")
        steps, step_ms = [nxt], []
        for i in range(gen - 1):
            t0 = time.perf_counter()
            nxt, caches = engine.serve_step(model, caches, nxt, prompt + i)
            _sync(torch, dev)
            step_ms.append(1e3 * (time.perf_counter() - t0))
            steps.append(nxt)
    check(torch.equal(torch.stack(steps, 1), out),
          "the timed steps produce generate's tokens")
    if cuda:
        # where a step's time goes: the device's own work against the
        # host clock (the last slot rewritten, same shapes)
        for label, fn, wall in (
                ("decode step", lambda: engine.serve_step(
                    model, caches, nxt, prompt + gen - 1),
                 float(np.quantile(step_ms, 0.5))),
                ("prefill", lambda: engine.prefill_step(
                    model, {"tokens": prompts}), prefill_ms)):
            busy, prof = device_profile(torch, fn)
            top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:4]
            stats[f"{label.split()[0]}_device_ms"] = busy
            stats[f"{label.split()[0]}_kernels"] = sum(
                k for _, k in prof.values())
            print(f"{label} under torch.profiler: device busy {busy:.3f} "
                  f"ms of {wall:.3f} ms (idle share "
                  f"{1 - busy / wall:.3f}), "
                  f"{stats[label.split()[0] + '_kernels']} kernel launches; "
                  f"largest: " + json.dumps(
                      {k[:60]: round(v[0], 4) for k, v in top}))
    del caches
    stats.update(prefill_ms=prefill_ms,
                 decode_p50_ms=float(np.quantile(step_ms, 0.5)),
                 decode_p95_ms=float(np.quantile(step_ms, 0.95)))
    if cuda:
        stats["peak_serving_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"Engine.generate (B {batch}, prompt {prompt}, {gen} greedy "
          f"tokens, max_len {prompt + gen}): first call "
          f"{stats['first_s']:.3f} s, steady {stats['steady_s']:.3f} s = "
          f"{stats['tokens_per_s']:.1f} generated tokens/s; prefill "
          f"{prefill_ms:.3f} ms; decode step p50 "
          f"{stats['decode_p50_ms']:.3f} ms, p95 "
          f"{stats['decode_p95_ms']:.3f} ms ({gen - 1} steps); weights "
          f"{stats['weight_gib']:.3f} GiB; peak device "
          f"{stats.get('peak_serving_gib', float('nan')):.3f} GiB")
    return engine, out


def init_model(args, cfg, dev, stats):
    """cfg's parameter tree in bf16 from ``--seed`` on dev, and the model
    holding it (views, no copy).  Returns (tree, model, generator)."""
    import torch
    from repro_torch.models import Transformer, init_params, model_spec
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    tree = init_params(model_spec(cfg), torch.bfloat16, generator=g,
                       device=dev)
    model = Transformer(cfg, tree)
    _sync(torch, dev)
    n_params = sum(p.numel() for p in model.parameters())
    stats["weight_gib"] = sum(p.numel() * p.element_size()
                              for p in model.parameters()) / 2**30
    stats["params"] = n_params
    ff = (f"d_ff {cfg.d_ff}" if not cfg.num_experts else
          f"{cfg.num_experts} experts (top {cfg.experts_per_token}) + "
          f"{cfg.num_shared_experts} shared, moe_d_ff {cfg.moe_d_ff}, "
          f"{cfg.first_dense_layers} dense layer of d_ff {cfg.d_ff}")
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} / {cfg.num_kv_heads} heads, {ff}, "
          f"vocab {cfg.vocab_size}: {n_params} parameters, "
          f"{stats['weight_gib']:.3f} GiB in bf16, initialised in "
          f"{time.perf_counter() - t0:.2f} s")
    return tree, model, g


def cut_gates(cfg, tree, layers, tok, dev, stats):
    """The gates at ``layers`` layers (the stacked body cut): the card's
    fp32 forward logits against the CPU's (< 1e-4), and its bf16 logits
    nearer the CPU's bf16 logits than CPU bf16 lies to CPU fp32."""
    import dataclasses

    import torch
    from repro_torch.core.functions import strict_fp32
    from repro_torch.models import Transformer, forward
    from repro_torch.models.layers import tree_map
    cut = dataclasses.replace(cfg, num_layers=layers)
    n_body = layers - len(tree.get("prelude", []))
    tree_cut = dict(tree, body=tree_map(lambda t: t[:n_body], tree["body"]))
    b, s = tok.shape
    logits = {}
    with strict_fp32(), torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            for where, t in ((dev, tok), (torch.device("cpu"), tok.cpu())):
                logits[dt, where.type] = forward(
                    cut, Transformer(cut, tree_cut, dtype=dt, device=where),
                    {"tokens": t})[0]
    f32, b16 = torch.float32, torch.bfloat16
    err_cpu = rel_err(logits[f32, dev.type], logits[f32, "cpu"])
    print(f"fp32 gate, {layers} layers (B {b}, S {s}): {dev} vs CPU "
          f"forward logits: relative error {err_cpu}")
    check(err_cpu < 1e-4, f"{dev} forward matches the CPU within 1e-4")
    # the CPU's bf16 forward is held to the JAX package's bf16 forward by
    # tests/test_torch_models.py; the card's must stay nearer to it than
    # bf16 itself is to fp32 (the lower-precision control)
    err16_cpu = rel_err(logits[b16, dev.type], logits[b16, "cpu"])
    ctl16 = rel_err(logits[b16, "cpu"], logits[f32, "cpu"])
    err16_32 = rel_err(logits[b16, dev.type], logits[f32, dev.type])
    print(f"bf16 gate, {layers} layers (B {b}, S {s}): {dev} vs CPU "
          f"bf16 forward logits: relative error {err16_cpu}; control, CPU "
          f"bf16 vs fp32: {ctl16}; {dev} bf16 vs fp32: {err16_32}")
    check(all(v.dtype == k[0] for k, v in logits.items()),
          "each forward's logits come in its weights' dtype")
    check(err16_cpu <= ctl16, f"{dev} bf16 forward is nearer the CPU's bf16 "
          f"forward than bf16 is to fp32")
    stats.update(err_cpu=err_cpu, err16_cpu=err16_cpu, bf16_control=ctl16,
                 err16_fp32=err16_32)
    return tree_cut


def decode_gate(cfg, model32, tok, dev):
    """fp32 decode step (prefilled half way) against the teacher-forced
    logits at that position; returns the relative error."""
    import torch
    from repro_torch.core.functions import strict_fp32
    from repro_torch.models import decode_step, forward
    half = tok.shape[1] // 2
    with strict_fp32(), torch.inference_mode():
        _, caches, _ = forward(cfg, model32, {"tokens": tok[:, :half]},
                               mode="prefill", cache_len=tok.shape[1])
        dec, _ = decode_step(cfg, model32, tok[:, half], caches, half)
        full, _, _ = forward(cfg, model32, {"tokens": tok})
    return rel_err(dec, full[:, half])


def lm_phase(args, cfg, dev):
    """The LM serving path at cfg's full width and depth: bf16 weights
    from ``--seed``, ``Engine.generate`` twice on LM_BATCH random prompts
    (greedy), then the per-step times; the fp32 gates (decode against
    teacher-forced forward at full depth; card against CPU at CUT_LAYERS
    layers), the bf16 gate (card against CPU at CUT_LAYERS layers, bounded
    by bf16's own distance from fp32) and bf16 against fp32 greedy
    agreement.  Sizes are the module's constants.  Returns the bf16 model
    and its stats."""
    import numpy as np
    import torch
    from repro_torch.models import Transformer
    from repro_torch.serve.engine import Engine
    batch, prompt, gen = LM_BATCH, LM_PROMPT, LM_GEN
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    stats = {}
    tree, model, g = init_model(args, cfg, dev, stats)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                            device=dev)
    _, out = serve_timed(cfg, model, prompts, gen, dev, stats)

    # gate: decode step against teacher-forced logits, fp32, full depth
    model32 = Transformer(cfg, tree, dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab_size, (2, GATE_S), generator=g,
                        device=dev)
    err_dec = decode_gate(cfg, model32, tok, dev)
    print(f"fp32 gate, full depth (B 2, S {GATE_S}, prefill "
          f"{GATE_S // 2}): decode step vs teacher-forced logits at "
          f"position {GATE_S // 2}: relative error {err_dec}")
    check(err_dec < 3e-3, "decode matches forward within 3e-3 (fp32)")

    # gates: card against CPU at the cut depth, fp32 and bf16
    cut_gates(cfg, tree, CUT_LAYERS, tok[:, :CUT_S], dev, stats)

    # report: bf16 against fp32 greedy tokens on the same prompts
    out32 = Engine(cfg, model32, max_len=prompt + gen,
                   device=dev).generate(prompts, gen)
    same = (out32 == out).float().mean().item()
    first_diff = [int(np.flatnonzero(r)[0]) if r.any() else None
                  for r in (out32 != out).cpu().numpy()]
    stats.update(bf16_fp32_agreement=same, err_decode=err_dec)
    if cuda:
        stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"bf16 vs fp32 greedy tokens: {same:.4f} of {batch * gen} agree; "
          f"first differing step per row {first_diff}; peak device "
          f"{stats.get('peak_gib', float('nan')):.3f} GiB (with the fp32 "
          f"copy)")
    del model32, out32
    if cuda:
        torch.cuda.empty_cache()
    return model, stats


def moe_bounds(cfg, model, batch, prompt, gen):
    """The least times of one decode step and of the prefill on the card
    at the data-sheet rates: every weight read once (the embedding's
    batch rows only; the KV caches' filled slots too) over HBM_BYTES_S,
    and the matmul operations as the reference computes them (the expert
    products over the whole (E, B, cap, D) buffer) over BF16_FLOP_S.  A
    decode step is the median one: its caches hold prompt + gen // 2
    positions.  Returns {name: (ms, bound_by, bytes, flops)}."""
    from repro_torch.models.moe import capacity
    d, v = cfg.d_model, cfg.vocab_size
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    embed_bytes = model.embed.numel() * model.embed.element_size()
    kv_row = 2 * cfg.num_kv_heads * cfg.head_dim * 2      # k and v, bf16
    attn_w = (2 * cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim * d
    n_moe = cfg.num_layers - cfg.first_dense_layers

    def flops(s, ctx):
        t = batch * s
        e, f = cfg.num_experts, cfg.moe_d_ff
        out = 2 * t * attn_w * cfg.num_layers                 # projections
        out += 4 * batch * cfg.num_heads * cfg.head_dim * s * ctx \
            * cfg.num_layers                                  # scores, PV
        out += 2 * t * 3 * d * cfg.d_ff * cfg.first_dense_layers
        out += n_moe * (2 * e * batch * capacity(cfg, s) * 3 * d * f
                        + 2 * t * 3 * d * cfg.num_shared_experts * f
                        + 2 * t * d * e)                      # router
        return out + 2 * t * d * v                            # unembed

    out = {}
    for name, s, ctx, kv in (
            ("decode", 1, prompt + gen // 2, prompt + gen // 2),
            ("prefill", prompt, prompt, prompt)):
        nbytes = (wbytes - embed_bytes + batch * s * d * 2
                  + kv * batch * kv_row * cfg.num_layers)
        fl = flops(s, ctx)
        t_bytes, t_ops = nbytes / HBM_BYTES_S, fl / BF16_FLOP_S
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, fl)
    return out


def moe_phase(args, cfg, dev, zero_counts, read_counts):
    """The MoE serving path at cfg's full width and depth (bf16 weights
    from ``--seed``): ``Engine.generate`` twice, the per-step times beside
    their bounds, the prefill's drop share at the published capacity
    factor; then, at MOE_CUT_LAYERS layers (the dense prelude and two
    stacked MoE blocks) at full width: the dispatch's integers on the card
    against the CPU's on the same router ids, bit for bit; fp32 decode
    against teacher-forced forward at the drop-free capacity factor E / k
    (< 3e-3); the card's fp32 and bf16 forward against the CPU's
    (``cut_gates``).  No kernel of the table runs: every count stays 0.
    Returns its stats."""
    import dataclasses

    import torch
    from repro_torch.core.functions import strict_fp32
    from repro_torch.models import Transformer, forward, moe
    batch, prompt, gen = LM_BATCH, LM_PROMPT, LM_GEN
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    stats = {}
    tree, model, g = init_model(args, cfg, dev, stats)
    if cuda:
        stats["peak_init_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"peak device memory while the weights were drawn "
              f"{stats['peak_init_gib']:.3f} GiB")
        torch.cuda.reset_peak_memory_stats()
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                            device=dev)
    engine, _ = serve_timed(cfg, model, prompts, gen, dev, stats)
    bounds = moe_bounds(cfg, model, batch, prompt, gen)
    for name, key in (("decode", "decode_p50_ms"), ("prefill", "prefill_ms")):
        ms, by, nbytes, fl = bounds[name]
        stats[f"{name}_bound_ms"] = ms
        print(f"{name} bound {ms:.3f} ms ({by}: {nbytes / 1e9:.2f} GB at "
              f"{HBM_BYTES_S / 1e12:.2f} TB/s, {fl / 1e12:.3f} TFLOP at "
              f"{BF16_FLOP_S / 1e12:.0f} TFLOP/s bf16); measured "
              f"{stats[key]:.3f} ms host clock"
              + (f", {stats[name + '_device_ms']:.3f} ms device busy"
                 if cuda else ""))
    launched = read_counts()
    check(not any(launched.values()), f"the MoE path launches none of the "
          f"eight kernels: {launched}")
    print("the MoE path launched none of the eight kernels of the table "
          "(their launch counts stayed 0 through it)")

    # the prefill's dispatches: drop share, and the integers against the
    # CPU's on the same router ids
    seen = []
    dispatch = moe._dispatch

    def recording(cfg_, ids):
        out = dispatch(cfg_, ids)
        seen.append((ids, out))
        return out

    moe._dispatch = recording
    try:
        engine.prefill_step(model, {"tokens": prompts})
    finally:
        moe._dispatch = dispatch
    n_moe = cfg.num_layers - cfg.first_dense_layers
    check(len(seen) == n_moe, f"one dispatch per MoE layer ({len(seen)})")
    dropped = sum(int((~v).sum()) for _, (_, _, _, v) in seen)
    assigned = sum(v.numel() for _, (_, _, _, v) in seen)
    mismatch = 0
    for ids, got in seen:
        want = dispatch(cfg, ids.cpu())
        mismatch += sum(int((a.cpu() != b).sum())
                        for a, b in zip(got, want, strict=True))
    stats.update(drop_share=dropped / assigned, dispatch_mismatch=mismatch,
                 capacity_prefill=moe.capacity(cfg, prompt),
                 capacity_decode=moe.capacity(cfg, 1))
    print(f"prefill dispatch (capacity factor {cfg.capacity_factor}, "
          f"{stats['capacity_prefill']} slots per expert and row; decode "
          f"{stats['capacity_decode']}): {dropped} of {assigned} "
          f"assignments dropped over {n_moe} MoE layers, share "
          f"{dropped / assigned:.5f}; {dev} vs CPU dispatch (sort_idx, "
          f"tok, slot, valid) on the same router ids: {mismatch} entries "
          f"differ")
    check(mismatch == 0, "the dispatch's integers match the CPU's bit for "
          "bit")
    del seen, engine
    if cuda:
        stats["peak_serving_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # gates at the cut depth, full width
    tok = torch.randint(0, cfg.vocab_size, (2, GATE_S), generator=g,
                        device=dev)
    tree_cut = cut_gates(cfg, tree, MOE_CUT_LAYERS, tok[:, :CUT_S], dev,
                         stats)
    # what float32 rounding alone does at this depth: the CPU's logits
    # when its embedding moves by one rounding (2^-24 relative)
    cut = dataclasses.replace(cfg, num_layers=MOE_CUT_LAYERS)
    cpu32 = Transformer(cut, tree_cut, dtype=torch.float32, device="cpu")
    sign = torch.randint(0, 2, cpu32.embed.shape,
                         generator=torch.Generator().manual_seed(args.seed))
    with strict_fp32(), torch.inference_mode():
        batch_cpu = {"tokens": tok[:, :CUT_S].cpu()}
        base = forward(cut, cpu32, batch_cpu)[0]
        cpu32.embed.mul_(1 + 2.0 ** -24 * (2 * sign - 1))
        moved = forward(cut, cpu32, batch_cpu)[0]
    stats["fp32_conditioning"] = rel_err(moved, base)
    del cpu32, base, moved
    print(f"fp32 conditioning, {MOE_CUT_LAYERS} layers (B 2, S {CUT_S}): "
          f"the CPU's forward logits move by {stats['fp32_conditioning']} "
          f"when the embedding moves by one float32 rounding (reported "
          f"beside the card-vs-CPU error above)")
    nodrop = dataclasses.replace(
        cfg, num_layers=MOE_CUT_LAYERS,
        capacity_factor=cfg.num_experts / cfg.experts_per_token)
    check(moe.capacity(nodrop, GATE_S) >= GATE_S,
          "the drop-free factor gives every token a slot")
    model32 = Transformer(nodrop, tree_cut, dtype=torch.float32)
    err_dec = decode_gate(nodrop, model32, tok, dev)
    del model32
    published = dataclasses.replace(nodrop,
                                    capacity_factor=cfg.capacity_factor)
    err_pub = decode_gate(published, Transformer(
        published, tree_cut, dtype=torch.float32), tok, dev)
    print(f"fp32 gate, {MOE_CUT_LAYERS} layers (B 2, S {GATE_S}, prefill "
          f"{GATE_S // 2}): decode step vs teacher-forced logits at "
          f"position {GATE_S // 2}, capacity factor "
          f"{nodrop.capacity_factor:.4f} (drop-free): relative error "
          f"{err_dec}; at the published {cfg.capacity_factor} (drops in "
          f"the forward, none in decode; reported): {err_pub}")
    check(err_dec < 3e-3, "decode matches forward within 3e-3 (fp32, "
          "drop-free)")
    stats.update(err_decode=err_dec, err_decode_published=err_pub)
    if cuda:
        stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, tree, tree_cut
    if cuda:
        torch.cuda.empty_cache()
    return stats


def activation_phase(args, cfg, model, dev, zero_counts, read_counts,
                     records):
    """The activation index path (``examples/al_data_curation.py`` at full
    width): ACT_N sequences of ACT_S tokens from two token-range domains
    embedded through the bf16 model by ``ActivationIndexer``, a seeded BH
    index (kernel 1) and an LBH index (kernels 8 and 4) over the
    activations, each queried with SVM probe normals through
    ``query_scan`` (kernel 2) and ``query``.  Afterwards, uncounted, kernel
    2 at this path's shapes and every ``query_scan`` answer against the
    plain route (records["hamming_topk_hist"]["max_abs_err"] takes the
    largest difference), the codes against the plain hashes.  Sizes are
    the module's constants.  Returns (launches, stats)."""
    import numpy as np
    import torch
    from repro_torch.core import search
    from repro_torch.core.functions import strict_fp32
    from repro_torch.core.indexer import (ActivationIndexer, HyperplaneIndex,
                                          IndexConfig)
    from repro_torch.kernels import ops
    from repro_torch.kernels.bilinear_hash import (
        bilinear_hash, bilinear_hash_plain, bilinear_hash_seeded_plain)
    from repro_torch.kernels.hamming import (hamming_topk_hist,
                                             hamming_topk_hist_plain)
    from repro_torch.kernels.ref import sign_flip_ratios
    from repro_torch.models import forward
    from repro_torch.svm.linear_svm import train_svm
    n, s, batch, probes = ACT_N, ACT_S, ACT_BATCH, ACT_PROBES
    labelled, scan_l = ACT_LABELLED, ACT_SCAN_L
    lbh_sample, lbh_steps = LBH_SAMPLE, LBH_STEPS
    pick_l = 32
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(args.seed + 20)
    domain = rng.integers(0, 2, n)
    lo = np.where(domain == 0, 0, cfg.vocab_size // 2)
    corpus = torch.from_numpy(rng.integers(0, cfg.vocab_size // 2, (n, s))
                              + lo[:, None]).to(dev)

    @torch.inference_mode()
    def embed(tokens):
        _, _, aux = forward(cfg, model, {"tokens": tokens},
                            return_logits=False)
        return aux["normed"].float().mean(dim=1)

    stats = {}
    zero_counts()
    ai = ActivationIndexer(embed, IndexConfig(method="bh", bits=BITS,
                                              radius=RADIUS),
                           batch_size=batch, device=dev)
    idx_bh = ai.build(corpus)
    emb = ai.embeddings
    d = emb.shape[1]
    stats.update(embed_s=ai.embed_s, seq_per_s=n / ai.embed_s,
                 tok_per_s=n * s / ai.embed_s, bh_fit_s=idx_bh.fit_s)
    print(f"ActivationIndexer: {n} sequences x {s} tokens through the bf16 "
          f"{cfg.name} (batches of {batch}) in {ai.embed_s:.3f} s = "
          f"{stats['seq_per_s']:.1f} sequences/s, {stats['tok_per_s']:.0f} "
          f"tokens/s; embeddings {tuple(emb.shape)} float32; seeded BH "
          f"fit {idx_bh.fit_s:.3f} s")
    check(bool(torch.isfinite(emb).all()), "the activations are finite")
    if cuda:
        wall = 1e3 * ai.embed_s * batch / n
        busy, prof = device_profile(torch, lambda: embed(corpus[:batch]))
        top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:4]
        stats["embed_batch_device_ms"] = busy
        print(f"one embedding batch ({batch} x {s}) under torch.profiler: "
              f"device busy {busy:.3f} ms of {wall:.3f} ms per batch (idle "
              f"share {1 - busy / wall:.3f}); largest: " + json.dumps(
                  {k[:60]: round(v[0], 4) for k, v in top}))
    lcfg = IndexConfig(method="lbh", bits=BITS, radius=RADIUS,
                       lbh_sample=lbh_sample, lbh_steps=lbh_steps)
    idx_lbh = HyperplaneIndex(lcfg, device=dev).fit(emb)
    stats["lbh_fit_s"] = idx_lbh.fit_s
    print(f"LBH fit over the activations (sample {lbh_sample}, {lbh_steps} "
          f"steps x {BITS} bits): {idx_lbh.fit_s:.3f} s")

    # probe normals: SVMs on random labelled subsets, domain labels
    y = torch.from_numpy(np.where(domain == 0, -1.0, 1.0).astype(
        np.float32)).to(dev)
    normals = []
    for _ in range(probes):
        mask = torch.zeros(n, device=dev)
        mask[torch.from_numpy(rng.choice(n, labelled, replace=False)).to(
            dev)] = 1
        normals.append(train_svm(torch.zeros(d, device=dev), emb, y, mask,
                                 steps=200, lr=0.5))
    w_all = torch.stack(normals)
    norms = torch.linalg.vector_norm(w_all, dim=1)
    with strict_fp32():
        exact = (emb @ w_all.T).abs() / norms              # (n, probes)
    m_min = exact.min(dim=0).values
    scale = (d + 8) * 2.0 ** -23
    answers = {}
    for name, idx in (("bh", idx_bh), ("lbh", idx_lbh)):
        scans, scan_ms = [], []
        answers[name] = scans
        for w in w_all:
            _sync(torch, dev)
            t0 = time.perf_counter()
            scans.append(idx.query_scan(w, scan_l))
            scan_ms.append(1e3 * (time.perf_counter() - t0))
        looked = [idx.query(w) for w in w_all]
        ranks = []
        for j, ((i_k, m_k), res) in enumerate(zip(scans, looked)):
            for i_a, m_a in ((i_k, m_k), (res.index, res.margin)):
                if i_a < 0:
                    continue
                tol = scale * (emb[i_a] * w_all[j]).abs().sum().item() * 2 \
                    / norms[j].item()
                check(m_a >= m_min[j].item() - tol,
                      f"{name}: every answer's margin >= the exhaustive "
                      f"minimum")
            ranks.append(int((exact[:, j] < exact[i_k, j]).sum()) + 1)
        recall = float(np.mean([r == 1 for r in ranks]))
        stats[name] = dict(scan_p50_ms=float(np.quantile(scan_ms, 0.5)),
                           recall_at_1=recall,
                           mean_rank=float(np.mean(ranks)),
                           nonempty=sum(r.nonempty for r in looked))
        print(f"{name} index, {probes} probe normals: query_scan (l "
              f"{scan_l}) p50 {stats[name]['scan_p50_ms']:.3f} ms; "
              f"recall@1 {recall} against the exhaustive answer, mean rank "
              f"{stats[name]['mean_rank']} of {n}; probe lookups nonempty "
              f"{stats[name]['nonempty']} of {probes}; mean margin scan "
              f"{np.mean([m for _, m in scans])}, exhaustive "
              f"{m_min.mean().item()}")

    # the example's curation: one probe on 24 labelled, 8 picks through
    # the LBH index's scan, each pick then pushed out of reach
    mask = torch.zeros(n, device=dev)
    mask[torch.from_numpy(rng.choice(n, 24, replace=False)).to(dev)] = 1
    w = train_svm(torch.zeros(d, device=dev), emb, y, mask, steps=200,
                  lr=0.5)
    with strict_fp32():
        pool = ((emb @ w).abs() / torch.linalg.vector_norm(w)).mean().item()
    idx_lbh.x = emb.clone()
    picks = []
    for _ in range(8):
        i, m = idx_lbh.query_scan(w, pick_l)
        picks.append((i, m))
        idx_lbh.x[i] = 1e3
    idx_lbh.x = emb
    _sync(torch, dev)
    launches = read_counts()
    stats["pick_margin_mean"] = float(np.mean([m for _, m in picks]))
    stats["pool_margin_mean"] = pool
    print("curation picks (idx, margin): "
          + str([(i, round(m, 5)) for i, m in picks])
          + f"; mean margin {stats['pick_margin_mean']} vs pool mean {pool}")
    print(f"launches on the activation index path: {launches}")
    for kern in ("bilinear_hash_seeded", "hamming_topk_hist",
                 "bilinear_hash", "lbh_chain"):
        check(not cuda or launches[kern] > 0,
              f"{kern} launched on the activation index path")

    # kernel 2 at this path's shapes against its plain version (not
    # counted): for each probe's query code, the per-block select and the
    # merged top-l at l = scan_l, and query_scan's (id, margin) against the
    # plain route's (plain scan, then the same re-rank), bit for bit; then
    # the curation normal at l = pick_l, its 8 picks replayed
    def plain_route(idx, x, w, l):
        qcode = idx.family.hash_query(w[None, :])[0]
        _, ids = search.hamming_topk(idx.codes, qcode, l)
        margins, ids = search.margin_rerank(x, w, ids[:min(l, n)], 1)
        return int(ids[0]), float(margins[0])

    bn = ops._block_rows(n, 4096)
    k2_err = 0

    def k2_case(label, idx, w, l):
        nonlocal k2_err
        qcode = idx.family.hash_query(w[None, :])[0]
        pack = search.env_cand_pack(idx.config.cand_pack)
        args2 = (idx.codes[None], qcode[None, None], min(l, bn), bn, None,
                 pack)
        pairs = list(zip(hamming_topk_hist(*args2),
                         hamming_topk_hist_plain(*args2)))
        pairs += list(zip(ops.hamming_topk(idx.codes, qcode, l, pack=pack),
                          search.hamming_topk(idx.codes, qcode, l)))
        for a, b in pairs:
            k2_err = max(k2_err, int((a.long() - b.long()).abs().max()))
            check(torch.equal(a, b), f"{label}: kernel 2 (n {n}, l {l}, "
                  f"block_n {bn}) equals its plain version")

    for name, idx in (("bh", idx_bh), ("lbh", idx_lbh)):
        for j, w_j in enumerate(w_all):
            k2_case(f"{name} probe {j}", idx, w_j, scan_l)
            check(answers[name][j] == plain_route(idx, emb, w_j, scan_l),
                  f"{name} probe {j}: query_scan's (id, margin) equals the "
                  f"plain route's")
    k2_case("curation normal", idx_lbh, w, pick_l)
    x_pick = emb.clone()
    for k, (i, m) in enumerate(picks):
        check((i, m) == plain_route(idx_lbh, x_pick, w, pick_l),
              f"curation pick {k}: (id, margin) equals the plain route's")
        x_pick[i] = 1e3
    del x_pick
    rec = records["hamming_topk_hist"]
    rec["max_abs_err"] = max(rec["max_abs_err"], k2_err)
    print(f"kernel 2 at the activation path's shapes (G = B = 1, n {n}, "
          f"block_n {bn}, l {scan_l} x {2 * probes} query codes, l {pick_l} "
          f"x 1): block output and merged top-l identical to the plain "
          f"versions; all {2 * probes} query_scan answers and {len(picks)} "
          f"picks identical to the plain route's")

    # codes from the card kernels against the plain versions (not counted)
    fam = idx_bh.family
    r_bh = sign_flip_ratios(emb, [(fam.u, fam.v)], idx_bh.codes[None],
                            bilinear_hash_seeded_plain(emb, [fam.seed],
                                                       BITS))
    lf = idx_lbh.family
    r_lbh = sign_flip_ratios(emb, [(lf.u, lf.v)], idx_lbh.codes[None],
                             bilinear_hash_plain(emb, lf.u, lf.v)[None])
    print(f"codes vs the plain versions at d = {d}: seeded BH "
          f"{r_bh.numel()} of {n * BITS} bits differ, LBH {r_lbh.numel()}")
    check(bool((r_bh <= 1.0).all()) and bool((r_lbh <= 1.0).all()),
          "every differing activation-code bit lies within the near-zero "
          "bound")
    if cuda:
        k4_ms = cuda_ms(torch, lambda: bilinear_hash(emb, lf.u, lf.v), 20)
        k4_plain_ms = cuda_ms(
            torch, lambda: bilinear_hash_plain(emb, lf.u, lf.v), 10)
        k4_lib_ms = cuda_ms(torch, lambda: library_hash(emb, [(lf.u, lf.v)]),
                            10)
        k4_dev_ms = profiled_ms(torch, lambda: bilinear_hash(emb, lf.u, lf.v),
                                5, "bilinear_hash_kernel")
        t_bytes = (n * d * 4 + 2 * d * BITS * 4 + n * 4) / HBM_BYTES_S
        t_ops = 4 * n * d * BITS / FP32_FLOP_S
        k4_bound = 1e3 * max(t_bytes, t_ops)
        stats["k4"] = dict(ms=k4_ms, device_ms=k4_dev_ms,
                           plain_ms=k4_plain_ms, library_ms=k4_lib_ms,
                           bound_ms=k4_bound,
                           bound_by="operations" if t_ops > t_bytes
                           else "bytes")
        print(f"kernel 4 at the activation shape ({n} x {d}, k {BITS}): "
              f"{k4_ms} ms (CUDA events), device "
              f"{'not measured' if k4_dev_ms is None else k4_dev_ms} ms "
              f"(torch.profiler), plain {k4_plain_ms} ms, library route "
              f"{k4_lib_ms} ms, bound {k4_bound} ms "
              f"({stats['k4']['bound_by']})")
    return launches, stats


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
    from repro_torch.core import learning, search
    from repro_torch.core.functions import (_sgn, bilinear_signs,
                                            seeded_projections, strict_fp32,
                                            table_seed)
    from repro_torch.core.indexer import HyperplaneIndex, IndexConfig
    from repro_torch.core.tables import SingleHashTable
    from repro_torch.data.synthetic import newsgroups_like, tiny1m_like
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.bilinear_hash import (
        FACTORS_LIBRARY, LIBRARY as HASH_LIB, bilinear_hash,
        bilinear_hash_plain, bilinear_hash_seeded,
        bilinear_hash_seeded_plain)
    from repro_torch.kernels.hamming import (
        DISTANCE_LIBRARY, FUSED_LIBRARY, LIBRARY as SCAN_LIB, cand_encoding,
        hamming_distance, hamming_distance_batch,
        hamming_distance_batch_plain, hamming_distance_plain,
        hamming_topk_fused, hamming_topk_fused_plain, hamming_topk_hist,
        hamming_topk_hist_dma, hamming_topk_hist_plain)
    from repro_torch.kernels.lbh_grad import (
        LIBRARY as CHAIN_LIB, lbh_chain, lbh_chain_plain)
    from repro_torch.kernels.ref import lbh_chain_bound, sign_flip_ratios
    from repro_torch.svm.active import (ALConfig, make_selector,
                                        run_active_learning)
    from repro_torch.svm.linear_svm import train_ova
    from repro_torch.serving import batch_query as bq
    from repro_torch.serving.async_service import AsyncHashQueryService
    from repro_torch.serving.cluster import ShardReplicaRouter
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.lsm import LSMMultiTableIndex
    from repro_torch.serving.multi_table import MultiTableIndex
    from repro_torch.serving.service import HashQueryService
    from repro_torch.utils.bits import (flip_packed, from_numpy_u32,
                                        to_numpy_u32)

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
    libs = (HASH_LIB, SCAN_LIB, FACTORS_LIBRARY, CHAIN_LIB, FUSED_LIBRARY,
            DISTANCE_LIBRARY)
    _build.build(libs)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
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
    # the device's own time per call (the generation and the product), so
    # the host's share of the event time shows
    q_busy, q_prof = device_profile(torch, lambda: [
        bilinear_hash_seeded(w0, seeds, BITS) for _ in range(50)])
    check(q_busy > 0, "the profiler saw the query hash's device work")
    print(f"hash at the query shape ({BATCH} x {d}): kernel {q_hash_ms} ms "
          f"(CUDA events over back-to-back calls), device time "
          f"(torch.profiler) {q_busy / 50} ms per call "
          f"(launches in 50 calls: "
          f"{json.dumps({k: v[1] for k, v in q_prof.items()})}), "
          f"plain {q_hash_plain_ms} ms, bound {q_bound_ms} ms "
          f"({q_bound_by})")
    _, f_prof = device_profile(torch, lambda: [
        bilinear_hash_seeded(x, seeds, BITS) for _ in range(3)])
    print(f"hash at the fit shape, device time per call (torch.profiler): "
          f"{sum(v[0] for v in f_prof.values()) / 3} ms, by kernel "
          + json.dumps({k: v[0] / 3 for k, v in f_prof.items()}))
    for line in ptxas_lines(_build.build_log(HASH_LIB), "bh_seeded"):
        print(f"  ptxas {HASH_LIB}: {line}")
    bound_ms, bound_by = hash_bound(n)
    print(f"hash at the fit shape ({n} x {d}): kernel {hash_ms} ms, "
          f"plain {hash_plain_ms} ms, bound {bound_ms} ms ({bound_by})")
    # the library route: the stacked strict-fp32 product the serving path
    # takes for materialised (learned) factors, timed on these factors
    lib_ms = cuda_ms(torch, lambda: library_hash(x, factors), 5)
    q_lib_ms = cuda_ms(torch, lambda: library_hash(w0, factors), 50)
    q_lib_ratios = sign_flip_ratios(w0, factors, library_hash(w0, factors),
                                    bilinear_hash_seeded(w0, seeds, BITS))
    check(bool((q_lib_ratios <= 1.0).all()),
          "the library route's query codes agree within the near-zero bound")
    print(f"library route (two torch.matmul + sign + pack, {TABLES} "
          f"tables): fit shape {lib_ms} ms, query shape {q_lib_ms} ms "
          f"({q_lib_ratios.numel()} query bits differ from the kernel's)")
    records["bilinear_hash_seeded"] = dict(
        name="bilinear_hash_seeded", route="cuda",
        source="src/repro_torch/kernels/csrc/bilinear_hash_seeded.cu",
        replaces="src/repro/kernels/bilinear_hash.py:125",
        # codes are bits: the largest difference is 1 if any bit differs
        max_abs_err=int(ratios.numel() + q_ratios.numel() > 0), ms=hash_ms,
        plain_ms=hash_plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=lib_ms)

    # -- 4. scan kernels vs plain at the query shape ------------------------
    phase("4 scan kernels vs plain")
    q = flip_packed(bilinear_hash_seeded(w0, seeds, BITS), BITS)
    bn = ops._block_rows(n, 4096)
    l_k = min(SCAN_L, bn)
    packs_all = ("none", "16", "8")
    scan_kernels = {"hist": (hamming_topk_hist, hamming_topk_hist_plain),
                    "argmin": (hamming_topk_fused, hamming_topk_fused_plain),
                    "hist_dma": (hamming_topk_hist_dma,
                                 hamming_topk_hist_plain)}
    scan_err = dict.fromkeys(scan_kernels, 0)   # largest |kernel - plain|

    def scan_case(label, codes, queries, l, active=None, packs=packs_all,
                  selects=("hist", "argmin")):
        """Each select's kernel against its plain version before the merge
        (and the pipelined kernel against the hist kernel too), and the
        merged top-l against the plain scan and the hist kernel's merged
        output, bit for bit."""
        nb = ops._block_rows(codes.shape[1], 4096)
        lk = min(l, nb)
        act_i = None if active is None else active.to(torch.int32)
        want = search.hamming_topk_grouped(codes, queries, l, active=active)
        for pack in packs:
            hist = ops.hamming_topk_grouped(codes, queries, l, pack=pack,
                                            active=active, select="hist")
            for select in selects:
                kern, plain = scan_kernels[select]
                kd, ki = kern(codes, queries, lk, nb, act_i, pack)
                pd, pi = plain(codes, queries, lk, nb, act_i, pack)
                got = (hist if select == "hist" else ops.hamming_topk_grouped(
                    codes, queries, l, pack=pack, active=active,
                    select="argmin" if select == "argmin" else "hist",
                    dma=select == "hist_dma"))
                if select == "hist_dma":
                    hd, hi = hamming_topk_hist(codes, queries, lk, nb, act_i,
                                               pack)
                    check(torch.equal(kd, hd) and torch.equal(ki, hi),
                          f"{label} hist_dma pack {pack}: block output "
                          f"equals the hist kernel's")
                for a, b in ((kd, pd), (ki, pi), (got[0], want[0]),
                             (got[1], want[1])):
                    err = int((a.long() - b.long()).abs().max())
                    scan_err[select] = max(scan_err[select], err)
                check(torch.equal(kd, pd) and torch.equal(ki, pi),
                      f"{label} {select} pack {pack}: block output equals the "
                      f"plain one")
                check(all(torch.equal(a, b) for a, b in zip(got, want))
                      and all(torch.equal(a, b) for a, b in zip(got, hist)),
                      f"{label} {select} pack {pack}: merged top-l equals the "
                      f"plain scan and the hist kernel's")
            print(f"scan {label} pack {pack}: {' and '.join(selects)} "
                  f"identical (G={codes.shape[0]} n={codes.shape[1]} "
                  f"W={codes.shape[2]} B={queries.shape[1]} l={l})")

    dead = torch.from_numpy(rng.random(n) < 0.1).to(dev)
    # the streaming path's shapes: a base of ~1M rows with ~5% tombstones,
    # deltas of 4,096 and 20,000 rows
    live5 = torch.from_numpy(rng.random(n) >= 0.05).to(dev)
    codes48 = bilinear_hash_seeded(x[:200_000], seeds, 48)
    q48 = flip_packed(bilinear_hash_seeded(w0, seeds, 48), 48)
    block_dead = torch.ones(3 * 4096, dtype=torch.bool, device=dev)
    block_dead[4096:8192] = False
    both = ("hist", "argmin")
    # (label, codes, queries, active, packs and selects of this phase);
    # phase 13 runs every case again through the pipelined kernel
    scan_cases = [
        ("main", codes_k, q, None, packs_all, ("hist",)),
        ("one query, one table (the LBH query_scan's B = 1)",
         codes_k[:1].contiguous(), q[:1, :1].contiguous(), None, packs_all,
         both),
        ("10% tombstoned", codes_k, q, ~dead, ("16",), ("hist",)),
        ("base, 5% tombstoned", codes_k, q, live5, packs_all, both),
        *[(f"delta of {rows} rows", codes_k[:, -rows:].contiguous(), q,
           live5[-rows:], packs_all, both) for rows in (4096, 20_000)],
        ("l > n", codes_k[:, :100].contiguous(), q, None, packs_all, both),
        ("W=2 (k=48)", codes48, q48, None, packs_all, both),
        ("an all-dead block", codes_k[:, :3 * 4096].contiguous(), q,
         block_dead, packs_all, both),
    ]
    for label, c, qc, act, packs, selects in scan_cases:
        scan_case(label, c, qc, SCAN_L, active=act, packs=packs,
                  selects=selects)
    popc_s = POPC_PER_CLK_SM * sms * max_clock_mhz * 1e6

    def scan_bound(groups, rows, nq, l, live_rows, active_bytes):
        """(bound ms, bound_by) of one block-local scan: codes, active and
        queries read once, the pack-16 candidates written once; one
        popcount per live row, query and word, 16 per clock per SM."""
        rb = ops._block_rows(rows, 4096)
        d_dtype, i_dtype, _ = cand_encoding("16", w_words, rb)
        cand_bytes = groups * -(-rows // rb) * nq * min(l, rb) * (
            torch.empty(0, dtype=d_dtype).element_size()
            + torch.empty(0, dtype=i_dtype).element_size())
        t_bytes = (groups * (rows + nq) * w_words * 4 + active_bytes
                   + cand_bytes) / HBM_BYTES_S
        t_ops = groups * live_rows * nq * w_words / popc_s
        return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                           else "bytes")

    # the redesigned kernels 2 and 5 at the shapes of their paths: CUDA
    # events over back-to-back calls, the profiler's device time, the bound
    act5 = live5.to(torch.int32)
    d20 = (codes_k[:, -20_000:].contiguous(), act5[-20_000:].contiguous())
    shapes = {
        "serving": (codes_k, q, SCAN_L, None),
        "base, 5% tombstoned": (codes_k, q, SCAN_L, act5),
        "LBH query_scan": (codes_k[:1].contiguous(), q[:1, :1].contiguous(),
                           LBH_SCAN_L, None),
        "delta of 20000 rows, 5% tombstoned": (d20[0], q, SCAN_L, d20[1]),
    }
    scan_times = {}
    for shape, (c, qc, l, act) in shapes.items():
        rows = c.shape[1]
        rb = ops._block_rows(rows, 4096)
        live = rows if act is None else int(act.sum())
        bound = scan_bound(c.shape[0], rows, qc.shape[1], l, live,
                           0 if act is None else 4 * rows)
        for name, kern, frag in (
                ("hamming_topk_hist", hamming_topk_hist, "topk_hist_kernel"),
                ("hamming_topk_fused", hamming_topk_fused,
                 "topk_fused_kernel")):
            def call(kern=kern, c=c, qc=qc, l=l, act=act, rb=rb):
                return kern(c, qc, min(l, rb), rb, act, "16")
            ev = cuda_ms(torch, call, 20)
            _, prof = device_profile(
                torch, lambda: [call() for _ in range(5)], (frag,))
            dev_ms = kernel_device_ms(prof, frag)
            check(dev_ms is not None, f"the profiler saw {name} ({shape})")
            scan_times[(name, shape)] = dict(events_ms=ev, device_ms=dev_ms,
                                             bound_ms=bound[0],
                                             bound_by=bound[1])
            print(f"{name} at {shape} (G={c.shape[0]}, n={rows}, "
                  f"B={qc.shape[1]}, l={min(l, rb)}, pack 16): CUDA events "
                  f"{ev} ms, device time (torch.profiler) {dev_ms} ms; bound "
                  f"{bound[0]} ms ({bound[1]})")
    for lib, frag in ((SCAN_LIB, "topk_hist_kernel"),
                      (FUSED_LIBRARY, "topk_fused_kernel")):
        for line in ptxas_lines(_build.build_log(lib), frag):
            print(f"  ptxas {lib}: {line}")
    scan_ms = scan_times[("hamming_topk_hist", "serving")]["events_ms"]
    scan_plain_ms = cuda_ms(torch, lambda: hamming_topk_hist_plain(
        codes_k, q, l_k, bn, None, "16"), 3)
    scan_bound_ms, scan_bound_by = scan_bound(TABLES, n, BATCH, SCAN_L, n, 0)
    records["hamming_topk_hist"] = dict(
        name="hamming_topk_hist", route="cuda",
        source="src/repro_torch/kernels/csrc/hamming_topk_hist.cu",
        replaces="src/repro/kernels/hamming.py:429",
        max_abs_err=scan_err["hist"], ms=scan_ms, plain_ms=scan_plain_ms,
        bound_ms=scan_bound_ms, bound_by=scan_bound_by, library_ms=None)
    # kernel 5 at the streaming base's shape: ~1M rows, 5% tombstoned
    base5 = ("hamming_topk_fused", "base, 5% tombstoned")
    fused_ms = scan_times[base5]["events_ms"]
    fused_plain_ms = cuda_ms(torch, lambda: hamming_topk_fused_plain(
        codes_k, q, l_k, bn, act5, "16"), 3)
    hist5_ms = scan_times[("hamming_topk_hist", base5[1])]["events_ms"]
    print(f"argmin kernel at the base shape: plain {fused_plain_ms} ms; "
          f"{fused_ms / hist5_ms} x the hist kernel on the same inputs")
    records["hamming_topk_fused"] = dict(
        name="hamming_topk_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/hamming_topk_fused.cu",
        replaces="src/repro/kernels/hamming.py:207",
        max_abs_err=scan_err["argmin"], ms=fused_ms,
        plain_ms=fused_plain_ms, bound_ms=scan_times[base5]["bound_ms"],
        bound_by=scan_times[base5]["bound_by"], library_ms=None)
    del codes_p, act5, d20
    torch.cuda.synchronize()

    all_kernels = (bilinear_hash_seeded, hamming_topk_hist, bilinear_hash,
                   lbh_chain, hamming_topk_fused, hamming_topk_hist_dma,
                   hamming_distance_batch, hamming_distance)

    def zero_counts():
        for kern in all_kernels:
            kern.launches = 0

    def read_counts():
        return {kern.__name__: kern.launches for kern in all_kernels}

    # -- 5. serving path end to end -----------------------------------------
    phase("5 serving path")
    cfg = IndexConfig(method="bh", bits=BITS, tables=TABLES, batch=BATCH)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    index = MultiTableIndex(cfg, device="cuda").fit(x_np)
    service = HashQueryService(index, mode="scan", scan_l=SCAN_L)
    answers = []
    for i in range(args.batches):
        answers.extend(service.query_batch(ws[i * BATCH:(i + 1) * BATCH]))
    torch.cuda.synchronize()
    serve_launches = read_counts()
    print(f"fit {index.fit_s:.2f} s; launches on the serving path: "
          f"{serve_launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (with the "
          f"{x.nbytes / 2**30:.2f} GiB feature copy of phases 3-4)")
    check(serve_launches["bilinear_hash_seeded"] > 0
          and serve_launches["hamming_topk_hist"] > 0,
          "both serving kernels launched on the serving path")
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

    del service, codes_dev, codes_scan, m_min, i_min   # index: phase 18
    torch.cuda.empty_cache()

    # -- 6. streaming path: the LSM index behind the async front end -------
    phase("6 streaming path")
    lab = corpus.y >= 0
    x_base, x_new = x_np[~lab], x_np[lab]
    per = x_new.shape[0] // STREAM_BATCHES
    scfg = IndexConfig(method="bh", bits=BITS, tables=TABLES, batch=BATCH,
                       lsm_delta_threshold=0.02)
    srng = np.random.default_rng(args.seed + 2)
    base_del = np.array_split(
        srng.choice(x_base.shape[0], BASE_DELETES, replace=False),
        STREAM_BATCHES)
    new_del = [a.size for a in np.array_split(np.arange(NEW_DELETES),
                                              STREAM_BATCHES)]
    wq = ws[:BATCH]        # the check set: one micro-batch of normals
    torch.cuda.reset_peak_memory_stats()
    # kernel 2's launches by segment: ops' reference to the wrapper is
    # wrapped for the stream to tally the scanned rows (the launch count
    # stays the wrapper's own); a scan of more than half the base rows is a
    # base scan, any other a delta (or frozen-delta) scan
    seg_tally = {"base": [0, 0], "delta": [0, 0]}
    hist_kernel = ops.hamming_topk_hist

    def tallied_hist(codes, *a, **kw):
        before = hist_kernel.launches
        out = hist_kernel(codes, *a, **kw)
        if hist_kernel.launches != before:
            rows = codes.shape[1]
            t = seg_tally["base" if 2 * rows > x_base.shape[0] else "delta"]
            t[0] += 1
            t[1] += rows
        return out

    ops.hamming_topk_hist = tallied_hist
    zero_counts()
    excluded = dict.fromkeys(read_counts(), 0)   # launches of the checks
    seg_excluded = {"base": [0, 0], "delta": [0, 0]}
    lsm = LSMMultiTableIndex(scfg, device="cuda").fit(x_base)
    print(f"LSM fit over {x_base.shape[0]} rows: {lsm.fit_s:.2f} s")
    svc = AsyncHashQueryService(lsm, mode="scan", scan_l=SCAN_L,
                                deadline_ms=2.0)
    q_lat, swap_lat, compaction_lat = [], [], []
    ins_s = [0.0]
    nq = [0]

    def query_batch(wb):
        """One micro-batch of normals through the async front end: its
        results; records its latency, and whether a swap fell inside."""
        c0, active0 = lsm.compactions, lsm.segments()["compaction_active"]
        t = time.perf_counter()
        futs = [svc.submit(w) for w in wb]
        res = [f.result(timeout=300) for f in futs]
        lat = time.perf_counter() - t
        q_lat.append(lat)
        nq[0] += 1
        if lsm.compactions != c0:
            swap_lat.append(lat)
        if active0 or lsm.compactions != c0:
            compaction_lat.append(lat)
        return res

    def same(res, ids, margins):
        return (np.array_equal([r.index for r in res], ids)
                and np.array_equal(np.float32([r.margin for r in res]),
                                   margins))

    def verify(label, mid=None):
        """The LSM index against a fresh MultiTableIndex over its live rows
        (same families): per-table lists and answers identical; the async
        answers (and any taken mid-compaction) identical to the sync
        query_scan_batch on the same state.  Returns the sync results."""
        c0 = read_counts()
        t0 = {k: list(v) for k, v in seg_tally.items()}
        live = lsm.active.copy()
        live_ids = lsm.ids_np[live]
        fresh = MultiTableIndex(scfg, device="cuda").fit(
            lsm.x_np[live], families=lsm.families)
        dl, il = lsm.scan_table_topk(wq, l=SCAN_L)
        df, i_f = fresh.scan_table_topk(wq, l=SCAN_L)
        check(np.array_equal(dl, df) and np.array_equal(
            il, np.where(i_f >= 0, live_ids[np.clip(i_f, 0, None)], -1)),
            f"{label}: per-table lists equal a fresh monolithic index's")
        rl = lsm.query_scan_batch(wq, l=SCAN_L)
        rf = fresh.query_scan_batch(wq, l=SCAN_L)
        check(np.array_equal(rl.ids, np.where(
            rf.ids >= 0, live_ids[np.clip(rf.ids, 0, None)], -1))
            and np.array_equal(rl.margins, rf.margins),
            f"{label}: answers equal a fresh monolithic index's")
        check(same([f.result(timeout=300) for f in
                    [svc.submit(w) for w in wq]], rl.ids, rl.margins),
              f"{label}: async answers equal the sync ones")
        if mid is not None:
            check(same(mid, rl.ids, rl.margins),
                  f"{label}: answers taken mid-compaction equal them too")
        st = lsm.segments()
        print(f"{label}: identical to a fresh index over {live.sum()} live "
              f"rows (base {st['base_rows']}, delta {st['delta_rows']}, "
              f"compactions {lsm.compactions}"
              f"{', one checked mid-compaction' if mid is not None else ''})")
        del fresh
        torch.cuda.empty_cache()
        for k, v in read_counts().items():
            excluded[k] += v - c0[k]
        for k, v in seg_tally.items():
            seg_excluded[k][0] += v[0] - t0[k][0]
            seg_excluded[k][1] += v[1] - t0[k][1]
        return dl, il, rl

    # The stream: each insert batch, its deletes, then >= 4 query
    # micro-batches; while a fold is due or running, inserts wait and query
    # micro-batches keep flowing until the new base swaps in.
    lsm.start_compactor()
    t_stream = time.perf_counter()
    try:
        seen = 0
        for i in range(STREAM_BATCHES):
            t = time.perf_counter()
            ids = svc.submit_insert(x_new[i * per:(i + 1) * per]).result(
                timeout=300)
            ins_s[0] += time.perf_counter() - t
            svc.submit_delete(base_del[i]).result(timeout=300)
            svc.submit_delete(srng.choice(ids, new_del[i], replace=False)
                              ).result(timeout=300)
            for j in range(STREAM_QUERIES):
                k = (nq[0] % args.batches) * BATCH
                query_batch(ws[k:k + BATCH])
            mid = None
            while True:
                st = lsm.segments()
                due = st["delta_rows"] >= max(
                    scfg.lsm_delta_min,
                    int(scfg.lsm_delta_threshold * st["base_rows"]))
                if not (st["compaction_active"] or due):
                    break
                res = query_batch(wq)
                if mid is None and st["compaction_active"]:
                    mid = res
            if lsm.compactions != seen:
                seen = lsm.compactions
                verify(f"after insert batch {i + 1}", mid)
    finally:
        lsm.stop_compactor()
    stream_s = time.perf_counter() - t_stream
    dl, il, rl = verify("end of stream")
    torch.cuda.synchronize()
    ops.hamming_topk_hist = hist_kernel
    stream_launches = {k: v - excluded[k] for k, v in read_counts().items()}
    by_segment = {}
    for k, (launches, rows) in seg_tally.items():
        launches -= seg_excluded[k][0]
        rows -= seg_excluded[k][1]
        by_segment[k] = {"launches": launches,
                         "mean_rows": rows / launches if launches else 0}
    print("kernel 2 on the streaming path by segment (checks excluded): "
          + json.dumps(by_segment))
    check(sum(v["launches"] for v in by_segment.values())
          == stream_launches["hamming_topk_hist"],
          "every streaming launch of kernel 2 is tallied to a segment")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    lat = np.asarray(q_lat)
    stream_stats = {
        "inserted_rows_per_s": x_new.shape[0] / ins_s[0],
        "insert_batches": STREAM_BATCHES,
        "deleted_rows": BASE_DELETES + NEW_DELETES,
        "query_batches": nq[0], "queries": nq[0] * BATCH,
        "qps": nq[0] * BATCH / float(lat.sum()),
        "p50_ms": 1e3 * float(np.quantile(lat, 0.5)),
        "p95_ms": 1e3 * float(np.quantile(lat, 0.95)),
        "max_ms": 1e3 * float(lat.max()),
        "max_ms_across_a_swap": 1e3 * max(swap_lat, default=float("nan")),
        "max_ms_while_compacting": 1e3 * max(compaction_lat,
                                             default=float("nan")),
        "compactions": lsm.compactions, "stream_s": stream_s,
        "peak_device_gib": peak_gib}
    print("streaming path: " + json.dumps(stream_stats))
    print(f"launches on the streaming path (checks excluded): "
          f"{stream_launches}")
    print("async stats: " + json.dumps(
        {k: v for k, v in svc.stats().items() if k != "backend"}))
    print("index stats: " + json.dumps(
        {k: v for k, v in lsm.stats().items() if k != "per_table"}))
    check(lsm.compactions >= 2, "at least 2 compactions swapped in")
    check(stream_launches["bilinear_hash_seeded"] > 0
          and stream_launches["hamming_topk_hist"] > 0,
          "the hash and the hist scan launched on the streaming path")
    check(lsm.segments()["delta_rows"] >= scfg.lsm_delta_fused_rows,
          "the final delta is past lsm_delta_fused_rows (kernel route)")

    # the final query set again with the masked-argmin select: identical
    # lists and answers, kernel 5 on both segments of both calls
    zero_counts()
    scfg.fused_select = "argmin"
    flushes0 = svc.stats()["backend"]["batches"]
    da, ia = lsm.scan_table_topk(wq, l=SCAN_L)
    ra = lsm.query_scan_batch(wq, l=SCAN_L)
    ra_async = [f.result(timeout=300) for f in [svc.submit(w) for w in wq]]
    torch.cuda.synchronize()
    argmin_launches = read_counts()
    scan_calls = 2 + svc.stats()["backend"]["batches"] - flushes0
    scfg.fused_select = None
    check(np.array_equal(da, dl) and np.array_equal(ia, il),
          "argmin lists equal the hist ones")
    check(np.array_equal(ra.ids, rl.ids)
          and np.array_equal(ra.margins, rl.margins)
          and same(ra_async, rl.ids, rl.margins),
          "argmin answers (sync and async) equal the hist ones")
    check(argmin_launches["hamming_topk_fused"] == 2 * scan_calls
          and argmin_launches["hamming_topk_hist"] == 0,
          "the argmin kernel scanned both segments in every scan call")
    print(f"argmin repeat: lists and answers identical to hist; launches "
          f"{argmin_launches}")

    # -- 7. where the streaming path's time goes (outside the counted path)
    phase("7 streaming stages")

    def host_ms(fn, reps):
        """Mean host ms of fn, each call ended by a synchronise."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / reps

    def delta_upload():
        with lsm._lock:
            lsm._delta_key = None
            lsm._delta_state()

    def async_batches():
        for f in [svc.submit(w) for w in ws[:8 * BATCH]]:
            f.result(timeout=300)

    batches_ms = host_ms(async_batches, 3) / 8
    busy_ms, _ = device_profile(torch, async_batches)
    stages = {
        "async_query_batch_ms": batches_ms,
        "async_query_batch_device_busy_ms": busy_ms / 8,
        "device_idle_share": 1 - busy_ms / 8 / batches_ms,
        "insert_hash_ms": cuda_ms(torch, lambda: bq.hash_database_all(
            lsm.families, x_new[:per]), 10),
        "delta_upload_ms": host_ms(delta_upload, 10),
        "two_segment_scan_and_merge_ms": host_ms(
            lambda: lsm._scan_segments(wq, SCAN_L), 10),
        "query_scan_batch_ms": host_ms(
            lambda: lsm.query_scan_batch(wq, l=SCAN_L), 10),
    }
    # one more fold of the final state, its phases timed apart: the copy
    # steps (each under the lock), the upload (off the lock), the swap
    check(lsm.begin_compaction(), "a fold of the final state begins")
    c = lsm._c
    steps = []
    while c.pos < c.src_len:
        t = time.perf_counter()
        lsm.compaction_step()
        steps.append(time.perf_counter() - t)
    t = time.perf_counter()
    dev_codes, dev_x = lsm._upload_new_base(c)
    torch.cuda.synchronize()
    stages["compaction_upload_ms"] = 1e3 * (time.perf_counter() - t)
    with lsm._lock:
        t = time.perf_counter()
        lsm._finish_swap(c, dev_codes, dev_x)
        stages["swap_pause_ms"] = 1e3 * (time.perf_counter() - t)
    stages.update({
        "compaction_copy_steps": len(steps),
        "compaction_copy_ms": 1e3 * sum(steps),
        "compaction_copy_step_max_ms": 1e3 * max(steps)})
    rs = lsm.query_scan_batch(wq, l=SCAN_L)
    check(np.array_equal(rs.ids, rl.ids)
          and np.array_equal(rs.margins, rl.margins),
          "answers unchanged across the timed fold")
    print("streaming stages: " + json.dumps(stages))
    svc.close()
    del svc, dev_codes, dev_x, c                       # lsm: phase 18
    torch.cuda.empty_cache()

    # -- 8. factor hash kernel vs plain at the fit and query shapes --------
    phase("8 factor hash kernel vs plain")
    u0, v0 = seeded_projections(table_seed(0, 0), d, BITS, dev)
    codes_f = bilinear_hash(x, u0, v0)
    torch.cuda.synchronize()
    f_ratios = sign_flip_ratios(x, [(u0, v0)], codes_f[None],
                                bilinear_hash_plain(x, u0, v0)[None])
    fq_ratios = sign_flip_ratios(w0, [(u0, v0)],
                                 bilinear_hash(w0, u0, v0)[None],
                                 bilinear_hash_plain(w0, u0, v0)[None])
    print(f"factor hash: {f_ratios.numel()} of {n * BITS} bits differ from "
          f"the plain version at the fit shape, {fq_ratios.numel()} of "
          f"{BATCH * BITS} at the query shape")
    check(bool((f_ratios <= 1.0).all()) and bool((fq_ratios <= 1.0).all()),
          "every differing factor-hash bit lies within the near-zero bound")
    del codes_f
    fh_ms = cuda_ms(torch, lambda: bilinear_hash(x, u0, v0), 10)
    fh_plain_ms = cuda_ms(torch, lambda: bilinear_hash_plain(x, u0, v0), 5)
    q_fh_ms = cuda_ms(torch, lambda: bilinear_hash(w0, u0, v0), 50)
    q_fh_plain_ms = cuda_ms(torch, lambda: bilinear_hash_plain(w0, u0, v0),
                            50)

    def factor_hash_bound(rows):
        """(bound ms, bound_by) of hashing rows x d with one (d, k) pair."""
        t_bytes = (rows * d * 4 + 2 * d * BITS * 4
                   + rows * w_words * 4) / HBM_BYTES_S
        t_ops = 4 * rows * d * BITS / FP32_FLOP_S
        return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                           else "bytes")

    fh_dev_ms = profiled_ms(torch, lambda: bilinear_hash(x, u0, v0), 5,
                            "bilinear_hash_kernel")
    print(f"factor hash at the fit shape, device time of the kernel "
          f"(torch.profiler): "
          f"{'not measured' if fh_dev_ms is None else fh_dev_ms} ms")
    fh_bound, fh_bound_by = factor_hash_bound(n)
    q_fh_bound, q_fh_bound_by = factor_hash_bound(BATCH)
    fh_lib_ms = cuda_ms(torch, lambda: library_hash(x, [(u0, v0)]), 10)
    q_fh_lib_ms = cuda_ms(torch, lambda: library_hash(w0, [(u0, v0)]), 50)
    print(f"library route (two torch.matmul + sign + pack, one table): "
          f"fit shape {fh_lib_ms} ms, query shape {q_fh_lib_ms} ms")
    print(f"factor hash at the fit shape ({n} x {d}, k {BITS}): kernel "
          f"{fh_ms} ms, plain {fh_plain_ms} ms, bound {fh_bound} ms "
          f"({fh_bound_by}); at the query shape ({BATCH} x {d}): kernel "
          f"{q_fh_ms} ms, plain {q_fh_plain_ms} ms, bound {q_fh_bound} ms "
          f"({q_fh_bound_by})")
    records["bilinear_hash"] = dict(
        name="bilinear_hash", route="cuda",
        source="src/repro_torch/kernels/csrc/bilinear_hash.cu",
        replaces="src/repro/kernels/bilinear_hash.py:52",
        # codes are bits: the largest difference is 1 if any bit differs
        max_abs_err=int(f_ratios.numel() + fq_ratios.numel() > 0), ms=fh_ms,
        plain_ms=fh_plain_ms, bound_ms=fh_bound, bound_by=fh_bound_by,
        library_ms=fh_lib_ms)

    # -- 9. LBH chain kernel vs plain at the learner's shapes --------------
    phase("9 LBH chain kernel vs plain")
    rows_m = learning.sample_rows(n, LBH_SAMPLE, table_seed(0, 0)).to(dev)
    x_m = x[rows_m]
    s_t1, s_t2 = learning.auto_thresholds(x_m, x_m)
    r_full = BITS * learning.similarity_matrix(x_m, s_t1, s_t2)
    with strict_fp32():
        p_full, q_full = x_m @ u0[:, 0], x_m @ v0[:, 0]
    chain_err = chain_rel = 0.0
    # the learner's m (16-byte rows), and two m % 4 != 0 (4-byte loads)
    for m in (LBH_SAMPLE, 777, 999):
        p, q = p_full[:m].contiguous(), q_full[:m].contiguous()
        r = r_full[:m, :m].contiguous()
        got = lbh_chain(p, q, r)
        torch.cuda.synchronize()
        for g, want, bound in zip(got, lbh_chain_plain(p, q, r),
                                  lbh_chain_bound(p, q, r)):
            diff = (g - want).abs()
            check(bool((diff <= bound).all()),
                  f"chain m={m}: every element within its rounding bound")
            chain_err = max(chain_err, diff.max().item())
            chain_rel = max(chain_rel,
                            (diff.max() / want.abs().max()).item())
    print(f"LBH chain at m = {LBH_SAMPLE}, 777 and 999: max |kernel - "
          f"plain| {chain_err}, max relative error (over the largest "
          f"|plain|) {chain_rel}")
    chain_ev_ms = cuda_ms(torch, lambda: lbh_chain(p_full, q_full, r_full),
                          200, warmup=5)
    chain_plain_ev_ms = cuda_ms(
        torch, lambda: lbh_chain_plain(p_full, q_full, r_full), 200,
        warmup=5)
    # Back-to-back calls at m = 1000 are paced by the host (the wrappers'
    # Python work outlasts the kernels), so CUDA events measure the host.
    # The profiler's kernel events give the device's own time: the
    # record's ms and plain_ms are those, per call.
    _, prof = device_profile(torch, lambda: [
        lbh_chain(p_full, q_full, r_full) for _ in range(200)],
        ("lbh_chain_kernel",))
    chain_ms = kernel_device_ms(prof, "lbh_chain_kernel")
    plain_busy, _ = device_profile(torch, lambda: [
        lbh_chain_plain(p_full, q_full, r_full) for _ in range(200)])
    chain_plain_ms = plain_busy / 200 if plain_busy else None
    check(chain_ms is not None and chain_plain_ms is not None,
          "the profiler saw the chain's device work")
    print(f"LBH chain at m = {LBH_SAMPLE}, CUDA events over 200 "
          f"back-to-back calls: kernel {chain_ev_ms} ms, plain "
          f"{chain_plain_ev_ms} ms per call")
    m = LBH_SAMPLE
    t_bytes = (m * m * 4 + 4 * m * 4) / HBM_BYTES_S
    t_ops = (2 * m * m + 6 * m) / FP32_FLOP_S
    print(f"LBH chain at m = {m}, device time per call (torch.profiler; "
          f"R stays in L2 across back-to-back calls, as in the step loop): "
          f"kernel {chain_ms} ms, plain {chain_plain_ms} ms, bound "
          f"{1e3 * max(t_bytes, t_ops)} ms (R from HBM)")
    for line in ptxas_lines(_build.build_log(CHAIN_LIB), "lbh_chain_kernel"):
        print(f"  ptxas {CHAIN_LIB}: {line}")
    records["lbh_chain"] = dict(
        name="lbh_chain", route="cuda",
        source="src/repro_torch/kernels/csrc/lbh_chain.cu",
        replaces="src/repro/kernels/lbh_grad.py:44", max_abs_err=chain_err,
        ms=chain_ms, plain_ms=chain_plain_ms,
        bound_ms=1e3 * max(t_bytes, t_ops),
        bound_by="operations" if t_ops > t_bytes else "bytes",
        library_ms=None)
    del r_full, p_full, q_full

    # -- 10. LBH path: learned single-table index ---------------------------
    phase("10 LBH path: HyperplaneIndex")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    captures0 = learning.BitLoop.captures
    warmup0 = lbh_chain.warmup_launches
    lcfg = IndexConfig(method="lbh", bits=BITS, radius=RADIUS,
                       lbh_sample=LBH_SAMPLE, lbh_steps=LBH_STEPS)
    hidx = HyperplaneIndex(lcfg, device="cuda").fit(x_np)
    # 32 SVM normals: all one-vs-all SVMs on 4 random labelled subsets
    labels = torch.from_numpy(corpus.y).to(dev)
    normals = []
    for i in range(4):
        pick = np.random.default_rng(args.seed + 10 + i).random(n) < 0.002
        mask = torch.from_numpy(pick).to(dev) & (labels >= 0)
        normals.append(train_ova(
            torch.zeros((corpus.num_classes, d), device=dev), x, labels,
            mask, corpus.num_classes, steps=100))
    w_svm = torch.cat(normals)[:BATCH].cpu().numpy()
    t0 = time.perf_counter()
    probe = [hidx.query(w) for w in w_svm]
    t1 = time.perf_counter()
    scans = [hidx.query_scan(w, LBH_SCAN_L) for w in w_svm]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    fam = hidx.family
    print(f"LBH fit {hidx.fit_s:.2f} s (n {n}, sample {LBH_SAMPLE}, "
          f"{LBH_STEPS} steps x {BITS} bits); {BATCH} SVM normals: probe "
          f"{1e3 * (t1 - t0) / BATCH:.2f} ms/query, scan (l "
          f"{LBH_SCAN_L}) {1e3 * (t2 - t1) / BATCH:.2f} ms/query; nonempty "
          f"lookups {sum(r.nonempty for r in probe)} of {BATCH}")
    ratios = sign_flip_ratios(x, [(fam.u, fam.v)], hidx.codes[None],
                              bilinear_hash_plain(x, fam.u, fam.v)[None])
    check(bool((ratios <= 1.0).all()),
          "the index's codes equal the plain hash but for near-zero bits")
    # the scan answers against the plain scan over the same codes
    for w, (i_k, _) in zip(w_svm, scans):
        wt = torch.from_numpy(w).to(dev)
        qc = fam.hash_query(wt[None])[0]
        _, cand = search.hamming_topk(hidx.codes, qc, LBH_SCAN_L)
        _, top = search.margin_rerank(x, wt, cand, 1)
        check(int(top[0]) == i_k, "scan answer equals the plain scan's")
    # every answer's margin >= the exhaustive minimum (rounding bound)
    w_t = torch.from_numpy(w_svm).to(dev)
    norms = torch.linalg.vector_norm(w_t, dim=1)
    with strict_fp32():
        m_min = ((x @ w_t.T).abs() / norms).min(dim=0).values
    for j, (res, (i_k, m_k)) in enumerate(zip(probe, scans)):
        for i_a, m_a in ((res.index, res.margin), (i_k, m_k)):
            if i_a < 0:
                continue
            tol = scale * (x[i_a] * w_t[j]).abs().sum().item() * 2 / norms[
                j].item()
            check(m_a >= m_min[j].item() - tol,
                  "every LBH answer's margin >= the exhaustive minimum")
    print(f"mean margin: probe {np.mean([r.margin for r in probe])}, scan "
          f"{np.mean([m_k for _, m_k in scans])}, exhaustive "
          f"{m_min.mean().item()}")
    # the paper's claim: the learned codes fit the target Gram matrix
    # better than the BH codes learning started from
    t1_l, t2_l = learning.auto_thresholds(x_m, x)
    s_m = learning.similarity_matrix(x_m, t1_l, t2_l)

    def gram_err(u, v):
        b = bilinear_signs(x_m, u, v).to(torch.float32)
        with strict_fp32():
            return torch.linalg.vector_norm(b @ b.T / BITS - s_m).item()

    err_lbh, err_bh = gram_err(fam.u, fam.v), gram_err(u0, v0)
    print(f"Gram-fit error ||BB^T/k - S||_F on the {LBH_SAMPLE}-point "
          f"sample: LBH {err_lbh}, BH warm start {err_bh}")
    check(err_lbh < err_bh, "LBH fits the Gram matrix better than BH")

    # -- 11. LBH path: active learning ----------------------------------------
    phase("11 LBH path: active learning")
    al_cfg = ALConfig(iterations=10, init_per_class=5, svm_steps=20,
                      eval_every=5)
    selector = make_selector("lbh", bits=BITS, radius=RADIUS,
                             lbh_sample=LBH_SAMPLE, lbh_steps=LBH_STEPS)
    al = run_active_learning(corpus, selector, al_cfg)
    torch.cuda.synchronize()
    lbh_launches = read_counts()
    print(f"active learning ({corpus.num_classes} SVMs, "
          f"{al_cfg.iterations} iterations): MAP at iterations "
          f"{al.eval_iters.tolist()}: {al.map_curve.tolist()}")
    print(f"mean selected margin {al.min_margins.mean()} vs exhaustive "
          f"{al.exhaustive_margins.mean()}; nonempty lookups "
          f"{int(al.nonempty.sum())} of "
          f"{al_cfg.iterations * corpus.num_classes}; fit "
          f"{al.fit_seconds:.2f} s, select {al.select_seconds:.3f} s, total "
          f"{al.total_seconds:.2f} s")
    fam_al = selector.index.families[0]
    print(f"AL table 0 vs the single-table family: max |du| "
          f"{(fam_al.u - fam.u).abs().max().item()}")
    print(f"launches on the LBH path: {lbh_launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(bool(np.isfinite(al.map_curve).all()), "MAP is finite")
    check(al.nonempty.sum() > 0, "the hash lookups answered")
    check(bool((al.min_margins >= al.exhaustive_margins - 1e-6).all()),
          "selected margins >= the exhaustive ones")
    check(lbh_launches["lbh_chain"] == 2 * BITS * LBH_STEPS,
          "one chain launch per Nesterov step of both LBH fits")
    lbh_captures = learning.BitLoop.captures - captures0
    lbh_warmups = lbh_chain.warmup_launches - warmup0
    print(f"LBH step loops: {lbh_captures} CUDA graph captures, "
          f"{lbh_warmups} warm-up chain launches (not in the count above)")
    check(lbh_captures == 2 and lbh_warmups == 2,
          "each LBH fit captured its step loop once, for all its bits")
    check(lbh_launches["bilinear_hash"] > 0
          and lbh_launches["hamming_topk_hist"] > 0,
          "the factor hash and the scan launched on the LBH path")

    # -- 12. where the LBH fit's time goes (outside the counted path) ----
    phase("12 LBH fit stages")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learning.auto_thresholds(x_m, x)
    t_thr = time.perf_counter() - t0
    r_bit = BITS * s_m
    lr_bit = 0.03 / LBH_SAMPLE
    t0 = time.perf_counter()
    loop = learning.BitLoop(x_m, LBH_STEPS, lr_bit)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0

    def one_bit(graphed):
        return learning._nesterov_bit(u0[:, 0], v0[:, 0], x_m, r_bit,
                                      LBH_STEPS, lr_bit,
                                      loop if graphed else None)

    # the graphed loop against the eager one on the same inputs
    eager_out = one_bit(False)
    chain0 = lbh_chain.launches
    graphed_out = one_bit(True)
    torch.cuda.synchronize()
    check(lbh_chain.launches - chain0 == LBH_STEPS,
          "one replay runs the bit's chain launches")
    same = all(torch.equal(a, b) for a, b in zip(eager_out, graphed_out))
    loop_diff = {k: (a - b).abs().max().item() for k, a, b in zip(
        ("u", "v", "costs"), eager_out, graphed_out)}
    loop_rel = max((a - b).abs().max().item()
                   / max(a.abs().max().item(), 1e-30)
                   for a, b in zip(eager_out, graphed_out))
    print(f"one bit, graphed vs eager: identical {same}; largest "
          f"|difference| {json.dumps(loop_diff)}, relative {loop_rel}")
    check(same or loop_rel <= 1e-3,
          "the graphed loop's u, v and costs equal the eager loop's (or lie "
          "within 1e-3 of them, relative)")
    bit_times = {}
    for label, graphed, reps in (("eager", False, 2), ("graphed", True, 5)):
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_bit(graphed)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        # the profiler slows the host, so it gives the device time only
        busy_ms, prof = device_profile(torch, lambda g=graphed: one_bit(g),
                                       ("lbh_chain_kernel",))
        wall_ms = float(np.median(walls))
        bit_times[label] = dict(
            wall_ms=walls, busy_ms=busy_ms or None,
            idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
            chain_ms=kernel_device_ms(prof, "lbh_chain_kernel"),
            kernels=sum(k for _, k in prof.values()))
    wall_ms = float(np.median(bit_times["graphed"]["wall_ms"]))
    eager_ms = float(np.median(bit_times["eager"]["wall_ms"]))
    # phase 10's whole fit (graphed) against learn_lbh's bit loop run
    # eagerly on the same sample, warm start and residue: the same factors
    # bit for bit, so the same codes, Gram-fit error and AL curve
    r_e, us, vs = BITS * s_m, [], []
    for j in range(BITS):
        u, v, _ = learning._nesterov_bit(u0[:, j], v0[:, j], x_m, r_e,
                                         LBH_STEPS, lr_bit)
        with strict_fp32():
            b = _sgn((x_m @ u) * (x_m @ v)).to(torch.float32)
        r_e = r_e - torch.outer(b, b)
        us.append(u)
        vs.append(v)
    fit_same = (torch.equal(torch.stack(us, dim=1), fam.u)
                and torch.equal(torch.stack(vs, dim=1), fam.v))
    print(f"the {BITS}-bit fit run eagerly equals phase 10's graphed fit "
          f"(u, v): {fit_same}")
    check(fit_same, "the graphed LBH fit equals the eager one bit for bit")
    codes_np = to_numpy_u32(hidx.codes)
    t0 = time.perf_counter()
    SingleHashTable(codes_np, BITS)
    t_table = time.perf_counter() - t0
    print("LBH fit stages: " + json.dumps({
        "fit_s": hidx.fit_s, "thresholds_s": t_thr,
        "capture_s": t_capture,
        "one_bit_nesterov_s": wall_ms / 1e3,
        "all_bits_nesterov_s_est": BITS * wall_ms / 1e3,
        "one_bit_nesterov_eager_s": eager_ms / 1e3,
        "hash_kernel_s": fh_ms / 1e3, "host_table_s": t_table}))
    print(f"one bit's {LBH_STEPS} Nesterov steps (median wall; device busy "
          f"under torch.profiler, idle share 1 - busy / wall, None where "
          f"the profiler saw no device work): " + json.dumps(bit_times))
    del loop

    # -- 13. kernel layer: distances and the pipelined scan -----------------
    phase("13 kernel layer: distances and the pipelined scan")
    # the tiny1m-scan shape, on phase 3's codes and phase 4's queries
    codes_s, q_s = scan_cases[0][1], scan_cases[0][2]
    ids_n = torch.arange(n, dtype=torch.int32, device=dev).expand(BATCH, n)

    def unfused_route():
        """benchmarks/serving_scan.py's unfused route: the full (B, n)
        distance matrix per table, then the lexicographic smallest l."""
        out = [search.lex_smallest(ops.hamming_distances_batch(
            codes_s[t], q_s[t]), ids_n, SCAN_L) for t in range(TABLES)]
        return (torch.stack([dd for dd, _ in out]),
                torch.stack([ii for _, ii in out]))

    zero_counts()
    fused_dma = ops.hamming_topk_grouped(codes_s, q_s, SCAN_L, dma=True)
    unfused = unfused_route()
    dist_b = [ops.hamming_distances_batch(codes_s[t], q_s[t])
              for t in range(TABLES)]
    dist_1 = [[ops.hamming_distances(codes_s[t], q_s[t, b])
               for b in range(BATCH)] for t in range(TABLES)]
    torch.cuda.synchronize()
    layer_launches = read_counts()
    print(f"launches on the kernel layer's path: {layer_launches}")
    check(layer_launches["hamming_topk_hist_dma"] == 1
          and layer_launches["hamming_distance_batch"] == 2 * TABLES
          and layer_launches["hamming_distance"] == TABLES * BATCH
          and layer_launches["hamming_topk_hist"] == 0,
          "the pipelined scan, the batched and the single-query distance "
          "kernels launched on the kernel layer's path, the hist kernel not")
    fused = ops.hamming_topk_grouped(codes_s, q_s, SCAN_L)
    want = search.hamming_topk_grouped(codes_s, q_s, SCAN_L)
    check(all(torch.equal(a, b) for a, b in zip(fused_dma, fused))
          and all(torch.equal(a, b) for a, b in zip(fused, want)),
          "the fused scan through the pipelined kernel equals the hist "
          "kernel's and the plain scan")
    check(all(torch.equal(a, b) for a, b in zip(unfused, fused)),
          "the unfused route (distance matrix + lex_smallest) equals the "
          "fused scan, lists and ids")
    dist_err = {"batch": 0, "single": 0}
    for t in range(TABLES):
        plain_b = hamming_distance_batch_plain(codes_s[t], q_s[t])
        dist_err["batch"] = max(dist_err["batch"], int(
            (dist_b[t] - plain_b).abs().max()))
        check(torch.equal(dist_b[t], plain_b),
              f"table {t}: the batched distances equal the plain ones")
        for b in range(BATCH):
            plain_1 = hamming_distance_plain(codes_s[t], q_s[t, b])
            dist_err["single"] = max(dist_err["single"], int(
                (dist_1[t][b] - plain_1).abs().max()))
            check(torch.equal(dist_1[t][b], plain_1)
                  and torch.equal(dist_b[t][b], dist_1[t][b]),
                  f"table {t} query {b}: the single-query distances equal "
                  f"the plain ones and row {b} of the batch")
    print(f"distances: kernel 6 equals its plain version on all {TABLES} "
          f"tables ({BATCH} x {n}), kernel 7 on all {TABLES * BATCH} "
          f"queries, each row of the batch equals kernel 7; the unfused "
          f"route equals the fused scan")
    del dist_1, unfused, fused_dma, want
    for label, c, qc, act, _, _ in scan_cases:
        scan_case(label, c, qc, SCAN_L, active=act, selects=("hist_dma",))

    # times: kernel 3 in turns with kernel 2 on the same inputs
    def k2():
        return hamming_topk_hist(codes_s, q_s, l_k, bn, None, "16")

    def k3():
        return hamming_topk_hist_dma(codes_s, q_s, l_k, bn, None, "16")

    turns = [cuda_ms(torch, f, 20) for f in (k2, k3, k3, k2)]
    dma_ms = (turns[1] + turns[2]) / 2
    _, prof = device_profile(torch, lambda: [f() for f in (k2, k3) * 5],
                             ("topk_hist_dma_kernel", "topk_hist_kernel"))
    dma_dev_ms = kernel_device_ms(prof, "topk_hist_dma_kernel")
    hist_dev_ms = kernel_device_ms(prof, "topk_hist_kernel")
    print(f"pipelined hist kernel (G={TABLES}, n={n}, B={BATCH}, l={l_k}, "
          f"pack 16), CUDA events in turns hist / dma / dma / hist: "
          f"{turns} ms; device time (torch.profiler): dma {dma_dev_ms} ms, "
          f"hist {hist_dev_ms} ms (dma / hist "
          f"{dma_dev_ms / hist_dev_ms if dma_dev_ms and hist_dev_ms else None})"
          f"; bound {scan_bound_ms} ms ({scan_bound_by}); plain "
          f"{scan_plain_ms} ms (phase 4)")
    for line in ptxas_lines(_build.build_log(SCAN_LIB),
                            "topk_hist_dma_kernel"):
        print(f"  ptxas {SCAN_LIB}: {line}")
    records["hamming_topk_hist_dma"] = dict(
        name="hamming_topk_hist_dma", route="cuda",
        source="src/repro_torch/kernels/csrc/hamming_topk_hist.cu",
        replaces="src/repro/kernels/hamming.py:496",
        max_abs_err=scan_err["hist_dma"], ms=dma_ms, plain_ms=scan_plain_ms,
        bound_ms=scan_bound_ms, bound_by=scan_bound_by, library_ms=None)

    def bits_f32(codes):
        """(rows, 32 W) float32 0/1 bits of packed codes (rows, W)."""
        sh = torch.arange(32, dtype=torch.int32, device=codes.device)
        return ((codes[..., None] >> sh) & 1).reshape(
            codes.shape[0], -1).to(torch.float32)

    def distance_bound(queries):
        """(bound ms, bound_by) of one table's distances to `queries`:
        codes and queries read once, a (queries, n) int32 output written
        once; one popcount per row, query and word."""
        t_bytes = (n * w_words + queries * w_words + queries * n) * 4 \
            / HBM_BYTES_S
        t_ops = n * queries * w_words / popc_s
        return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                           else "bytes")

    # the library column: torch.cdist(p=0) counts differing elements, the
    # Hamming distance over 0/1 bits; the unpacking is left out of its time
    c_bits, q_bits = bits_f32(codes_s[0]), bits_f32(q_s[0])
    lib_b = torch.cdist(q_bits, c_bits, p=0)
    lib_1 = torch.cdist(q_bits[:1], c_bits, p=0)
    check(torch.equal(lib_b.to(torch.int32), dist_b[0])
          and torch.equal(lib_1[0].to(torch.int32), dist_b[0][0]),
          "torch.cdist(p=0) over the unpacked bits gives the same distances")
    codes0, queries0, query00 = codes_s[0], q_s[0], q_s[0, 0]
    dist_times = {}
    for name, kern, plain, lib, reps in (
            ("hamming_distance_batch",
             lambda: hamming_distance_batch(codes0, queries0),
             lambda: hamming_distance_batch_plain(codes0, queries0),
             lambda: torch.cdist(q_bits, c_bits, p=0), 20),
            ("hamming_distance", lambda: hamming_distance(codes0, query00),
             lambda: hamming_distance_plain(codes0, query00),
             lambda: torch.cdist(q_bits[:1], c_bits, p=0), 100)):
        ev = {k: cuda_ms(torch, f, reps) for k, f in
              (("kernel", kern), ("plain", plain), ("library", lib))}
        busy = {}
        for k, f in (("plain", plain), ("library", lib)):
            ms, _ = device_profile(torch, lambda f=f: [f() for _ in range(
                reps)])
            check(ms > 0, f"the profiler saw {name}'s {k} device work")
            busy[k] = ms / reps
        frag = ("distance_batch_kernel" if name == "hamming_distance_batch"
                else "distance_kernel")
        _, prof = device_profile(torch, lambda f=kern: [f() for _ in range(
            reps)], (frag,))
        busy["kernel"] = kernel_device_ms(prof, frag)
        check(busy["kernel"] is not None, f"the profiler saw {name}")
        dist_times[name] = {"events": ev, "device": busy}
    b_bound, b_bound_by = distance_bound(BATCH)
    s_bound, s_bound_by = distance_bound(1)
    print("distance kernels at the serving shape (one table, n "
          f"{n}, W {w_words}), ms per call, CUDA events over back-to-back "
          "calls and device time (torch.profiler), kernel / plain / "
          "torch.cdist(p=0) (unpacking not timed): " + json.dumps(dist_times)
          + f"; bounds: batch (B={BATCH}) {b_bound} ms ({b_bound_by}), "
          f"single {s_bound} ms ({s_bound_by})")
    for name, err, bound, bound_by, src in (
            ("hamming_distance_batch", dist_err["batch"], b_bound, b_bound_by,
             "src/repro/kernels/hamming.py:516"),
            ("hamming_distance", dist_err["single"], s_bound, s_bound_by,
             "src/repro/kernels/hamming.py:123")):
        dev_t = dist_times[name]["device"]
        records[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/hamming_distance.cu",
            replaces=src, max_abs_err=err, ms=dev_t["kernel"],
            plain_ms=dev_t["plain"], bound_ms=bound, bound_by=bound_by,
            library_ms=dev_t["library"])
    del lib_b, lib_1, c_bits, dist_b

    # the unfused route end to end against the fused scans
    route_ms = {"unfused (kernel 6 x 4 + lex_smallest)": cuda_ms(
        torch, unfused_route, 5),
        "fused, hist kernel": cuda_ms(torch, lambda: ops.hamming_topk_grouped(
            codes_s, q_s, SCAN_L), 20),
        "fused, pipelined hist kernel": cuda_ms(
            torch, lambda: ops.hamming_topk_grouped(codes_s, q_s, SCAN_L,
                                                    dma=True), 20)}
    print(f"scan + merge of {TABLES} tables x {BATCH} queries, l {SCAN_L}, "
          f"ms per call (CUDA events): " + json.dumps(route_ms))

    del codes_s, q_s, ids_n

    # -- 14. wide features: kernels 1 and 4 on newsgroups_like(d=26214) ----
    phase("14 wide features: kernels 1 and 4 at d = 26,215")
    t0 = time.perf_counter()
    ng = newsgroups_like(d=NG_D, seed=args.seed)
    ng_n, ng_d = ng.x.shape
    xg = torch.from_numpy(ng.x).to(dev)
    print(f"corpus: newsgroups-like {ng_n} x {ng_d} float32 "
          f"({ng.x.nbytes / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del ng
    ng_seeds = [table_seed(1, t) for t in range(TABLES)]
    ng_factors = [seeded_projections(s_, ng_d, BITS, dev) for s_ in ng_seeds]
    ug, vg = ng_factors[0]

    def wide_bound(tables):
        """(bound ms, bound_by) of hashing newsgroups into `tables`."""
        t_bytes = (ng_n * ng_d * 4 + tables * ng_n * w_words * 4
                   + (2 * ng_d * BITS * 4 if tables == 1 else 0)) / HBM_BYTES_S
        t_ops = 4 * ng_n * ng_d * BITS * tables / FP32_FLOP_S
        return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                           else "bytes")

    for name, kern, plain, factors_g in (
            ("bilinear_hash_seeded",
             lambda: bilinear_hash_seeded(xg, ng_seeds, BITS),
             lambda: bilinear_hash_seeded_plain(xg, ng_seeds, BITS),
             ng_factors),
            ("bilinear_hash", lambda: bilinear_hash(xg, ug, vg)[None],
             lambda: bilinear_hash_plain(xg, ug, vg)[None], [(ug, vg)])):
        got = kern()
        torch.cuda.synchronize()
        r = sign_flip_ratios(xg, factors_g, got, plain())
        print(f"{name} at d = {ng_d}: {r.numel()} of "
              f"{len(factors_g) * ng_n * BITS} bits differ from the plain "
              f"version; largest |proj| / rounding bound among them: "
              f"{r.max().item() if r.numel() else 0.0:.4f}")
        check(bool((r <= 1.0).all()),
              f"{name} at d = {ng_d}: every differing bit lies within the "
              f"near-zero bound")
        # calls of milliseconds: the events are the device's time.  The
        # profiler is kept off them: its sessions over these launches come
        # back without kernel records, and the sessions after them too.
        k_ms = cuda_ms(torch, kern, 5)
        p_ms = cuda_ms(torch, plain, 2)
        b_ms, b_by = wide_bound(len(factors_g))
        print(f"{name} at {ng_n} x {ng_d}, k {BITS}, {len(factors_g)} "
              f"table(s): kernel {k_ms} ms, plain {p_ms} ms (CUDA events "
              f"over back-to-back calls), bound {b_ms} ms ({b_by})")
        del got, r
    del xg, ng_factors, ug, vg
    torch.cuda.empty_cache()

    # -- 15. wide codes: kernels 2, 5 and 3 at W = 13 and 32 ---------------
    phase("15 wide codes: kernels 2, 5 and 3 at W = 13 and 32")
    wrng = np.random.default_rng(args.seed + 3)

    def as_dev(a):
        return torch.from_numpy(a.view(np.int32)).to(dev)

    for wv in (13, 32):
        rows = 100_000
        codes_w = as_dev(wrng.integers(0, 2**32, (2, rows, wv),
                                       dtype=np.uint32))
        q_w = as_dev(wrng.integers(0, 2**32, (2, BATCH, wv), dtype=np.uint32))
        act_w = torch.from_numpy(wrng.random(rows) >= 0.05).to(dev)
        scan_case(f"W={wv}, 5% tombstoned", codes_w, q_w, SCAN_L,
                  active=act_w, packs=("none", "16"),
                  selects=("hist", "argmin", "hist_dma"))
        # l = block_n at the largest block
        act_i = act_w.to(torch.int32)
        for name, kern, plain in (
                ("hist", hamming_topk_hist, hamming_topk_hist_plain),
                ("argmin", hamming_topk_fused, hamming_topk_fused_plain),
                ("hist_dma", hamming_topk_hist_dma,
                 hamming_topk_hist_plain)):
            kd, ki = kern(codes_w, q_w[:, :9].contiguous(), 8192, 8192, act_i,
                          "16")
            pd, pi = plain(codes_w, q_w[:, :9].contiguous(), 8192, 8192,
                           act_i, "16")
            check(torch.equal(kd, pd) and torch.equal(ki, pi),
                  f"W={wv} {name}: l = block_n = 8192 equals the plain "
                  f"version")
        times, dev_times = {}, {}
        for name, kern, frag in (
                ("hist", hamming_topk_hist, "topk_hist_kernel"),
                ("argmin", hamming_topk_fused, "topk_fused_kernel"),
                ("hist_dma", hamming_topk_hist_dma, "topk_hist_dma_kernel")):
            def call(kern=kern):
                return kern(codes_w, q_w, SCAN_L, 4096, act_i, "16")
            times[name] = cuda_ms(torch, call, 10)
            _, prof = device_profile(
                torch, lambda: [call() for _ in range(5)], (frag,))
            dev_times[name] = kernel_device_ms(prof, frag)
        print(f"W={wv} (G=2, n={rows}, B={BATCH}, l={SCAN_L}, pack 16, 5% "
              f"tombstoned), l = block_n = 8192 identical for all three; ms "
              f"per call (CUDA events): " + json.dumps(times)
              + "; device time (torch.profiler; null where it saw no "
              "kernel): " + json.dumps(dev_times)
              + f"; pipelined / hist kernel: events "
              f"{times['hist_dma'] / times['hist']}, device "
              + str(dev_times["hist_dma"] / dev_times["hist"]
                    if dev_times["hist_dma"] and dev_times["hist"]
                    else "not measured"))
        del codes_w, q_w, act_w, act_i

    # -- 16. refresh path: re-learn and generation swap under traffic ------
    phase("16 refresh path")
    rcfg = IndexConfig(method="bh", bits=BITS, tables=TABLES, batch=BATCH,
                       lsm_delta_threshold=0.02, refresh_method="lbh")
    rrng = np.random.default_rng(args.seed + 3)
    r_base_del = np.array_split(
        rrng.choice(x_base.shape[0], BASE_DELETES, replace=False),
        STREAM_BATCHES)
    # rows that arrive while the refresh runs: perturbed copies of base
    # rows, made in bulk here (set-up)
    r_extra = (x_base[rrng.choice(x_base.shape[0], REFRESH_INSERTS,
                                  replace=False)]
               + np.float32(0.01) * rrng.standard_normal(
                   (REFRESH_INSERTS, d), dtype=np.float32))
    r_extra = np.split(r_extra, REFRESH_INSERTS // REFRESH_INSERT_ROWS)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    r_excluded = dict.fromkeys(read_counts(), 0)
    captures0 = learning.BitLoop.captures
    rlsm = LSMMultiTableIndex(rcfg, device="cuda").fit(x_base)
    rsvc = AsyncHashQueryService(rlsm, mode="scan", scan_l=SCAN_L,
                                 deadline_ms=2.0)
    mgr = rsvc.service.refresher
    # the calls the refresh makes, timed, to split its swap pause
    r_parts = []

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                r_parts.append((name, time.perf_counter() - t))
        return run

    mgr._catchup_round = timed("catch-up", mgr._catchup_round)
    mgr._reconcile_deletes = timed("reconcile", mgr._reconcile_deletes)
    rlsm._adopt_refresh = timed("adopt", rlsm._adopt_refresh)
    r_lat = {"before": [], "during": [], "after": []}
    r_across = []
    r_nq = [0]

    def generation():
        with rlsm._lock:
            return rlsm.generation

    def r_batch(when):
        """One micro-batch through the async front end; records its
        latency under when, and apart if the swap fell inside it."""
        k = (r_nq[0] % args.batches) * BATCH
        r_nq[0] += 1
        g0 = generation()
        t = time.perf_counter()
        res = [f.result(timeout=300)
               for f in [rsvc.submit(w) for w in ws[k:k + BATCH]]]
        lat = time.perf_counter() - t
        r_lat[when].append(lat)
        if generation() != g0:
            r_across.append(lat)
        return res

    def excluded(fn):
        """Run a check's fn with its kernel launches kept out of the
        path's counts (nothing else launches meanwhile)."""
        c0 = read_counts()
        out = fn()
        torch.cuda.synchronize()
        for k, v in read_counts().items():
            r_excluded[k] += v - c0[k]
        return out

    def recall_at_1():
        """recall@1 of the index's answers for wq against the exhaustive
        scan over its live rows."""
        with rlsm._lock:
            live = rlsm.active.copy()
            xl = rlsm.x_np[live].copy()
            il = rlsm.ids_np[live].copy()
        res = rlsm.query_scan_batch(wq, l=SCAN_L)
        wt = torch.from_numpy(wq).to(dev)
        xt = torch.from_numpy(xl).to(dev)
        with strict_fp32():
            best = ((xt @ wt.T).abs() / torch.linalg.vector_norm(
                wt, dim=1)).argmin(0).cpu().numpy()
        del xt
        return float((res.ids == il[best]).mean())

    rlsm.start_compactor()
    try:
        for i in range(STREAM_BATCHES):
            ids = rsvc.submit_insert(x_new[i * per:(i + 1) * per]).result(
                timeout=300)
            rsvc.submit_delete(r_base_del[i]).result(timeout=300)
            rsvc.submit_delete(rrng.choice(ids, new_del[i], replace=False)
                               ).result(timeout=300)
            for _ in range(2):
                r_batch("before")
        recall_before = excluded(recall_at_1)
        gen0 = generation()
        with rlsm._lock:
            ids_before = rlsm.ids_np[rlsm.active].copy()
        # deleted while the refresh runs: the swap must reconcile them
        r_dead = rrng.choice(ids_before, REFRESH_DELETES, replace=False)
        check(rsvc.refresh(wait=False), "the refresh started")
        t_refresh = time.perf_counter()
        j = 0
        while mgr.stats()["busy"]:
            r_batch("during")
            if j < len(r_extra):
                rsvc.submit_insert(r_extra[j]).result(timeout=300)
                if j == 0:
                    rsvc.submit_delete(r_dead).result(timeout=300)
                j += 1
        mgr.wait_idle(600)
        refresh_wall_s = time.perf_counter() - t_refresh
        hist_at_swap = hamming_topk_hist.launches
        for _ in range(16):
            r_batch("after")
        torch.cuda.synchronize()
    finally:
        rlsm.stop_compactor()
    refresh_launches = {k: v - r_excluded[k] for k, v in read_counts().items()}
    st = mgr.stats()
    print("refresh: " + json.dumps(st))
    # the swap's section: the last catch-up round, the reconcile and the
    # adopt; the rest of the pause is the wait for the index lock
    in_swap = {name: 1e3 * sec for name, sec in r_parts[-3:]}
    in_swap["lock wait and rest"] = st["last_swap_pause_ms"] - sum(
        in_swap.values())
    print(f"swap pause {st['last_swap_pause_ms']} ms: " + json.dumps(in_swap)
          + f"; catch-up rounds before it: {len(r_parts) - 3}")
    check(st["refreshes_done"] == 1 and st["refreshes_failed"] == 0
          and st["last_error"] is None,
          f"the refresh completed cleanly ({st['last_error']})")
    check(generation() == gen0 + 1, "the generation rose by one")
    r_captures = learning.BitLoop.captures - captures0
    print(f"launches on the refresh path (checks excluded): "
          f"{refresh_launches}; LBH graph captures {r_captures}; kernel 2 "
          f"launches after the swap {hamming_topk_hist.launches - hist_at_swap}"
          f"; inserts during the refresh {j} x {REFRESH_INSERT_ROWS} rows, "
          f"{REFRESH_DELETES} deletes; wall {refresh_wall_s:.2f} s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(r_captures == TABLES,
          "the re-learn captured one LBH step loop per table")
    check(refresh_launches["lbh_chain"] == TABLES * BITS * LBH_STEPS,
          "one chain launch per Nesterov step of every table's bits")
    check(refresh_launches["bilinear_hash_seeded"] > 0,
          "the seeded hash launched before the swap")
    check(hamming_topk_hist.launches - hist_at_swap > 0,
          "the hist scan ran on the new generation")
    check(st["last_catchup_rows"] > 0, "the catch-up mirrored rows")
    check(all(type(f).__name__ == "LBHHash" for f in rlsm.families),
          "the new generation's families are learned (LBH)")
    # the new generation against a fresh index installed over the same
    # live rows with the adopted families and the stable ids
    with rlsm._lock:
        live = rlsm.active.copy()
        live_ids = rlsm.ids_np[live].copy()
        x_live = rlsm.x_np[live].copy()
        codes_live = np.stack(rlsm.codes)[:, live]
        hi = rlsm._next_id
        fams = list(rlsm.families)
    fresh = LSMMultiTableIndex(rcfg, device="cuda")
    fresh._install(x_live, fams, ids=live_ids, next_id=hi)
    codes_fresh = np.stack(fresh.codes)
    n_diff = int((codes_live != codes_fresh).sum())
    if n_diff:
        rat = sign_flip_ratios(
            torch.from_numpy(x_live).to(dev), [(f.u, f.v) for f in fams],
            from_numpy_u32(codes_live, dev), from_numpy_u32(codes_fresh, dev))
        print(f"codes against the fresh install: {rat.numel()} bits differ, "
              f"largest |proj| / rounding bound {rat.max().item()}")
    print(f"codes of the {live.sum()} live rows equal the fresh install's: "
          f"{n_diff == 0}")
    check(n_diff == 0, "the swapped-in codes equal a fresh install's")
    dl, il = rlsm.scan_table_topk(wq, l=SCAN_L)
    df, i_f = fresh.scan_table_topk(wq, l=SCAN_L)
    check(np.array_equal(dl, df) and np.array_equal(il, i_f),
          "per-table lists equal the fresh install's")
    rl = rlsm.query_scan_batch(wq, l=SCAN_L, topk=4)
    rf = fresh.query_scan_batch(wq, l=SCAN_L, topk=4)
    check(np.array_equal(rl.ids_topk, rf.ids_topk)
          and all(np.array_equal(a, b)
                  for a, b in zip(rl.candidates, rf.candidates)),
          "answers (ids and candidates) equal the fresh install's")
    xb = np.zeros((hi, d), np.float32)
    xb[live_ids] = x_live
    terms = np.abs(xb[np.clip(rf.ids_topk, 0, None)] * wq[:, None, :]).sum(-1)
    m_tol = (d + 8) * 2.0 ** -23 * terms / np.linalg.norm(wq, axis=1)[:, None]
    m_diff = np.abs(rl.margins_topk - rf.margins_topk)
    check(bool((m_diff <= m_tol).all()),
          "margins equal the fresh install's within float32 rounding")
    print(f"the new generation equals a fresh install over {live.sum()} live "
          f"rows: lists and ids identical, margins identical: "
          f"{bool((m_diff == 0).all())}")
    still = np.setdiff1d(ids_before, r_dead)
    check(bool(rlsm.active[rlsm.ids_to_rows(still)].all()),
          "every stable id handed out before the refresh still resolves")
    with rlsm._lock:      # tombstoned, or folded out by a compaction since
        rows_dead = rlsm._row_of[r_dead]
        dead_gone = bool((~rlsm.active[np.clip(rows_dead, 0, None)]
                          | (rows_dead < 0)).all())
    check(dead_gone, "rows deleted during the refresh stay deleted")
    recall_after = recall_at_1()

    def lat_stats(a):
        a = np.asarray(a) * 1e3
        return ({"batches": int(a.size), "p95_ms": float(np.quantile(a, 0.95)),
                 "max_ms": float(a.max())} if a.size else None)

    refresh_stats = {
        "recall_at_1_before": recall_before,
        "recall_at_1_after": recall_after,
        "last_learn_s": st["last_learn_s"],
        "last_build_s": st["last_build_s"],
        "last_swap_pause_ms": st["last_swap_pause_ms"],
        "last_catchup_rows": st["last_catchup_rows"],
        "last_refresh_s": st["last_refresh_s"],
        **{f"micro_batch_{k}": lat_stats(v) for k, v in r_lat.items()},
        "micro_batch_across_swap_max_ms": (1e3 * max(r_across)
                                           if r_across else None),
        "compactions": rlsm.compactions}
    print("refresh path: " + json.dumps(refresh_stats))
    rsvc.close()
    del rlsm, rsvc, mgr, fresh
    torch.cuda.empty_cache()

    # -- 17. cluster path: 2 shards x 2 replicas, faults injected ----------
    phase("17 cluster path")
    ccfg = IndexConfig(method="bh", bits=BITS, tables=TABLES, batch=BATCH)
    plan = FaultPlan()
    t0 = time.perf_counter()
    router = ShardReplicaRouter(ccfg, shards=2, replicas=2,
                                fault_plan=plan).fit(x_base)
    csvc = HashQueryService(router, mode="scan", scan_l=SCAN_L)
    for s in range(2):
        for r in range(2):
            router.replica(s, r).upload_base()
    torch.cuda.synchronize()
    print(f"router fit (2 shards x 2 replicas over {x_base.shape[0]} rows, "
          f"bases uploaded): {time.perf_counter() - t0:.2f} s")
    zero_counts()
    c_lat = []
    for i in range(CLUSTER_BATCHES):
        k = (i % args.batches) * BATCH
        t = time.perf_counter()
        csvc.query_batch(ws[k:k + BATCH])
        c_lat.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    cluster_launches = read_counts()
    print(f"launches on the cluster path: {cluster_launches}")
    check(cluster_launches["bilinear_hash_seeded"] == 2 * CLUSTER_BATCHES
          and cluster_launches["hamming_topk_hist"] == 2 * CLUSTER_BATCHES,
          "each micro-batch hashed and scanned once on each shard")
    n_base = x_base.shape[0]

    def same_as_fresh(label, res, rows, x_rows):
        """res equals a fresh index's over x_rows (global ids rows): ids,
        margins, candidates and table hits bit for bit."""
        ref = MultiTableIndex(ccfg, device="cuda").fit(x_rows)
        want = ref.query_scan_batch(wq, l=SCAN_L, topk=4)
        same = {
            "ids": int((res.ids_topk != np.where(
                want.ids_topk >= 0, rows[np.clip(want.ids_topk, 0, None)],
                -1)).sum()),
            "margins": int((res.margins_topk != want.margins_topk).sum()),
            "table_hits": int((res.table_hits != want.table_hits).sum()),
            "candidate_lists": sum(
                not np.array_equal(a, np.sort(rows[b]))
                for a, b in zip(res.candidates, want.candidates))}
        check(not any(same.values()),
              f"{label}: answers equal a fresh index's over {rows.size} "
              f"rows (entries that differ: {same}; coverage "
              f"{res.coverage}; timeouts {router.stats()['timeouts']})")
        print(f"{label}: coverage {res.coverage}, degraded {res.degraded}; "
              f"identical to a fresh index over {rows.size} rows")
        del ref
        torch.cuda.empty_cache()

    all_rows = np.arange(n_base)
    same_as_fresh("healthy", router.query_scan_batch(wq, l=SCAN_L, topk=4),
                  all_rows, x_base)
    plan.kill(0, 1)
    for _ in range(2):      # the rotation tries both replicas of shard 0
        res = router.query_scan_batch(wq, l=SCAN_L, topk=4)
        check(res.coverage == 1.0, "fail-over keeps full coverage")
    same_as_fresh("fail-over (shard 0 replica 1 killed)", res, all_rows,
                  x_base)
    plan.kill(1, 0)
    plan.kill(1, 1)
    res = router.query_scan_batch(wq, l=SCAN_L, topk=4)
    check(res.degraded and 0 < res.coverage < 1, "shard 1 down: degraded")
    same_as_fresh("degraded (shard 1 down)", res, all_rows[0::2],
                  x_base[0::2])
    crng = np.random.default_rng(args.seed + 4)
    c_extra = (x_base[crng.choice(n_base, CLUSTER_INSERTS, replace=False)]
               + np.float32(0.01) * crng.standard_normal(
                   (CLUSTER_INSERTS, d), dtype=np.float32))
    for part in np.array_split(c_extra, 10):
        router.insert(part)
    c_alive = np.ones(n_base + CLUSTER_INSERTS, bool)
    c_dead = crng.choice(c_alive.size, CLUSTER_DELETES, replace=False)
    router.delete(c_dead)
    c_alive[c_dead] = False
    for s, r in ((0, 1), (1, 0), (1, 1)):
        plan.revive(s, r)
    for _ in range(6):
        res = router.query_scan_batch(wq, l=SCAN_L, topk=4)
        if res.coverage == 1.0 and router.stats()["replicas_alive"] == 4:
            break
    cst = router.stats()
    check(res.coverage == 1.0 and cst["replicas_alive"] == 4,
          "every replica re-admitted")
    check(cst["catchups"] >= 1, "re-admission caught replicas up")
    live_rows = np.flatnonzero(c_alive)
    same_as_fresh(f"recovered ({cst['catchups']} catch-ups after "
                  f"{CLUSTER_INSERTS} inserts and {CLUSTER_DELETES} deletes)",
                  res, live_rows,
                  np.concatenate([x_base, c_extra])[live_rows])
    check(cst["timeouts"] == 0, "no timeout on the healthy checks")
    print("router stats: " + json.dumps(
        {k: v for k, v in cst.items() if k not in ("health", "faults")}))
    del csvc                                           # router: phase 18
    torch.cuda.empty_cache()

    # the seeded soak: scripted kills, flaps, drops and delays under
    # traffic and writes; any uncaught exception fails the run
    t0 = time.perf_counter()
    soak_plan = FaultPlan.seeded(args.seed, 2, 2, horizon_calls=200)
    soak = ShardReplicaRouter(ccfg, shards=2, replicas=2,
                              fault_plan=soak_plan).fit(x_base)
    for s in range(2):
        for r in range(2):
            soak.replica(s, r).upload_base()
    ssvc = HashQueryService(soak, mode="scan", scan_l=SCAN_L)
    s_alive = np.ones(n_base, bool)
    s_cov, s_lat = [], []
    for i in range(SOAK_BATCHES):
        if i % 8 == 7:
            soak.insert(c_extra[i * 100:i * 100 + 500])
            s_alive = np.concatenate([s_alive, np.ones(500, bool)])
            dead = crng.choice(np.flatnonzero(s_alive), 250, replace=False)
            soak.delete(dead)
            s_alive[dead] = False
        k = (i % args.batches) * BATCH
        t = time.perf_counter()
        ssvc.query_batch(ws[k:k + BATCH])
        s_lat.append(time.perf_counter() - t)
        s_cov.append(ssvc.stats()["last_coverage"])
    sst = soak.stats()
    soak_stats = {k: sst[k] for k in ("failovers", "timeouts", "replica_downs",
                                      "readmits", "catchups", "write_skips",
                                      "degraded_answers")}
    soak_stats.update(
        batches=SOAK_BATCHES, injected=soak_plan.stats()["injected"],
        min_coverage=min(s_cov),
        p95_ms=1e3 * float(np.quantile(s_lat, 0.95)),
        max_ms=1e3 * max(s_lat), seconds=time.perf_counter() - t0)
    print("seeded fault soak (no uncaught exception): "
          + json.dumps(soak_stats))
    check(soak_plan.stats()["injected"] > 0, "the soak injected faults")
    c_lat_ms = 1e3 * np.asarray(c_lat)
    print("cluster path: " + json.dumps({
        "micro_batches": CLUSTER_BATCHES,
        "qps": CLUSTER_BATCHES * BATCH / float(np.sum(c_lat)),
        "p95_ms": float(np.quantile(c_lat_ms, 0.95)),
        "max_ms": float(c_lat_ms.max())}))
    soak.close()
    del soak, ssvc
    torch.cuda.empty_cache()

    # -- 18. sharded scan: the mesh= paths, S shards on this card ----------
    phase("18 sharded scan")
    shard_launches = sharded_phase(
        args, index, lsm, router, ws, wq, c_extra[:SHARD_INSERTS],
        BASE_DELETES, zero_counts, read_counts, records, smi)
    router.close()
    del index, lsm, router
    torch.cuda.empty_cache()

    # -- 19. the LM serving path: qwen3-1.7b at full width and depth -------
    phase("19 LM serving path")
    from repro_torch.configs.registry import get_arch
    lm_cfg = get_arch(LM_ARCH)
    model, lm_stats = lm_phase(args, lm_cfg, dev)

    # -- 20. the activation index path over the LM's activations ----------
    phase("20 activation index path")
    torch.cuda.reset_peak_memory_stats()
    act_launches, act_stats = activation_phase(args, lm_cfg, model, dev,
                                               zero_counts, read_counts,
                                               records)
    print(f"peak device memory in phase 20 "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print("LM and activation path stats: " + json.dumps(
        {"lm": lm_stats, "activation": act_stats}))
    del model
    torch.cuda.empty_cache()

    # -- 21. the MoE serving path: deepseek-moe-16b at full size ----------
    phase("21 MoE serving path")
    moe_stats = moe_phase(args, get_arch(MOE_ARCH), dev, zero_counts,
                          read_counts)
    print(f"card: {smi}")
    print("MoE path stats: " + json.dumps(moe_stats))

    # -- 22. times ----------------------------------------------------------
    phase("22 times")
    layer = ("hamming_topk_hist_dma", "hamming_distance_batch",
             "hamming_distance")
    kernels = []
    for name, rec in records.items():
        path = (shard_launches if name == "hamming_topk_fused"
                else layer_launches if name in layer
                else act_launches)
        rec["launches"] = path[name]
        kernels.append({k: rec[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(f"profiler sessions repeated for missing kernel records: "
          f"{len(PROFILE_REPEATS)} " + json.dumps(PROFILE_REPEATS))
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
