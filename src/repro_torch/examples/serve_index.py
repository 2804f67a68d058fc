"""Walkthrough: serving hyperplane queries at batch scale, on the port.

Builds a 4-table bilinear-hash index over a synthetic pool, fronts it with
the micro-batching HashQueryService, then exercises the full serving story:
batched queries, the query-code cache, dynamic insert/delete without a
rebuild, and the device-side batched scan fallback.

    PYTHONPATH=src python -m repro_torch.examples.serve_index [--device cuda]

The JAX package's ``examples/serve_index.py`` with its sizes and
assertions, plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.indexer import IndexConfig
from repro_torch.data.synthetic import tiny1m_like
from repro_torch.serving.multi_table import MultiTableIndex
from repro_torch.serving.service import HashQueryService


def _rounded(stats: dict) -> dict:
    return {k: round(v, 2) if isinstance(v, float) else v
            for k, v in stats.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # -- build: L=4 tables, 18-bit codes, radius-3 multi-probe -------------
    corpus = tiny1m_like(n_labeled=10_000, n_unlabeled=0, d=64, classes=10)
    cfg = IndexConfig(method="bh", bits=18, radius=3, tables=4, batch=32)
    index = MultiTableIndex(cfg, device=args.device).fit(corpus.x)
    print("index:", {k: v for k, v in index.stats().items()
                     if k != "per_table"})

    service = HashQueryService(index)

    # -- batched queries ---------------------------------------------------
    rng = np.random.default_rng(0)
    ws = rng.normal(size=(32, corpus.x.shape[1])).astype(np.float32)
    results = service.query_batch(ws)
    margins = np.asarray([r.margin for r in results])
    print(f"32-query batch: {sum(r.nonempty for r in results)}/32 nonempty, "
          f"mean margin {margins[np.isfinite(margins)].mean():.4f}")

    # -- micro-batching: submit requests one by one, answer them as one
    # batch
    for w in ws[:10]:
        service.submit(w)
    batch = service.flush()
    assert [r.index for r in batch] == [r.index for r in results[:10]]

    # -- the query-code cache makes repeats nearly free --------------------
    service.query_batch(ws)
    print("service:", _rounded(service.stats()))

    # -- dynamic updates: grow and shrink the pool without a rebuild -------
    new_ids = index.insert(rng.normal(
        size=(500, corpus.x.shape[1])).astype(np.float32))
    index.delete(new_ids[:250])
    print(f"after insert/delete: n={index.n}, version={index.version}")
    post = service.query_batch(ws[:8])      # cache invalidated automatically
    print("post-update answers:", [r.index for r in post])

    # -- heavy delete churn: compaction keeps the tables from growing ------
    # Tombstoned rows pile up in codes/tables/x until the dead fraction
    # passes IndexConfig.compact_threshold (default 0.5), when the index
    # compacts itself; ids stay stable — answers still use the original
    # insert/fit ids.
    index.delete(np.arange(0, 6000))
    st = index.stats()
    print(f"after churn: n={st['n']}, rows={st['rows']}, "
          f"compactions={st['compactions']}")
    post = service.query_batch(ws[:8])
    assert all(r.index >= 6000 for r in post if r.nonempty)
    print("post-compaction answers (stable ids):", [r.index for r in post])

    # -- device-side batched Hamming scan (the shardable no-table path) ----
    # One fused kernel launch covers all 4 tables and the whole batch; the
    # result object is interchangeable with the probe path above.  To
    # row-shard the code stack over the visible cards, pass a mesh:
    #   from repro_torch.utils.mesh import make_mesh
    #   mesh = make_mesh((torch.cuda.device_count(),), ("data",))
    #   index.query_scan_batch(ws, l=32, mesh=mesh)   # bit-identical answers
    scan = index.query_scan_batch(ws[:8], l=32)
    print("scan ids:", scan.ids.tolist())

    # The service can serve the same traffic entirely from the fused scan:
    scan_service = HashQueryService(index, mode="scan", scan_l=32)
    scan_results = scan_service.query_batch(ws[:8])
    assert [r.index for r in scan_results] == scan.ids.tolist()
    print("scan service:", _rounded(scan_service.stats()))


if __name__ == "__main__":
    main()
