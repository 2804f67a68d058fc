"""Walkthrough: async serving — concurrent callers sharing device launches,
on the port.

``serve_index`` covers the synchronous service, where one caller owns the
batch.  Here C independent callers (threads — think the paper's C
one-vs-all SVM learners, each issuing its own hyperplane query) submit to
an AsyncHashQueryService and the deadline-flush loop coalesces their
requests into shared batched device passes: a batch fires when it reaches
``max_batch`` or when its oldest request has waited ``deadline_ms``.

    PYTHONPATH=src python -m repro_torch.examples.serve_async [--device cuda]

The JAX package's ``examples/serve_async.py`` with its sizes and
assertions, plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions).
"""
from __future__ import annotations

import argparse
import threading

import numpy as np

from repro_torch.core.indexer import IndexConfig
from repro_torch.data.synthetic import tiny1m_like
from repro_torch.serving.async_service import (AsyncHashQueryService,
                                               QueueFullError)
from repro_torch.serving.multi_table import MultiTableIndex
from repro_torch.serving.service import HashQueryService


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # -- build: same index the sync walkthrough uses -----------------------
    corpus = tiny1m_like(n_labeled=10_000, n_unlabeled=0, d=64, classes=10)
    cfg = IndexConfig(method="bh", bits=18, radius=3, tables=4, batch=32)
    index = MultiTableIndex(cfg, device=args.device).fit(corpus.x)

    rng = np.random.default_rng(0)
    ws = rng.normal(size=(96, corpus.x.shape[1])).astype(np.float32)

    # -- concurrent callers, one service -----------------------------------
    service = AsyncHashQueryService(index, max_batch=32, deadline_ms=5.0,
                                    max_queue=256)
    results: dict[int, object] = {}

    def caller(lo: int, hi: int) -> None:
        # each thread is an independent learner: submit, then block on
        # its futures
        futs = [(i, service.submit(ws[i])) for i in range(lo, hi)]
        for i, f in futs:
            results[i] = f.result()

    threads = [threading.Thread(target=caller, args=(c * 24, (c + 1) * 24))
               for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    stats = service.stats()
    print(f"96 requests from 4 threads -> {stats['flushes']} device flushes "
          f"(mean batch {stats['mean_batch']:.1f}), "
          f"p95 latency {stats['latency_ms']['p95']:.1f} ms")
    print("batch-size histogram:", stats["batch_size_hist"])

    # -- answers are bit-identical to the synchronous batch ----------------
    sync = HashQueryService(index, max_batch=32)
    for i, r in enumerate(sync.query_batch(ws)):
        assert results[i].index == r.index and results[i].margin == r.margin
    print("async answers == sync query_batch, all 96")

    # -- admission control: a bounded queue sheds instead of stretching
    # the tail
    tiny = AsyncHashQueryService(index, max_batch=8, deadline_ms=50.0,
                                 max_queue=8, start=False)  # no flush thread
    shed = 0
    for w in ws[:12]:
        try:
            tiny.submit(w)
        except QueueFullError:
            shed += 1
    print(f"bounded queue (max_queue=8): {shed}/12 shed explicitly")
    tiny.close()            # drains the 8 admitted requests
    service.close()
    print("closed; queue depth", service.stats()["queue_depth"])


if __name__ == "__main__":
    main()
