"""Online re-learning: drift -> stale recall -> refresh() -> repaired
recall, on the port.

Learned (LBH) hash functions are fit to a sample of the corpus, so a
corpus that drifts under streaming ingest is served by projections fit to
a corpus that no longer exists.  This example streams unseen tight
clusters into a live service, gauging recall on two query series (random
hyperplanes, and hyperplanes aimed at the drifted mass): the stale
generation keeps limping along at its old level.  Then
``service.refresh(wait=True)`` — snapshot the live rows, re-learn the
bilinear projections OFF the query path, rebuild a shadow index, swap
generations under the lock — re-fits the index to the corpus that exists
now, and both gauges jump.  Queries keep flowing the whole time; the only
pause any of them can observe is the pointer-flip swap (printed below,
milliseconds).

    PYTHONPATH=src python -m repro_torch.examples.refresh_loop [--device cuda]

The JAX package's ``examples/refresh_loop.py`` with its sizes, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.indexer import IndexConfig
from repro_torch.data.synthetic import tiny1m_like
from repro_torch.serving.lsm import LSMMultiTableIndex
from repro_torch.serving.service import HashQueryService

N, D, DRIFT = 2400, 48, 1200


def lift(raw):
    """Append the bias coordinate and L2-normalize, like the corpus."""
    z = np.concatenate([raw, np.ones((len(raw), 1), np.float32)], axis=1)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(11)
    # base corpus (lifted to d+1 with a bias coordinate by the generator)
    corpus = tiny1m_like(n_labeled=N, n_unlabeled=0, d=D, classes=10,
                         seed=7)
    dd = corpus.x.shape[1]

    # the drift: ten TIGHT clusters at unit directions the learner never
    # saw
    means = rng.normal(size=(10, D)).astype(np.float32)
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    x_drift = lift(np.concatenate(
        [m + 0.1 * rng.normal(size=(DRIFT // 10, D)).astype(np.float32)
         for m in means]))

    cfg = IndexConfig(method="lbh", bits=16, tables=2, seed=5,
                      lsm_auto=False, lbh_sample=256, lbh_steps=75,
                      lbh_lr=0.03)
    index = LSMMultiTableIndex(cfg, device=args.device).fit(corpus.x)
    service = HashQueryService(index, max_batch=8, mode="scan", scan_l=64)

    # id bookkeeping on the CALLER side: fit/insert assign monotonically
    # increasing stable ids, so our own row mirror indexes by id — no
    # index internals needed for ground truth
    x_by_id = corpus.x.copy()
    dead = np.zeros(len(x_by_id), dtype=bool)

    ws_rand = rng.normal(size=(64, dd)).astype(np.float32)
    # drift-focused series: hyperplanes orthogonal to a drifted cluster
    # mean, so their true min-margin rows live inside the mass the stale
    # codes never saw
    lifted = lift(means.copy())
    ws_drift = rng.normal(size=(64, dd)).astype(np.float32)
    for i in range(len(ws_drift)):
        m = lifted[i % 10]
        ws_drift[i] -= (ws_drift[i] @ m) * m
        ws_drift[i] /= np.linalg.norm(ws_drift[i])

    def recall_at20(ws):
        """Fraction of queries whose served answer lands in the true
        (brute-force) top-20 min-|margin| set over the live rows."""
        live_ids = np.flatnonzero(~dead)
        margins = np.abs(x_by_id[live_ids] @ ws.T)        # (live, Q)
        hits = 0
        for q, res in enumerate(service.query_batch(ws)):
            top20 = live_ids[np.argsort(margins[:, q], kind="stable")[:20]]
            hits += res.index in set(int(i) for i in top20)
        return hits / len(ws)

    def report(phase):
        print(f"recall@20 {phase:13s} random {recall_at20(ws_rand):.3f}   "
              f"drift-focused {recall_at20(ws_drift):.3f}   "
              f"(generation {index.generation})")

    report("pre-drift:")

    # churn: drifted rows in through the service, an equal count of base
    # rows out — live size stays constant, so recall moves with code
    # quality only
    for i in range(0, DRIFT, 150):
        service.insert(x_drift[i:i + 150])
    x_by_id = np.concatenate([x_by_id, x_drift])
    dead = np.concatenate([dead, np.zeros(DRIFT, dtype=bool)])
    gone = np.arange(N - DRIFT, N, dtype=np.int64)
    index.delete(gone)
    dead[gone] = True

    report("post-drift:")

    # re-learn + zero-downtime swap; wait=True blocks until the swap lands
    assert service.refresh(wait=True)
    ref = service.refresher.stats()

    report("post-refresh:")
    print(f"refresh cost: learn {ref['last_learn_s']:.2f}s + build "
          f"{ref['last_build_s']:.2f}s off-lock; swap pause "
          f"{ref['last_swap_pause_ms']:.2f}ms under the lock; "
          f"{ref['last_catchup_rows']} rows caught up mid-refresh")

    # hands-free variant: IndexConfig(refresh_ingest_rows=N) arms the same
    # refresh automatically every N inserted rows (background,
    # non-blocking)


if __name__ == "__main__":
    main()
