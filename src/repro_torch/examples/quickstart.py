"""Quickstart: build a compact hyperplane-hash index and answer a
point-to-hyperplane query (the paper's core operation), on the port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda]

The JAX package's ``examples/quickstart.py`` with its sizes, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.indexer import HyperplaneIndex, IndexConfig
from repro_torch.data.synthetic import tiny1m_like


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # a database of points (GIST-like synthetic stand-in for Tiny-1M)
    corpus = tiny1m_like(n_labeled=20000, n_unlabeled=0, d=128, classes=10)
    print(f"database: {corpus.x.shape}")

    # learn 20-bit bilinear hash functions and build ONE hash table
    # (paper §4)
    index = HyperplaneIndex(IndexConfig(method="lbh", bits=20, radius=4,
                                        lbh_sample=800, lbh_steps=80),
                            device=args.device)
    index.fit(corpus.x)
    print(f"fit in {index.fit_s:.1f}s on {index.device}; table stats: "
          f"{index.table.stats()}")

    # a hyperplane query (e.g. an SVM decision boundary's normal vector)
    w = np.random.default_rng(0).normal(
        size=corpus.x.shape[1]).astype(np.float32)

    res = index.query(w)                   # flip-code lookup + exact re-rank
    margins = np.abs(corpus.x @ w) / np.linalg.norm(w)
    rank = int((margins < res.margin).sum()) if res.nonempty else -1
    print(f"table lookup: nonempty={res.nonempty} "
          f"candidates={res.candidates.size} margin={res.margin:.5f} (true "
          f"rank {rank}/{len(margins)}; brute-force min "
          f"{margins.min():.5f})")

    i, m = index.query_scan(w, l=64)       # device-side scan path
    print(f"device scan:  idx={i} margin={m:.5f} "
          f"(rank {(margins < m - 1e-12).sum()})")


if __name__ == "__main__":
    main()
