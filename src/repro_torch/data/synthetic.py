"""Synthetic stand-ins for the paper's datasets (no internet in this env).

- ``newsgroups_like``: geometry of the 20 Newsgroups tf-idf corpus — high-dim,
  sparse, l2-normalized, 20 classes with topic structure (documents within a
  class share directions; |cos| between same-class docs is high, across
  classes near 0 — exactly the regime eq. 12's thresholds target).
- ``tiny1m_like``: geometry of Tiny-1M GIST — dense 384-d, 10 labeled classes
  plus a large unlabeled 'other' tail (label -1) drawn away from the class
  means (the paper sampled the 1M farthest images from the CIFAR mean).

Absolute MAP numbers are not comparable to the paper's (different data);
method *orderings* and collision laws are distribution-free and are what
EXPERIMENTS.md validates.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Corpus:
    x: np.ndarray          # (n, d) float32, l2-normalized, bias dim appended
    y: np.ndarray          # (n,) int64; -1 = unlabeled 'other'
    num_classes: int
    name: str


def _append_bias_and_normalize(x: np.ndarray) -> np.ndarray:
    # Paper §2: append 1 to each data vector, use linear kernel; hyperplane
    # passes through the origin of the lifted space.
    x = np.concatenate([x, np.ones((x.shape[0], 1), x.dtype)], axis=1)
    x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    return x


def newsgroups_like(n: int = 18846, d: int = 2000, classes: int = 20,
                    topics_per_class: int = 40, density: float = 0.03,
                    seed: int = 0) -> Corpus:
    rng = np.random.default_rng(seed)
    x = np.zeros((n, d), np.float32)
    y = rng.integers(0, classes, n)
    class_topics = [rng.choice(d, topics_per_class, replace=False)
                    for _ in range(classes)]
    nnz = max(4, int(density * d))
    background_p = np.full(d, 1.0 / d)
    for c in range(classes):
        idx = np.flatnonzero(y == c)
        p = background_p.copy()
        p[class_topics[c]] += 12.0 / d
        p /= p.sum()
        for i in idx:
            words = rng.choice(d, nnz, replace=True, p=p)
            counts = rng.zipf(1.6, nnz).clip(max=20)
            np.add.at(x[i], words, counts.astype(np.float32))
    # tf-idf-ish weighting
    df = (x > 0).sum(axis=0) + 1
    x *= np.log(n / df)[None, :].astype(np.float32)
    return Corpus(_append_bias_and_normalize(x), y.astype(np.int64),
                  classes, "newsgroups-like")


def tiny1m_like(n_labeled: int = 60000, n_unlabeled: int = 1000000,
                d: int = 384, classes: int = 10, seed: int = 0) -> Corpus:
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(classes, d)).astype(np.float32)
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    scales = (0.25 + 0.15 * rng.random((classes, d))).astype(np.float32)

    per = n_labeled // classes
    xs, ys = [], []
    for c in range(classes):
        pts = means[c] + scales[c] * rng.normal(size=(per, d)).astype(np.float32)
        xs.append(pts)
        ys.append(np.full(per, c, np.int64))
    if n_unlabeled:
        # 'other' tail: directions repelled from the class-mean centroid
        centroid = means.mean(axis=0)
        tail = rng.normal(size=(n_unlabeled, d)).astype(np.float32)
        tail -= 0.8 * centroid[None, :]
        tail *= 0.9
        xs.append(tail)
        ys.append(np.full(n_unlabeled, -1, np.int64))
    x = np.concatenate(xs, axis=0)
    y = np.concatenate(ys)
    perm = rng.permutation(x.shape[0])
    return Corpus(_append_bias_and_normalize(x[perm]), y[perm],
                  classes, "tiny1m-like")
