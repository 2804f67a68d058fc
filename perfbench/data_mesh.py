"""A configuration's rows drawn as shards, each on its own device, for a
cell whose pool no one device holds.

``tiny1m_shards`` draws the geometry of ``data.tiny1m`` (labelled class
clusters and an unlabelled tail pushed away from their centroid, a bias
column, rows l2-normalised) straight into S equal row ranges, shard s
holding rows [s R, (s + 1) R) with R = ceil(n / S), the last shard's tail
zero rows: the layout ``core.search.shard_rows`` gives.  The class means
and scales come from one stream of the seed; the labelled rows' places
from a seeded permutation of all n places, so they are spread over the
shards; each shard's rows from a stream of its own on its device.  No
device and no host ever holds all the rows.  The same seed and shard
count give the same rows.

``normals_sharded`` makes ``data.normals``' hyperplanes from per-shard
sums: the pool's mean and each class's mean are sums over the shards.
"""
from __future__ import annotations

import math

import torch

from perfbench.data import generator

SHARD_STREAM = 16       # shard s draws from stream SHARD_STREAM + s


def shard_layout(n: int, shards: int) -> tuple[int, list[int]]:
    """(R, the valid rows of each shard) for n rows over ``shards``."""
    rows = -(-n // shards)
    return rows, [min(max(n - s * rows, 0), rows) for s in range(shards)]


def tiny1m_shards(seed: int, devices, n_labeled: int, n_unlabeled: int,
                  d: int, classes: int):
    """(parts, labels, n): parts[s] the (R, d + 1) float32 rows of shard s
    on devices[s]; labels[s] = (local rows, classes) of its labelled rows;
    n the true row count (the rest is padding, zero rows)."""
    dev0 = devices[0]
    g = generator(seed, 1, dev0)
    means = torch.randn(classes, d, generator=g, device=dev0)
    means /= torch.linalg.vector_norm(means, dim=1, keepdim=True)
    scales = 0.25 + 0.15 * torch.rand(classes, d, generator=g, device=dev0)
    per = n_labeled // classes
    n = per * classes + n_unlabeled
    rows, valid = shard_layout(n, len(devices))
    lab_pos = torch.randperm(n, generator=g, device=dev0)[:per * classes]
    lab_cls = torch.arange(per * classes, device=dev0) // per
    shift = 0.8 * means.mean(dim=0)
    parts, labels = [], []
    for s, dev in enumerate(devices):
        lo = s * rows
        gs = generator(seed, SHARD_STREAM + s, dev)
        x = torch.empty((rows, d + 1), dtype=torch.float32, device=dev)
        body = x[:, :d]
        body.normal_(generator=gs)
        body -= shift.to(dev)
        body *= 0.9
        inside = (lab_pos >= lo) & (lab_pos < lo + valid[s])
        pos = (lab_pos[inside] - lo).to(dev)
        cls = lab_cls[inside].to(dev)
        lab = torch.randn((pos.numel(), d), generator=gs, device=dev)
        lab *= scales.to(dev)[cls]
        lab += means.to(dev)[cls]
        body[pos] = lab
        del lab
        x[:, d] = 1.0
        x /= torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                         min=1e-12)
        x[valid[s]:] = 0.0
        parts.append(x)
        labels.append((pos, cls))
    return parts, labels, n


def normals_sharded(parts, labels, n: int, classes: int, count: int,
                    seed: int, noise: float, device) -> torch.Tensor:
    """(count, d) float32 normals on ``device``, as ``data.normals`` makes
    them over the concatenated rows, from per-shard sums: the pool's mean
    over its n rows and class c's mean over its labelled rows."""
    rows, valid = shard_layout(n, len(parts))
    dim = parts[0].shape[1]
    total = torch.zeros(dim, dtype=torch.float32, device=device)
    sums = torch.zeros((classes, dim), dtype=torch.float32, device=device)
    cnt = torch.zeros(classes, dtype=torch.int64, device=device)
    for x, (pos, cls), v in zip(parts, labels, valid):
        total += x[:v].sum(dim=0).to(device)
        part = torch.zeros((classes, dim), dtype=torch.float32,
                           device=x.device)
        part.index_add_(0, cls, x[pos])
        sums += part.to(device)
        cnt += torch.bincount(cls, minlength=classes).to(device)
    mu = total / n
    mu_c = sums / cnt.clamp(min=1)[:, None]
    g = generator(seed, 3, device)
    c = torch.arange(count, device=device) % classes
    diff = mu_c[c] - mu
    z = torch.randn(diff.shape, generator=g, device=device)
    w = diff + noise * torch.linalg.vector_norm(diff, dim=1, keepdim=True
                                                ) * z / math.sqrt(dim)
    mid = (mu_c[c] + mu) / 2
    w[:, -1] = -(w[:, :-1] * mid[:, :-1]).sum(dim=1) / mid[:, -1]
    return w.contiguous()
