"""The cells' data and query normals, made on the device from the seed.

Re-writes in torch of the geometry of the port's numpy stand-ins for the
paper's data sets (``data/synthetic.py``: ``tiny1m_like``,
``newsgroups_like``), drawn in a few large calls from one
``torch.Generator`` on the device, so that set-up pays no host loop and
no host-to-device copy of the rows.  The same seed gives the same rows.

- ``tiny1m``: dense 384-d GIST-like rows, ``classes`` labelled clusters
  (mean + per-dimension scale) and an unlabelled tail pushed away from
  the class centroid (label -1), shuffled; then a bias column of 1 and
  l2 normalisation (the paper's lifted space, §2).
- ``news20``: sparse tf-idf-like rows of ``nnz = density d`` word draws
  from a class distribution that puts extra mass on the class's topic
  words, Zipf(1.6) counts clipped at 20, idf weighting; bias, normalised.

``normals`` makes the hyperplanes of rounds of a one-vs-all linear SVM
learner: in each round of C normals (C classes), normal c is the
difference of class c's mean and the pool's mean plus seeded noise, with
the bias coordinate set so that the hyperplane passes midway between the
two means, so it cuts the data.
"""
from __future__ import annotations

import math

import torch

ZIPF_A, ZIPF_CLIP = 1.6, 20


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of the seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def _bias_normalise(x: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, d + 1): a column of 1 appended, rows l2-normalised."""
    out = torch.empty((x.shape[0], x.shape[1] + 1), dtype=torch.float32,
                      device=x.device)
    out[:, :-1] = x
    out[:, -1] = 1.0
    out /= torch.clamp(torch.linalg.vector_norm(out, dim=1, keepdim=True),
                       min=1e-12)
    return out


def tiny1m(seed: int, device, n_labeled: int, n_unlabeled: int, d: int,
           classes: int):
    """(x (n, d + 1) float32, y (n,) int64): the Tiny-1M geometry."""
    g = generator(seed, 1, device)
    means = torch.randn(classes, d, generator=g, device=device)
    means /= torch.linalg.vector_norm(means, dim=1, keepdim=True)
    scales = 0.25 + 0.15 * torch.rand(classes, d, generator=g, device=device)
    per = n_labeled // classes
    n = per * classes + n_unlabeled
    x = torch.empty((n, d), dtype=torch.float32, device=device)
    lab = x[:per * classes].view(classes, per, d)
    torch.randn(classes, per, d, generator=g, device=device, out=lab)
    lab *= scales[:, None, :]
    lab += means[:, None, :]
    tail = x[per * classes:]
    torch.randn(tail.shape, generator=g, device=device, out=tail)
    tail -= 0.8 * means.mean(dim=0)
    tail *= 0.9
    y = torch.cat([torch.arange(classes, device=device).repeat_interleave(
        per), torch.full((n_unlabeled,), -1, device=device)])
    perm = torch.randperm(n, generator=g, device=device)
    return _bias_normalise(x[perm]), y[perm]


def _zipf_table(device) -> torch.Tensor:
    """P(count = c), c = 1..20, of a Zipf(1.6) draw clipped at 20."""
    # zeta(1.6): 1,000 terms and the Euler-Maclaurin tail (error < 1e-12)
    m, a = 1000, ZIPF_A
    zeta = sum(c ** -a for c in range(1, m + 1))
    zeta += m ** (1 - a) / (a - 1) - m ** -a / 2 + a * m ** (-a - 1) / 12
    p = [c ** -ZIPF_A / zeta for c in range(1, ZIPF_CLIP)]
    p.append(1.0 - sum(p))
    return torch.tensor(p, dtype=torch.float64, device=device)


def news20(seed: int, device, n: int, d: int, classes: int,
           topics_per_class: int, density: float):
    """(x (n, d + 1) float32, y (n,) int64): the 20 Newsgroups geometry."""
    g = generator(seed, 2, device)
    y = torch.randint(0, classes, (n,), generator=g, device=device)
    topics = torch.rand(classes, d, generator=g, device=device).argsort(
        dim=1)[:, :topics_per_class]
    p = torch.full((classes, d), 1.0 / d, dtype=torch.float64, device=device)
    p.scatter_add_(1, topics, torch.full(topics.shape, 12.0 / d,
                                         dtype=torch.float64, device=device))
    p /= p.sum(dim=1, keepdim=True)
    nnz = max(4, int(density * d))
    x = torch.zeros((n, d), dtype=torch.float32, device=device)
    zipf = _zipf_table(device)
    order = torch.argsort(y, stable=True)
    counts_per_class = torch.bincount(y, minlength=classes).tolist()
    start = 0
    for c, cnt in enumerate(counts_per_class):
        docs = order[start:start + cnt]
        start += cnt
        if cnt == 0:
            continue
        words = torch.multinomial(p[c], cnt * nnz, replacement=True,
                                  generator=g).view(cnt, nnz)
        counts = (torch.multinomial(zipf, cnt * nnz, replacement=True,
                                    generator=g) + 1).view(cnt, nnz)
        x.index_put_((docs[:, None].expand(cnt, nnz), words),
                     counts.to(torch.float32), accumulate=True)
    df = (x > 0).sum(dim=0) + 1
    x *= torch.log(n / df.to(torch.float32))[None, :]
    return _bias_normalise(x), y


def make(config: dict, seed: int, device):
    """The rows of a configuration: (x, y) per ``config["data"]``."""
    data = dict(config["data"])
    kind = data.pop("generator")
    if kind == "tiny1m":
        return tiny1m(seed, device, **data)
    if kind == "news20":
        return news20(seed, device, **data)
    raise ValueError(f"unknown data generator {kind!r}")


def normals(x: torch.Tensor, y: torch.Tensor, count: int, seed: int,
            noise: float) -> torch.Tensor:
    """(count, d) float32 one-vs-all hyperplane normals over rows (x, y),
    normal i for the i-th class mod C (so C consecutive normals are one
    round of the learner): (mu_c - mu) + noise |mu_c - mu| z / sqrt(d)
    with z standard normal, its bias (last) coordinate then set so that
    w . (mu_c + mu) / 2 = 0."""
    g = generator(seed, 3, x.device)
    labels = torch.unique(y[y >= 0])
    mu = x.mean(dim=0)
    sums = torch.zeros((int(labels.max()) + 1, x.shape[1]),
                       dtype=torch.float32, device=x.device)
    lab = y >= 0
    sums.index_add_(0, y[lab], x[lab])
    cnt = torch.bincount(y[lab], minlength=sums.shape[0]).clamp(min=1)
    mu_c = sums / cnt[:, None]
    c = labels[torch.arange(count, device=x.device) % labels.numel()]
    diff = mu_c[c] - mu
    z = torch.randn(diff.shape, generator=g, device=x.device)
    w = diff + noise * torch.linalg.vector_norm(diff, dim=1, keepdim=True
                                                ) * z / math.sqrt(x.shape[1])
    mid = (mu_c[c] + mu) / 2
    w[:, -1] = -(w[:, :-1] * mid[:, :-1]).sum(dim=1) / mid[:, -1]
    return w.contiguous()
