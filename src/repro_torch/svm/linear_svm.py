"""One-vs-all linear SVM in PyTorch (the paper's LIBLINEAR replacement).

Primal L2-regularised squared-hinge loss, minimised with Nesterov's method
(deterministic full-batch: the AL pools fit in device memory, and the
solver must be cheap to re-run hundreds of times with warm starts).  Data
vectors carry the appended bias dim (paper §2), so the classifier is
f(x) = w.x with the hyperplane through the origin of the lifted space.
The gradient comes from autograd, as the JAX package's from ``jax.grad``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.functions import strict_fp32


def svm_loss(w, x, y, mask, l2: float):
    """Squared hinge: mean_i mask_i * max(0, 1 - y_i w.x_i)^2 + l2 ||w||^2.

    w: (d,) or (C, d) with y, mask (n,) or (C, n): a leading class axis
    gives one loss per class, (C,)."""
    with strict_fp32():
        scores = (x @ w.T).T if w.dim() == 2 else x @ w   # (C, n) or (n,)
    hinge = torch.clamp(1.0 - y * scores, min=0.0) ** 2
    denom = torch.clamp(mask.sum(dim=-1), min=1.0)
    return (mask * hinge).sum(dim=-1) / denom + l2 * (w * w).sum(dim=-1)


def _nesterov(w0, x, y, mask, l2: float, steps: int, lr: float):
    """Nesterov's method on svm_loss for C classes at once: w0 (C, d),
    y, mask (C, n).  The classes do not interact, so the gradient of the
    summed loss is each class's own."""
    w, w_prev = w0, w0
    t = np.float32(1.0)
    for _ in range(steps):
        t_next = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        mu = float((t - np.float32(1.0)) / t_next)
        v = (w + mu * (w - w_prev)).requires_grad_(True)
        (g,) = torch.autograd.grad(svm_loss(v, x, y, mask, l2).sum(), v)
        w, w_prev, t = (v - lr * g).detach(), w, t_next
    return w


def train_svm(w0, x, y, mask, *, l2: float = 1e-3, steps: int = 100,
              lr: float = 0.5):
    """Train one binary SVM.  x: (n, d); y: (n,) in {-1, +1}; mask: (n,)
    selects the labelled subset.  Warm-startable via w0 (d,)."""
    return _nesterov(w0[None], x, y[None], mask.to(x.dtype)[None], l2,
                     steps, lr)[0]


def train_ova(w0, x, labels, label_mask, num_classes: int, *,
              l2: float = 1e-3, steps: int = 100, lr: float = 0.5):
    """All one-vs-all SVMs at once, one (C, d) weight tensor.

    w0: (C, d) warm start; labels: (n,) int; label_mask: (n,) bool, the
    points currently labelled.  Returns (C, d)."""
    classes = torch.arange(num_classes, device=x.device)
    y = torch.where(labels[None, :] == classes[:, None], 1.0, -1.0)
    mask = label_mask.to(x.dtype)[None, :].expand(num_classes, -1)
    return _nesterov(w0, x, y.to(x.dtype), mask, l2, steps, lr)


def average_precision(scores, positives):
    """AP of ranking ``scores`` (higher first) against boolean positives,
    over the last axis (leading axes are independent rankings).  The sort
    is stable, as ``jnp.argsort``: tied scores keep their index order."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    hits = torch.gather(positives, -1, order).to(torch.float32)
    cum = torch.cumsum(hits, dim=-1)
    ranks = torch.arange(1, scores.shape[-1] + 1, dtype=torch.float32,
                         device=scores.device)
    return ((cum / ranks) * hits).sum(dim=-1) / torch.clamp(
        hits.sum(dim=-1), min=1.0)
