"""SVM active learning with hash-accelerated min-margin selection (paper §5).

Protocol (the JAX package's, which follows the paper's setup):
- start from a small labelled seed (init_per_class per class);
- at every AL iteration, each class's one-vs-all SVM issues one hyperplane
  query; the returned min-margin point is added to the shared labelled pool
  with its true label; all SVMs are then retrained (warm-started);
- metrics: MAP over the remaining unlabelled pool, the selected points'
  margins (vs. the exhaustive optimum), and per-class nonempty-lookup counts;
- an empty hash lookup falls back to random selection (paper §5.2).

Selectors: random / exhaustive (the two baselines) and one per hash family
(AH, EH, BH, LBH) through a MultiTableIndex built once over the pool and
fronted by a HashQueryService: the C per-iteration hyperplane queries go
out as one micro-batch.  The host-side random draws use numpy's
``default_rng`` in the JAX package's call order, so the initial labelled
set and the random fallbacks are the same for the same seed.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.functions import strict_fp32
from repro_torch.core.indexer import IndexConfig
from repro_torch.data.synthetic import Corpus
from repro_torch.serving.async_service import AsyncHashQueryService
from repro_torch.serving.multi_table import MultiTableIndex
from repro_torch.serving.service import HashQueryService
from repro_torch.svm.linear_svm import average_precision, train_ova
from repro_torch.utils.device import as_float_tensor, resolve_device


@dataclasses.dataclass
class ALConfig:
    iterations: int = 100
    init_per_class: int = 5
    svm_steps: int = 20
    svm_l2: float = 1e-3
    svm_lr: float = 0.5
    eval_every: int = 10
    seed: int = 0


@dataclasses.dataclass
class ALResult:
    name: str
    eval_iters: np.ndarray     # iterations at which MAP was computed
    map_curve: np.ndarray      # (len(eval_iters),)
    min_margins: np.ndarray    # (iterations,) mean selected margin per iter
    exhaustive_margins: np.ndarray  # (iterations,) mean optimal margin
    nonempty: np.ndarray       # (C,) nonempty lookups per class
    select_seconds: float
    total_seconds: float
    fit_seconds: float = 0.0


# ---------------------------------------------------------------------------
# Selectors: prepare(corpus), then select_batch(w_all, unlabeled) ->
# (picks, nonempty flags), one per class
# ---------------------------------------------------------------------------

class RandomSelector:
    name = "random"

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def prepare(self, corpus: Corpus):
        return self

    def select(self, c: int, w: np.ndarray, unlabeled: np.ndarray):
        pool = np.flatnonzero(unlabeled)
        return int(self.rng.choice(pool)), True

    def select_batch(self, w_all: np.ndarray, unlabeled: np.ndarray):
        out = [self.select(c, w_all[c], unlabeled)
               for c in range(w_all.shape[0])]
        return [i for i, _ in out], [ok for _, ok in out]


class ExhaustiveSelector:
    name = "exhaustive"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def prepare(self, corpus: Corpus):
        self.x = torch.from_numpy(corpus.x).to(self.device)
        return self

    def select_all(self, w_all, unlabeled: np.ndarray) -> np.ndarray:
        """(C,) argmin-margin indices over the unlabelled pool, per class
        (ties to the lowest index)."""
        w_all = as_float_tensor(w_all, self.device)
        with strict_fp32():    # ||w|| drops out of the argmin
            margins = torch.abs(self.x @ w_all.T)                  # (n, C)
        unl = torch.from_numpy(np.asarray(unlabeled, bool)).to(self.device)
        margins = torch.where(unl[:, None], margins, torch.inf)
        return torch.argmin(margins, dim=0).cpu().numpy()

    def select(self, c: int, w, unlabeled: np.ndarray):
        return int(self.select_all(np.asarray(w, np.float32)[None, :],
                                   unlabeled)[0]), True

    def select_batch(self, w_all: np.ndarray, unlabeled: np.ndarray):
        picks = self.select_all(w_all, unlabeled)
        return [int(i) for i in picks], [True] * len(picks)


class HashSelector:
    """Min-margin selection through a MultiTableIndex + HashQueryService.

    All C per-iteration hyperplane queries go through the service as one
    micro-batch; an empty (post-mask) lookup falls back to random selection
    exactly as the paper prescribes (§5.2).

    With ``use_async`` each learner submits its own query to an
    AsyncHashQueryService (a future per class: the paper's C concurrent
    learners) and the deadline-flush loop coalesces them into shared
    launches; ``flush()`` after the burst bounds the last learner's wait.
    The picks equal the synchronous selector's.
    """

    def __init__(self, index_config: IndexConfig, seed: int = 0,
                 use_async: bool = False, deadline_ms: float = 2.0,
                 device="cuda"):
        self.config = index_config
        self.name = index_config.method
        self.rng = np.random.default_rng(seed)
        self.use_async = use_async
        self.deadline_ms = deadline_ms
        self.device = resolve_device(device)
        self.index: MultiTableIndex | None = None
        self.service: HashQueryService | AsyncHashQueryService | None = None

    def prepare(self, corpus: Corpus):
        self.index = MultiTableIndex(self.config, device=self.device).fit(
            corpus.x)
        if self.use_async:
            self.service = AsyncHashQueryService(
                self.index, max_batch=self.config.batch,
                deadline_ms=self.deadline_ms)
        else:
            self.service = HashQueryService(self.index,
                                            max_batch=self.config.batch)
        return self

    def finish(self) -> None:
        """Release the flush thread (async mode); sync mode is a no-op."""
        if isinstance(self.service, AsyncHashQueryService):
            self.service.close()

    def select(self, c: int, w, unlabeled: np.ndarray):
        picks, oks = self.select_batch(
            np.asarray(w, np.float32)[None, :], unlabeled)
        return picks[0], oks[0]

    def select_batch(self, w_all: np.ndarray, unlabeled: np.ndarray):
        if isinstance(self.service, AsyncHashQueryService):
            # one independent learner per class, each submitting its own
            # query; the service coalesces the burst into shared launches
            futures = [self.service.submit(w_all[c], mask=unlabeled)
                       for c in range(w_all.shape[0])]
            self.service.flush()
            results = [f.result() for f in futures]
        else:
            results = self.service.query_batch(w_all, mask=unlabeled)
        picks, oks = [], []
        for res in results:
            if res.nonempty:
                picks.append(res.index)
                oks.append(True)
            else:
                picks.append(int(self.rng.choice(np.flatnonzero(unlabeled))))
                oks.append(False)
        return picks, oks


def make_selector(method: str, *, bits: int, radius: int, seed: int = 0,
                  use_async: bool = False, deadline_ms: float = 2.0,
                  device="cuda", **index_kw):
    if method == "random":
        return RandomSelector(seed)
    if method == "exhaustive":
        return ExhaustiveSelector(device)
    # The paper doubles AH's bits (dual-bit hashing spirit).
    eff_bits = 2 * bits if method == "ah" else bits
    cfg = IndexConfig(method=method, bits=eff_bits, radius=radius, seed=seed,
                      **index_kw)
    return HashSelector(cfg, seed, use_async=use_async,
                        deadline_ms=deadline_ms, device=device)


# ---------------------------------------------------------------------------
# The AL loop
# ---------------------------------------------------------------------------

def run_active_learning(corpus: Corpus, selector, config: ALConfig,
                        device="cuda") -> ALResult:
    """The paper's AL loop with ``selector``; the SVMs, MAP and the
    exhaustive reference margins run on ``device``."""
    t_start = time.perf_counter()
    dev = resolve_device(device)
    selector.prepare(corpus)
    fit_s = getattr(getattr(selector, "index", None), "fit_s", 0.0)

    x = torch.from_numpy(corpus.x).to(dev)
    labels = torch.from_numpy(corpus.y).to(dev)
    n, d = corpus.x.shape
    c_num = corpus.num_classes
    rng = np.random.default_rng(config.seed)

    labeled = np.zeros(n, bool)
    for c in range(c_num):
        idx = np.flatnonzero(corpus.y == c)
        labeled[rng.choice(idx, min(config.init_per_class, idx.size),
                           replace=False)] = True

    def retrain(w_all, steps):
        return train_ova(w_all, x, labels, torch.from_numpy(labeled).to(dev),
                         c_num, l2=config.svm_l2, steps=steps,
                         lr=config.svm_lr)

    w_all = retrain(torch.zeros((c_num, d), dtype=torch.float32, device=dev),
                    5 * config.svm_steps)

    exhaustive = ExhaustiveSelector(dev).prepare(corpus)
    x_np = corpus.x
    classes = torch.arange(c_num, device=dev)

    eval_iters, map_curve = [], []
    min_margins, exh_margins = [], []
    nonempty = np.zeros(c_num, np.int64)
    select_s = 0.0

    def record_eval(it):
        unl = ~torch.from_numpy(labeled).to(dev)
        with strict_fp32():
            scores = (x @ w_all.T).T                          # (C, n)
        pos = (labels[None, :] == classes[:, None]) & unl[None, :]
        s = torch.where(unl[None, :], scores, -torch.inf)
        eval_iters.append(it)
        map_curve.append(float(average_precision(s, pos).mean()))

    try:
        record_eval(0)
        for it in range(1, config.iterations + 1):
            w_np = w_all.cpu().numpy()
            nw = np.maximum(np.linalg.norm(w_np, axis=1), 1e-12)
            unlabeled = ~labeled

            t0 = time.perf_counter()
            # all C hyperplane queries answered as one micro-batch
            picks, oks = selector.select_batch(w_np, unlabeled)
            nonempty += np.asarray(oks, dtype=np.int64)
            select_s += time.perf_counter() - t0

            # metrics: achieved vs optimal margin this round
            opt = exhaustive.select_all(w_all, unlabeled)
            sel_m = [abs(float(x_np[i] @ w_np[c])) / nw[c]
                     for c, i in enumerate(picks)]
            opt_m = [abs(float(x_np[i] @ w_np[c])) / nw[c]
                     for c, i in enumerate(opt)]
            min_margins.append(float(np.mean(sel_m)))
            exh_margins.append(float(np.mean(opt_m)))

            labeled[np.asarray(picks)] = True
            w_all = retrain(w_all, config.svm_steps)
            if it % config.eval_every == 0 or it == config.iterations:
                record_eval(it)
    finally:
        if hasattr(selector, "finish"):
            selector.finish()       # async selectors release their thread

    return ALResult(
        name=selector.name,
        eval_iters=np.asarray(eval_iters),
        map_curve=np.asarray(map_curve),
        min_margins=np.asarray(min_margins),
        exhaustive_margins=np.asarray(exh_margins),
        nonempty=nonempty,
        select_seconds=select_s,
        total_seconds=time.perf_counter() - t_start,
        fit_seconds=fit_s,
    )
