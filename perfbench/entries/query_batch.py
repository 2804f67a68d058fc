"""The entry ``query_batch``: ``HashQueryService.query_batch`` in scan mode
over a ``MultiTableIndex`` fitted on the configuration's rows, fed
micro-batches of the mix's hyperplanes by ``loops.BatchLoop``.

``Entry`` sets the program up (its constructor, warm-up included), runs
phases (``phase``), reports its end-to-end numbers (``end_to_end``) and
the context its per-layer readers read (``context``), frees the program
(``release``), and then holds its answers to the plain reference
(``check``).  The program is reached only through the public calls of
``repro_torch``.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from perfbench import check as chk
from perfbench import costs, data
from perfbench.loops import BatchLoop
from perfbench.reference.generator import M32, table_seed
from perfbench.reference.hyperplane import HyperplaneReference


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Entry:
    """``HashQueryService.query_batch`` over a fitted ``MultiTableIndex``.
    The pool of normals waits in pinned host memory, as a client's next
    micro-batches would."""

    def __init__(self, cfg: dict, mix: dict, cell: dict, seed: int, device):
        from repro_torch.core.indexer import IndexConfig
        from repro_torch.serving.multi_table import MultiTableIndex
        from repro_torch.serving.service import HashQueryService
        self.cfg, self.mix, self.cell = cfg, mix, cell
        self.seed, self.device = seed, device
        b, p = int(mix["batch"]), int(mix["pool_batches"])
        x, y = data.make(cfg, seed, device)
        self.x = x
        self.index_seed = int(seed) & M32
        index = MultiTableIndex(IndexConfig(seed=self.index_seed, batch=b,
                                            **cfg["index"]),
                                device=device).fit(x)
        self.service = HashQueryService(index, mode="scan",
                                        scan_l=int(mix["scan_l"]),
                                        max_batch=b)
        self.w = data.normals(x, y, p * b, seed, float(mix["normal_noise"]))
        del y
        self.pool = torch.empty((p, b, x.shape[1]), dtype=torch.float32,
                                pin_memory=device.type == "cuda")
        self.pool.copy_(self.w.view(p, b, -1))
        pool = self.pool.numpy()
        self.loop = BatchLoop(self.service, pool,
                              int(cell["check"]["sample_batches"]), seed)
        for i in range(int(mix["warm_batches"])):
            self.service.query_batch(pool[i % p])
        if device.type == "cuda":
            torch.cuda.synchronize()
        self.phases: dict = {}

    def phase(self, name: str, seconds: float) -> dict:
        out = self.loop.run_phase(seconds)
        self.phases[name] = out
        return out

    def end_to_end(self) -> dict:
        w = self.phases["window"]
        return {"qps": w["queries"] / w["wall_s"]}

    def context(self) -> dict:
        k = int(self.cfg["index"]["bits"])
        return {"phases": self.phases,
                "shape": {"n": self.x.shape[0], "d": self.x.shape[1],
                          "k": k, "w": costs.n_words(k),
                          "g": int(self.cfg["index"]["tables"]),
                          "b": int(self.mix["batch"]),
                          "l": int(self.mix["scan_l"])}}

    def counts(self, numbers: dict) -> tuple[int, int]:
        """(queries sent over the run's phases, those unanswered)."""
        sent = sum(ph["sent"] for ph in self.phases.values())
        return sent, int(numbers["unanswered"])

    def release(self) -> None:
        """Free the program's state: the index and its service."""
        self.loop.service = None
        self.service = None
        _free(self.device)

    def check(self) -> dict:
        loop, b = self.loop, int(self.mix["batch"])
        g = int(self.cfg["index"]["tables"])
        seeds = [table_seed(self.index_seed, t) for t in range(g)]
        ref = HyperplaneReference(self.x, seeds,
                                  int(self.cfg["index"]["bits"]))
        ids = np.concatenate(loop.ids) if loop.ids else np.empty(0, np.int64)
        margins = (np.concatenate(loop.margins) if loop.margins
                   else np.empty(0))
        qidx = (np.repeat(np.asarray(loop.pool_idx, np.int64) * b, b)
                + np.tile(np.arange(b), len(loop.pool_idx)))
        ok = (ids >= 0) & (ids < self.x.shape[0])
        dev = self.device
        answers = (self.w[torch.from_numpy(qidx[ok]).to(dev)],
                   torch.from_numpy(ids[ok]).to(dev), margins[ok])
        sample = loop.sample.items
        sq = np.concatenate([p * b + np.arange(b) for p, _, _ in sample]
                            ) if sample else np.empty(0, np.int64)
        s_ids = (np.concatenate([a for _, a, _ in sample]) if sample
                 else np.empty(0, np.int64))
        unions = [u for _, _, us in sample for u in us]
        numbers = {"unanswered": int((~ok).sum()) + loop.errors}
        numbers.update(chk.judge(
            ref, int(self.mix["scan_l"]), answers,
            (self.w[torch.from_numpy(sq).to(dev)],
             torch.from_numpy(s_ids).to(dev), unions)))
        return numbers
