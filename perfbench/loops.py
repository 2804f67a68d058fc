"""The loop runner: how a traffic mix's requests reach the program.

``BatchLoop``: one client sends micro-batches of hyperplanes to
``HashQueryService.query_batch`` back to back, each as soon as the last
is answered (a closed loop: the offered load is always more than the
service can take, so what it completes a second is the measure).

It runs in phases (``run_phase``): the measured window, a traced
segment.  A phase keeps what the check and the metrics need: every
answer's id and margin, latencies, and a seeded sample of whole answers.
"""
from __future__ import annotations

import time
import traceback

import numpy as np


class Reservoir:
    """A uniform sample of ``size`` items from a stream, drawn from the
    seed (Algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size = int(size)
        self.items: list = []
        self.seen = 0
        self._rng = np.random.default_rng(seed)

    def offer(self, make) -> None:
        """Count one more item; ``make()`` builds it only when kept."""
        if self.seen < self.size:
            self.items.append(make())
        else:
            j = int(self._rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = make()
        self.seen += 1


class BatchLoop:
    """The closed micro-batch loop over a pool of (P, B, d) normals."""

    def __init__(self, service, pool: np.ndarray, sample_batches: int,
                 seed: int):
        self.service = service
        self.pool = pool
        self.i = 0                      # micro-batches sent, all phases
        self.sample = Reservoir(sample_batches, seed)
        self.pool_idx: list[int] = []   # per answered micro-batch
        self.ids: list[np.ndarray] = []
        self.margins: list[np.ndarray] = []
        self.errors = 0

    def _one(self):
        p = self.i % self.pool.shape[0]
        self.i += 1
        t0 = time.perf_counter()
        try:
            res = self.service.query_batch(self.pool[p])
        except Exception:   # a failed batch: its queries are unanswered
            if not self.errors:
                traceback.print_exc()
            self.errors += self.pool.shape[1]
            return p, None, time.perf_counter() - t0
        return p, res, time.perf_counter() - t0

    def run_phase(self, seconds: float) -> dict:
        """Send micro-batches until ``seconds`` have passed, then let the
        last finish.  Returns the phase's wall seconds (to the last
        answer), its micro-batch latencies, the queries sent and answered
        and the sum of their candidate counts."""
        b = self.pool.shape[1]
        lat, cands, queries = [], 0, 0
        t_start = time.perf_counter()
        t_end = t_start + seconds
        while time.perf_counter() < t_end:
            p, res, dt = self._one()
            lat.append(dt)
            if res is None:
                continue
            queries += b
            cands += sum(r.candidates.size for r in res)
            ids = np.fromiter((r.index for r in res), np.int64, b)
            self.pool_idx.append(p)
            self.ids.append(ids)
            self.margins.append(np.fromiter((r.margin for r in res),
                                            np.float64, b))
            self.sample.offer(lambda p=p, ids=ids, res=res: (
                p, ids, [r.candidates for r in res]))
        return {"wall_s": time.perf_counter() - t_start,
                "latencies_s": np.asarray(lat), "queries": queries,
                "sent": len(lat) * b, "batches": len(lat),
                "candidates": cands}
