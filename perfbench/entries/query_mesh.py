"""The entry ``query_mesh``: ``HashQueryService.query_batch`` in scan mode
over a ``MultiTableIndex`` whose feature rows are sharded over a mesh of
the cell's devices (``MultiTableIndex.fit_sharded``), fed micro-batches of
the mix's hyperplanes by ``loops.BatchLoop``.

Each shard's rows are drawn on its own device from the seed
(``data_mesh``), the index fit from those same tensors, and the answers
held to the plain reference over the same shards
(``reference.hyperplane_mesh``, ``check_mesh``): no device and no host
holds the whole pool.  A program without the sharded-feature fit fails
the run at once, before any data is drawn.  ``Entry`` has the interface of
``entries/query_batch.Entry``.
"""
from __future__ import annotations

import gc
import resource
import sys
import time

import numpy as np
import torch

from perfbench import check_mesh, costs, data_mesh
from perfbench.loops import BatchLoop
from perfbench.reference.generator import M32, table_seed
from perfbench.reference.hyperplane_mesh import MeshHyperplaneReference


def _log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def _devices(shards: int, device) -> list:
    """The mesh's devices: the first ``shards`` cards, or ``shards``
    co-located shards on a CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(shards)]
    return [device] * shards


def memory_report(devices) -> dict:
    """Each card's peak allocated bytes and the process's peak host RSS."""
    out = {"host_peak_rss_bytes": resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024}
    if devices[0].type == "cuda":
        out["card_peak_bytes"] = [int(torch.cuda.max_memory_allocated(d))
                                  for d in sorted(set(devices), key=str)]
    return out


class Entry:
    """``HashQueryService.query_batch`` over an index fit from row
    shards.  The pool of normals waits in pinned host memory."""

    def __init__(self, cfg: dict, mix: dict, cell: dict, seed: int, device):
        from perfbench.harness import RunError
        from repro_torch.serving.multi_table import MultiTableIndex
        if not hasattr(MultiTableIndex, "fit_sharded"):
            raise RunError("the program offers no sharded-feature fit "
                           "(MultiTableIndex.fit_sharded)")
        from repro_torch.core.indexer import IndexConfig
        from repro_torch.serving.service import HashQueryService
        from repro_torch.utils.mesh import make_mesh
        self.cfg, self.mix, self.cell = cfg, mix, cell
        self.seed, self.device = seed, device
        shards = int(cfg["mesh"]["shards"])
        self.devices = _devices(shards, device)
        if device.type == "cuda":
            for dev in self.devices[1:]:
                torch.cuda.reset_peak_memory_stats(dev)
        b, p = int(mix["batch"]), int(mix["pool_batches"])
        spec = dict(cfg["data"])
        if spec.pop("generator") != "tiny1m":
            raise RunError("query_mesh draws the tiny1m geometry only")
        self.parts, labels, self.n = data_mesh.tiny1m_shards(
            seed, self.devices, **spec)
        self.index_seed = int(seed) & M32
        mesh = make_mesh(shards, cfg["mesh"]["axis"], self.devices)
        index = MultiTableIndex(IndexConfig(seed=self.index_seed, batch=b,
                                            **cfg["index"]),
                                device=self.devices[0]).fit_sharded(
            self.parts, mesh, n=self.n, axis=cfg["mesh"]["axis"])
        self.service = HashQueryService(index, mode="scan",
                                        scan_l=int(mix["scan_l"]),
                                        max_batch=b, mesh=mesh)
        self.w = data_mesh.normals_sharded(
            self.parts, labels, self.n, int(spec["classes"]), p * b, seed,
            float(mix["normal_noise"]), self.devices[0])
        del labels
        self.pool = torch.empty((p, b, self.w.shape[1]), dtype=torch.float32,
                                pin_memory=device.type == "cuda")
        self.pool.copy_(self.w.view(p, b, -1))
        pool = self.pool.numpy()
        self.loop = BatchLoop(self.service, pool,
                              int(cell["check"]["sample_batches"]), seed)
        for i in range(int(mix["warm_batches"])):
            self.service.query_batch(pool[i % p])
        if device.type == "cuda":
            for dev in self.devices:
                torch.cuda.synchronize(dev)
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
                "shape": {"n": self.n, "d": self.parts[0].shape[1],
                          "k": k, "w": costs.n_words(k),
                          "g": int(self.cfg["index"]["tables"]),
                          "b": int(self.mix["batch"]),
                          "l": int(self.mix["scan_l"]),
                          "shards": len(self.parts),
                          "shard_rows": self.parts[0].shape[0]}}

    def counts(self, numbers: dict) -> tuple[int, int]:
        """(queries sent over the run's phases, those unanswered)."""
        sent = sum(ph["sent"] for ph in self.phases.values())
        return sent, int(numbers["unanswered"])

    def release(self) -> None:
        """Free the program's state: the index and its service (the rows
        stay: the check reads them)."""
        _log(f"memory {memory_report(self.devices)}")
        self.loop.service = None
        self.service = None
        gc.collect()
        if self.device.type == "cuda":
            for dev in self.devices:
                torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()

    def check(self) -> dict:
        loop, b = self.loop, int(self.mix["batch"])
        g = int(self.cfg["index"]["tables"])
        seeds = [table_seed(self.index_seed, t) for t in range(g)]
        t = time.perf_counter()
        ref = MeshHyperplaneReference(self.parts, self.n, seeds,
                                      int(self.cfg["index"]["bits"]))
        _log(f"check: reference codes {time.perf_counter() - t:.3f} s")
        ids = np.concatenate(loop.ids) if loop.ids else np.empty(0, np.int64)
        margins = (np.concatenate(loop.margins) if loop.margins
                   else np.empty(0))
        qidx = (np.repeat(np.asarray(loop.pool_idx, np.int64) * b, b)
                + np.tile(np.arange(b), len(loop.pool_idx)))
        ok = (ids >= 0) & (ids < self.n)
        dev = self.devices[0]
        sample = loop.sample.items
        sq = np.concatenate([p * b + np.arange(b) for p, _, _ in sample]
                            ) if sample else np.empty(0, np.int64)
        s_ids = (np.concatenate([a for _, a, _ in sample]) if sample
                 else np.empty(0, np.int64))
        unions = [u for _, _, us in sample for u in us]
        numbers = {"unanswered": int((~ok).sum()) + loop.errors}
        numbers.update(check_mesh.judge(
            ref, int(self.mix["scan_l"]),
            (self.w[torch.from_numpy(qidx[ok]).to(dev)], ids[ok],
             margins[ok]),
            (self.w[torch.from_numpy(sq).to(dev)], s_ids, unions)))
        return numbers
