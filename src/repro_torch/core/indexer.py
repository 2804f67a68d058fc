"""High-level index API: the index configuration, the per-query result,
the hash family a table is built with (``make_family``), the
single-table ``HyperplaneIndex`` and the ``ActivationIndexer`` (an LM
backbone as the feature extractor).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import functions as F
from repro_torch.core import learning as L
from repro_torch.core.search import margin_rerank
from repro_torch.core.tables import SingleHashTable
from repro_torch.kernels import ops
from repro_torch.utils.bits import from_numpy_u32, to_numpy_u32
from repro_torch.utils.device import as_float_tensor, resolve_device


@dataclasses.dataclass
class IndexConfig:
    """Knobs of the multi-table index and its query service.

    The JAX package's ``use_kernels`` has no counterpart here: the device
    of the tensors chooses, so CUDA tensors launch the hand-written kernels
    and CPU tensors take their plain PyTorch versions.
    """

    method: str = "lbh"            # ah | eh | bh | lbh
    bits: int = 20                 # total bits (AH uses bit pairs; even)
    radius: int = 4                # Hamming-ball probe radius
    seed: int = 0
    rerank: bool = True            # exact-margin re-rank of candidates
    max_candidates: int = 4096
    # escalate the probe radius until at least this many candidates are in
    # hand (None = fixed radius)
    min_candidates: int | None = 64
    tables: int = 1                # number of independent hash tables L
    batch: int = 32                # micro-batch size for the query service
    # auto-compact once this fraction of rows is tombstoned (None = never)
    compact_threshold: float | None = 0.5
    # LSM delta index (serving.lsm.LSMMultiTableIndex): an immutable
    # device-resident base plus a small mutable delta, folded back
    # incrementally
    lsm_step_rows: int = 4096          # source rows folded per compaction
                                       # step (the bounded-pause unit)
    lsm_delta_threshold: float = 0.5   # begin folding once the delta
                                       # exceeds this fraction of the base…
    lsm_delta_min: int = 1024          # …and at least this many rows
    lsm_delta_fused_rows: int = 4096   # delta scans stay plain PyTorch
                                       # below this many rows; past it they
                                       # launch the scan kernel like the base
    lsm_auto: bool = True              # piggyback compaction begin/step on
                                       # insert/delete/query calls (False =
                                       # only compact()/start_compactor())
    # fused-scan selection: "hist" or "argmin"; None honours
    # REPRO_FUSED_SELECT (default hist).  Bit-identical either way.
    fused_select: str | None = None
    # method="bh": generate each table's factors from a 32-bit seed
    # (SeededBHHash), so the hash kernel reads no projection weights.
    # False (factors drawn by the JAX package) raises at fit: carry such
    # families in through repro_torch.interop.families_from_numpy.
    seeded_projections: bool = True
    # fused-scan candidate emission width: "16", "8" or "none"; None
    # honours REPRO_CAND_PACK (default 16).  Bit-identical for every width.
    cand_pack: str | None = None
    # LBH learning: sample size, Nesterov steps per bit, step size
    lbh_sample: int = 1000
    lbh_steps: int = 150
    lbh_lr: float = 0.03
    # EH dimension-sampling trick (paper §5.2); None = exact d^2 embedding
    eh_sample_dims: int | None = None
    # Online refresh (serving.refresh.RefreshManager over the LSM index):
    # re-learn the families from the accumulated live rows and swap the
    # rebuilt codes and tables in under traffic.  refresh_method is the
    # family the re-learn makes ("lbh": learned, warm-started at BH, with
    # lbh_sample / lbh_steps / lbh_lr).  refresh_ingest_rows arms the
    # service's auto policy: a background refresh starts once that many
    # rows were inserted since the last one (None = manual refresh() only).
    # refresh_traffic_sample narrows the learning pool to the rows with the
    # smallest margin to recently served query normals (False keeps the
    # seeded uniform subsample).
    refresh_method: str = "lbh"
    refresh_ingest_rows: int | None = None
    refresh_traffic_sample: bool = False


@dataclasses.dataclass
class QueryResult:
    index: int                    # argmin-margin candidate (or -1)
    margin: float
    candidates: np.ndarray        # short-list scanned
    nonempty: bool                # did the hash lookup return anything?
    lookup_s: float
    rerank_s: float


def make_family(config: IndexConfig, x: torch.Tensor, t: int = 0):
    """The hash family of table t of an index built with ``config`` over
    the rows of x (a float32 tensor on the index's device).

    Every draw derives from ``functions.table_seed(config.seed, t)``, so a
    single-table index and table 0 of a multi-table index get the same
    family: seeded BH uses it as the factors' seed; AH and EH draw from a
    CPU ``torch.Generator`` seeded with it; LBH warm-starts at the seeded
    BH factors and samples its m = min(lbh_sample, n) rows with it.
    Unseeded BH factors are drawn only by the JAX package: carry them in.
    """
    d = x.shape[1]
    seed = F.table_seed(config.seed, t)
    if config.method in ("ah", "eh"):
        gen = torch.Generator().manual_seed(seed)
        if config.method == "ah":
            return F.AHHash.create(gen, d, config.bits, x.device)
        return F.EHHash.create(gen, d, config.bits,
                               sample_dims=config.eh_sample_dims,
                               device=x.device)
    if config.method == "bh":
        if not config.seeded_projections:
            raise NotImplementedError(
                "method 'bh' with seeded_projections=False: its factors are "
                "drawn by the JAX package; pass them in (see "
                "repro_torch.interop.families_from_numpy)")
        return F.SeededBHHash.create(seed, d, config.bits, x.device)
    if config.method == "lbh":
        m = min(config.lbh_sample, x.shape[0])
        rows = L.sample_rows(x.shape[0], m, seed).to(x.device)
        u0, v0 = F.seeded_projections(seed, d, config.bits, x.device)
        return L.learn_lbh(x[rows], config.bits, u0, v0, x_all=x,
                           steps=config.lbh_steps, lr=config.lbh_lr).family
    raise ValueError(f"unknown method {config.method!r}")


class HyperplaneIndex:
    """Point-to-hyperplane search index (single table, compact codes).

    Host state: the bucket table and the packed codes; the features and the
    codes also live on the index's device for the scan and the re-rank.
    """

    def __init__(self, config: IndexConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.family = None
        self.table: SingleHashTable | None = None
        self.codes: torch.Tensor | None = None   # (n, W) int32, device
        self.x: torch.Tensor | None = None       # (n, d) float32, device
        self.fit_s = 0.0

    # -- build ---------------------------------------------------------------

    def fit(self, x, family=None) -> "HyperplaneIndex":
        """Hash every row of x and build the table.  family: optional hash
        family carried in (default: ``make_family`` from the config, which
        learns LBH for method="lbh")."""
        t0 = time.perf_counter()
        x = as_float_tensor(x, self.device)
        if family is None:
            family = make_family(self.config, x)
        self.restore(family, x, self._hash_database(family, x))
        self.fit_s = time.perf_counter() - t0
        return self

    @staticmethod
    def _hash_database(family, x: torch.Tensor) -> torch.Tensor:
        """(n, W) database codes: seeded BH through the seeded hash kernel,
        other BH / LBH families through the materialised-factor kernel
        (plain versions on the CPU), AH / EH through their own matmuls."""
        if type(family) is F.SeededBHHash:
            return ops.bilinear_hash_seeded(x, family.seed, family.k)
        if isinstance(family, F.BHHash):
            return ops.bilinear_hash(x, family.u, family.v)
        return family.hash_database(x)

    def restore(self, family, x, codes) -> "HyperplaneIndex":
        """Adopt a fitted state without hashing: the family, the (n, d)
        features and the (n, W) packed codes (uint32 array or int32 bit
        carrier)."""
        if not torch.is_tensor(codes):
            codes = from_numpy_u32(codes)
        self.family = family
        self.x = as_float_tensor(x, self.device)
        self.codes = codes.to(self.device).contiguous()
        self.table = SingleHashTable(to_numpy_u32(self.codes),
                                     self.config.bits)
        return self

    # -- query ---------------------------------------------------------------

    def query(self, w) -> QueryResult:
        """Paper query path: flip-code table lookup + exact-margin re-rank."""
        cfg = self.config
        w = as_float_tensor(w, self.device)
        t0 = time.perf_counter()
        qcode = to_numpy_u32(self.family.hash_query(w[None, :]))[0]
        cand = self.table.lookup(qcode, cfg.radius, cfg.max_candidates,
                                 cfg.min_candidates)
        t1 = time.perf_counter()
        if cand.size == 0:
            return QueryResult(-1, float("inf"), cand, False, t1 - t0, 0.0)
        if cfg.rerank:
            margins, ids = margin_rerank(
                self.x, w, torch.from_numpy(cand).to(self.device), 1)
            idx, margin = int(ids[0]), float(margins[0])
        else:
            idx, margin = int(cand[0]), float("nan")
        t2 = time.perf_counter()
        return QueryResult(idx, margin, cand, True, t1 - t0, t2 - t1)

    def query_scan(self, w, l: int = 16) -> tuple[int, float]:
        """Device-side scan path (no table): top-l by Hamming distance
        through the fused scan kernel, then exact re-rank."""
        w = as_float_tensor(w, self.device)
        qcode = self.family.hash_query(w[None, :])[0]
        _, idx = ops.hamming_topk(self.codes, qcode, l,
                                  pack=self.config.cand_pack)
        # l > n slots carry id -1 and always sit at the sorted tail: slice
        # them off before the re-rank gather (x[-1] would alias the last row)
        margins, ids = margin_rerank(self.x, w,
                                     idx[:min(l, self.codes.shape[0])], 1)
        return int(ids[0]), float(margins[0])


# ---------------------------------------------------------------------------
# Activation indexer: the paper's AL pipeline with an LM as feature extractor
# ---------------------------------------------------------------------------

class ActivationIndexer:
    """Builds a HyperplaneIndex over pooled backbone activations.

    embed_fn(batch) -> (B, d) pooled embeddings (e.g. the mean of the final
    normed hidden states), a tensor on any device.  Margin-based selection
    against a linear probe then identifies the most informative unlabelled
    items for fine-tuning (the paper's active learning, with the backbone
    as the representation).  The embeddings are concatenated as float32
    on the index's device, where the index is fitted.
    """

    def __init__(self, embed_fn, config: IndexConfig, batch_size: int = 64,
                 device="cuda"):
        self.embed_fn = embed_fn
        self.config = config
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.index: HyperplaneIndex | None = None
        self.embeddings: torch.Tensor | None = None   # (n, d) float32
        self.embed_s = 0.0

    def build(self, corpus) -> HyperplaneIndex:
        """Embed corpus (n, ...) in batches of ``batch_size`` and fit."""
        t0 = time.perf_counter()
        outs = []
        n = corpus.shape[0]
        for s in range(0, n, self.batch_size):
            out = self.embed_fn(corpus[s:s + self.batch_size])
            outs.append(as_float_tensor(out, self.device))
        self.embeddings = torch.cat(outs, dim=0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.embed_s = time.perf_counter() - t0
        self.index = HyperplaneIndex(self.config, self.device).fit(
            self.embeddings)
        return self.index
