"""Index configuration and the per-query result record.

``HyperplaneIndex`` (the single-table index) comes with the slice that
ports ``bilinear_hash_kernel``; this module holds what the multi-table
serving path needs.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class IndexConfig:
    """Knobs of the multi-table index and its query service.

    The JAX package's ``use_kernels`` has no counterpart here: the device
    of the tensors chooses, so CUDA tensors launch the hand-written kernels
    and CPU tensors take their plain PyTorch versions.  ``rerank`` and the
    LSM, refresh, LBH-learning and EH knobs come with the slices that port
    their readers (``HyperplaneIndex``, the LSM index, refresh, learning).
    """

    method: str = "lbh"            # bh | lbh (lbh families are carried in)
    bits: int = 20                 # bits per table code
    radius: int = 4                # Hamming-ball probe radius
    seed: int = 0
    max_candidates: int = 4096
    # escalate the probe radius until at least this many candidates are in
    # hand (None = fixed radius)
    min_candidates: int | None = 64
    tables: int = 1                # number of independent hash tables L
    batch: int = 32                # micro-batch size for the query service
    # auto-compact once this fraction of rows is tombstoned (None = never)
    compact_threshold: float | None = 0.5
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


@dataclasses.dataclass
class QueryResult:
    index: int                    # argmin-margin candidate (or -1)
    margin: float
    candidates: np.ndarray        # short-list scanned
    nonempty: bool                # did the hash lookup return anything?
    lookup_s: float
    rerank_s: float
