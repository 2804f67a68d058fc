"""The benchmark's frozen yardstick: the least time an H100 could take for
the work of one query micro-batch, stage by stage.

Copies, frozen here, of ``repro_torch.kernels.ops.hash_bound`` and
``scan_bound`` and of the data-sheet rates in ``repro_torch.utils.h100``
(NVIDIA H100 80GB HBM3, SXM5, 700 W), so that a change to the program
cannot move the bound it is measured against.
``perfbench/tests/test_perfbench_costs.py`` holds the copies equal to the
program's at the cells' shapes.  The merge's and the re-rank's bounds
are new here: the candidates each must read, once.

Every bound is a ``Bound``: the larger of bytes over the HBM rate and
operations over their peak rate, computed from the call's shapes alone.
"""
from __future__ import annotations

from typing import NamedTuple

FP32_FLOP_S = 67e12        # float32 outside the tensor cores
HBM_BYTES_S = 3.35e12
POPC_PER_CLK_SM = 16       # popcounts a clock per SM (compute capability 9.0)
SMS = 132
MAX_SM_CLOCK_HZ = 1.98e9
WORD = 32
SUBLANE = 8
DIST_SENTINEL = 0x3FFFFFFF
# candidate emission of the fused scan per pack: (distance bytes, id bytes,
# distance sentinel); ids stay 16-bit for the block-local row range
CAND_PACKS = {"none": (4, 4, DIST_SENTINEL), "16": (2, 2, 0x7FFF),
              "8": (1, 2, 0xFF)}
CAND_ID_MAX = 0x7FFF


def popc_s(sms: int = SMS, clock_hz: float = MAX_SM_CLOCK_HZ) -> float:
    """Popcounts a second over sms SMs at clock_hz."""
    return POPC_PER_CLK_SM * sms * clock_hz


def n_words(k: int) -> int:
    return (k + WORD - 1) // WORD


def block_rows(n: int, block_n: int = 4096) -> int:
    """Row-block size of an n-row scan: at most block_n, at least
    min(n, 256), rounded up to a multiple of 8."""
    bn = min(block_n, max(256, n))
    return -(-bn // SUBLANE) * SUBLANE


class Bound(NamedTuple):
    seconds: float
    by: str              # "bytes" or "operations": the larger term
    bytes: int
    operations: int

    @property
    def ms(self) -> float:
        return 1e3 * self.seconds


def _bound(nbytes: int, ops: int, ops_per_s: float) -> Bound:
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / ops_per_s
    return Bound(max(t_bytes, t_ops),
                 "operations" if t_ops > t_bytes else "bytes", nbytes, ops)


def hash_bound(n: int, d: int, k: int, *, g: int = 1,
               seeded: bool) -> Bound:
    """n points of d features hashed into g tables of k bits.  Bytes: x
    once (n d 4), the codes (g n W 4), and the factors (g 2 d k 4) or,
    seeded, the seeds (g 4).  Operations: the two projections and their
    product, 4 n d k g, at the float32 rate."""
    factors = g * 4 if seeded else g * 2 * d * k * 4
    nbytes = n * d * 4 + g * n * n_words(k) * 4 + factors
    return _bound(nbytes, 4 * n * d * k * g, FP32_FLOP_S)


def cand_pair_bytes(pack: str, w: int, rows: int) -> int:
    """Bytes of one emitted (distance, id) candidate of the fused scan;
    raises where the pack cannot carry the distances or the ids."""
    if pack not in CAND_PACKS:
        raise ValueError(f"cand pack must be one of {sorted(CAND_PACKS)}, "
                         f"got {pack!r}")
    d_bytes, i_bytes, sent = CAND_PACKS[pack]
    if pack != "none" and (32 * w >= sent or rows - 1 > CAND_ID_MAX):
        raise ValueError(f"cand pack {pack!r} cannot carry W = {w}, "
                         f"block of {rows} rows")
    return d_bytes + i_bytes


def scan_bound(n: int, w: int, b: int, l: int, *, g: int = 1,
               live_rows: int | None = None, active: bool = False,
               block_n: int = 4096, pack: str = "16", sms: int = SMS,
               clock_hz: float = MAX_SM_CLOCK_HZ) -> Bound:
    """The block-local smallest-l scan of g groups of n codes of W words
    against B queries each.  Bytes: codes and queries once
    (g (n + B) W 4), the int32 active mask (n 4) when there is one, and the
    candidates the pack writes (g grid B min(l, block) pairs).
    Operations: one popcount per live row, query and word (g live B W;
    live_rows defaults to n)."""
    rb = block_rows(n, block_n)
    cand = g * -(-n // rb) * b * min(l, rb) * cand_pair_bytes(pack, w, rb)
    nbytes = g * (n + b) * w * 4 + (n * 4 if active else 0) + cand
    live = n if live_rows is None else live_rows
    return _bound(nbytes, g * live * b * w, popc_s(sms, clock_hz))


def merge_bound(n: int, w: int, b: int, l: int, *, g: int = 1,
                block_n: int = 4096, pack: str = "16") -> Bound:
    """The scan's second stage (``kernels/ops.hamming_topk_grouped``'s
    merge): each (group, query)'s block-local candidates merged into its
    l smallest (distance, id).  Bytes: the candidates the scan wrote
    (``scan_bound``'s candidate term), read once, and the l (distance,
    id) int32 pairs out.  No operation is counted: the compares of a
    selection are far below any peak rate."""
    rb = block_rows(n, block_n)
    grid = -(-n // rb)
    l_k = min(l, rb)
    nbytes = (g * grid * b * l_k * cand_pair_bytes(pack, w, rb)
              + g * b * min(l, grid * l_k) * 8)
    return _bound(nbytes, 0, FP32_FLOP_S)


def rerank_bound(candidates: int, d: int) -> Bound:
    """The exact re-rank of a micro-batch: every candidate row of d float32
    features read once (``candidates`` is the sum over the batch's queries
    of their unique candidates); the multiply-adds are far below the
    float32 rate's share, so bytes bound it."""
    return _bound(candidates * d * 4, 2 * candidates * d, FP32_FLOP_S)
