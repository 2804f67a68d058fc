"""Public wrappers around the kernels: input normalisation, block geometry
and the second-stage merge.  The device of the tensors picks the route:
CUDA tensors launch the hand-written kernels, CPU tensors take their plain
versions; the merge is the same PyTorch code on both.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.functions import strict_fp32
from repro_torch.core.search import (DIST_SENTINEL, _pad_topk,
                                     env_cand_pack, env_fused_select,
                                     lex_smallest)
from repro_torch.kernels import _build
from repro_torch.kernels import bilinear_hash as _bh
from repro_torch.kernels import candidates as _cl
from repro_torch.kernels import hamming as _hm
from repro_torch.kernels import lbh_grad as _lbh
from repro_torch.kernels import margins as _mg
from repro_torch.kernels import shard_select as _ss
from repro_torch.kernels.bilinear_hash import \
    bilinear_hash_seeded as _bilinear_hash_seeded
from repro_torch.kernels.hamming import (cand_encoding, hamming_distance,
                                         hamming_distance_batch,
                                         hamming_topk_fused,
                                         hamming_topk_hist,
                                         hamming_topk_hist_dma)
from repro_torch.utils import h100
from repro_torch.utils.bits import WORD, n_words

SUBLANE = 8   # row-block sizes are multiples of 8, as in the JAX package


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _block_rows(n: int, block_n: int) -> int:
    """Row-block size for an n-row scan: at most block_n, at least
    min(n, 256), rounded up to a multiple of 8 (the JAX package's
    geometry, so block-local outputs line up with its kernel's)."""
    bn = min(block_n, max(256, n))
    return -(-bn // SUBLANE) * SUBLANE


# -- the reference kernels' cost models ---------------------------------------
#
# Integer counts of the JAX package's kernel designs, the same numbers as
# its kernels/ops.py gives: HBM bytes of a launch (block-local candidate
# pairs written and read back, the point stream once per table) and the
# element-ops of the fused scan's selection.  They count a design's
# traffic, not a time; the H100 bounds below count the least work.

# bytes of one emitted (distance, id) candidate pair per pack width:
# int32 + int32, int16 + int16, uint8 + int16 (the ids stay 16-bit for the
# block-local row range; only the distance narrows further)
CAND_PAIR_BYTES = {"none": 8, "16": 4, "8": 3}


def scan_cand_model(n: int, b: int, l: int, block_n: int = 4096,
                    g: int = 1, pack: str = "16") -> int:
    """HBM bytes of the fused scan's candidate emission alone: the
    (g, grid, B, l) block-local (distance, id) pairs, written once by the
    kernel and read back once by the merge.  Packing shrinks this term
    (2x for int16 pairs, 8/3x for uint8 distances); at B = 32, l = 128
    it rivals the code stream itself."""
    bn = _block_rows(n, block_n)
    grid = -(-n // bn)
    return 2 * g * grid * b * min(l, bn) * CAND_PAIR_BYTES[pack]


def scan_traffic_model(n: int, w: int, b: int, l: int = 16,
                       block_n: int = 4096, fused: bool = True,
                       g: int = 1, pack: str = "16") -> int:
    """HBM bytes of one batched Hamming scan launch over g stacked code
    groups: the codes streamed once (g n W 4) and the queries read
    (g B W 4), then, unfused, the full g (n, B) int32 distance matrices
    written and read back for the top-l (2 g n B 4) or, fused, the
    block-local candidate pairs (``scan_cand_model``; ``pack`` picks the
    pair width).  Every term scales with g.  The selection (hist or
    argmin) does not change the traffic: both emit the same pairs;
    ``scan_select_model`` counts the term that differs."""
    code_bytes = g * (n * w * 4 + b * w * 4)
    if not fused:
        return code_bytes + 2 * g * n * b * 4
    return code_bytes + scan_cand_model(n, b, l, block_n, g, pack)


def hash_traffic_model(n: int, d: int, k: int, g: int = 1,
                       seeded: bool = False) -> int:
    """HBM bytes of hashing n points into g tables of k bits, per table:
    the points streamed (n d 4), the materialised (d, k) U, V factors
    (2 d k 4), or nothing when ``seeded`` (the kernel regenerates them
    from the table's 32-bit seed), and the packed codes written (n W 4).
    The point stream counts once per table, as the grouped kernel reads
    x again for each group."""
    w = n_words(k)
    weights = 0 if seeded else 2 * d * k * 4
    return g * (n * d * 4 + weights + n * w * 4)


def scan_select_model(n: int, b: int, l: int = 16, k: int = 128,
                      block_n: int = 4096, select: str = "hist",
                      g: int = 1) -> int:
    """Element-ops the fused scan spends on selection in one launch (the
    popcounts, the same for both, are left out).

    - ``argmin``: l rounds of masked argmin over each (block_n, B) tile,
      about 3 tile passes a round: 3 l block_n B a block, linear in l.
    - ``hist``: the distance-CDF bisection, ceil(log2(32 W + 1)) tile
      passes, plus 5 fixed passes, and an emission bisection over the
      slot cumsum, 2 ceil(log2(block_n)) l B: flat in l in the tile term.

    The two cross near l = 4; from l = 8 up the histogram is cheaper."""
    bn = _block_rows(n, block_n)
    grid = -(-n // bn)
    l_k = min(l, bn)
    w = n_words(k)
    if select == "argmin":
        per_block = 3 * l_k * bn * b
    else:
        cdf_steps = max(1, (32 * w).bit_length())
        emit_steps = max(1, (bn - 1).bit_length())
        per_block = (cdf_steps + 5) * bn * b + 2 * emit_steps * l_k * b
    return g * grid * per_block


# -- the H100 bound of each kernel family -------------------------------------
#
# The least time the card could take for a kernel's work: the larger of
# the bytes it must move (each input read once, each output written once)
# over the HBM rate and its operations over their peak rate
# (``utils/h100.py``'s data-sheet constants; popcounts at ``h100.popc_s``
# of the SMs and clock given).


class Bound(NamedTuple):
    seconds: float
    by: str              # "bytes" or "operations": the larger term
    bytes: int
    operations: int

    @property
    def ms(self) -> float:
        return 1e3 * self.seconds


def _bound(nbytes: int, ops: int, ops_per_s: float) -> Bound:
    t_bytes = nbytes / h100.HBM_BYTES_S
    t_ops = ops / ops_per_s
    return Bound(max(t_bytes, t_ops),
                 "operations" if t_ops > t_bytes else "bytes", nbytes, ops)


def hash_bound(n: int, d: int, k: int, *, g: int = 1,
               seeded: bool) -> Bound:
    """Kernels 1 (``seeded``) and 4: n points of d features into g tables
    of k bits.  Bytes: x once (n d 4), the codes (g n W 4), and the
    factors (g 2 d k 4) or, seeded, the seeds (g 4).  Operations: the two
    projections and their product, 4 n d k g, at the float32 rate.  x is
    read once here and once per table in ``hash_traffic_model``: the
    bound is the least work, the model the reference kernel's design."""
    factors = g * 4 if seeded else g * 2 * d * k * 4
    nbytes = n * d * 4 + g * n * n_words(k) * 4 + factors
    return _bound(nbytes, 4 * n * d * k * g, h100.FP32_FLOP_S)


def scan_bound(n: int, w: int, b: int, l: int, *, g: int = 1,
               live_rows: int | None = None, active: bool = False,
               block_n: int = 4096, pack: str = "16",
               sms: int = h100.SMS,
               clock_hz: float = h100.MAX_SM_CLOCK_HZ) -> Bound:
    """Kernels 2, 3 and 5: the block-local smallest-l scan of g groups of
    n codes of W words against B queries each.  Bytes: codes and queries
    once (g (n + B) W 4), the int32 active mask (n 4) when there is one,
    and the candidates ``cand_encoding`` writes for ``pack`` (g grid B
    min(l, block) pairs).  Operations: one popcount per live row, query
    and word (g live B W; live_rows defaults to n)."""
    rb = _block_rows(n, block_n)
    d_dtype, i_dtype, _ = cand_encoding(pack, w, rb)
    pair = sum(torch.empty((), dtype=t).element_size()
               for t in (d_dtype, i_dtype))
    cand = g * -(-n // rb) * b * min(l, rb) * pair
    nbytes = g * (n + b) * w * 4 + (n * 4 if active else 0) + cand
    live = n if live_rows is None else live_rows
    return _bound(nbytes, g * live * b * w, h100.popc_s(sms, clock_hz))


def distance_bound(n: int, w: int, b: int, *, sms: int = h100.SMS,
                   clock_hz: float = h100.MAX_SM_CLOCK_HZ) -> Bound:
    """Kernels 6 (B queries) and 7 (B = 1): the (B, n) int32 distances of
    n codes of W words.  Bytes: codes, queries and distances once
    ((n W + B W + B n) 4).  Operations: n B W popcounts."""
    return _bound((n * w + b * w + b * n) * 4, n * b * w,
                  h100.popc_s(sms, clock_hz))


def lbh_chain_bound(m: int) -> Bound:
    """Kernel 8: one LBH chain over an m-point sample (the time bound,
    not ``kernels.ref.lbh_chain_bound``, the rounding bound of its
    elements).  Bytes: R (m, m) and p, q in, s q, s p out ((m^2 + 4 m)
    4).  Operations: 2 m^2 + 6 m at the float32 rate."""
    return _bound((m * m + 4 * m) * 4, 2 * m * m + 6 * m,
                  h100.FP32_FLOP_S)


def candidate_lists_bound(b: int, c: int, kept: int) -> Bound:
    """Kernel 9: B queries' candidate lists from C union slots each, kept
    of them unique and live in all.  Bytes: the int32 slots and bool
    valid flags once (B C 5), the kept rows' int64 ids once (kept 8), the
    (B, C + 2) int64 lists once.  No arithmetic worth a rate: the bound
    is bytes."""
    return _bound(b * c * 5 + kept * 8 + b * (c + 2) * 8, 0,
                  h100.FP32_FLOP_S)


def shard_select_bound(n: int, w: int, b: int, selected: int, *,
                       g: int = 1, sms: int = h100.SMS,
                       clock_hz: float = h100.MAX_SM_CLOCK_HZ) -> Bound:
    """One shard's histogram and select (``kernels.shard_select``): n
    valid rows of g groups of W-word codes against B queries each, of
    which ``selected`` rows (over every group and query) are its share of
    the top-l.  Bytes: codes and queries once (g (n + B) W 4), the
    selected rows' int32 written once (selected 4).  Operations: one
    popcount per row, query and word (g n B W).  The histograms crossing
    between the passes are a few KB and are left out."""
    return _bound(g * (n + b) * w * 4 + selected * 4, g * n * b * w,
                  h100.popc_s(sms, clock_hz))


def row_margins_bound(candidates: int, d: int) -> Bound:
    """Kernel 11: the margins of ``candidates`` valid candidate rows of d
    float32 features, each row read once (candidates d 4 bytes); 2 d
    multiply-adds a row at the float32 rate, far below it, so bytes bound
    it.  The slots' ids, flags and margins (13 bytes a slot) are left
    out, as the benchmark's ``rerank_bound`` leaves them."""
    return _bound(candidates * d * 4, 2 * candidates * d, h100.FP32_FLOP_S)


def load_libraries() -> None:
    """Build every kernel library not built yet (one nvcc per source, all
    started together) and load it, so that no first use falls inside a
    caller's deadline.  Raises as a failed build does."""
    libs = {_bh.LIBRARY: _bh._SIGNATURES,
            _bh.FACTORS_LIBRARY: _bh._FACTORS_SIGNATURES,
            _lbh.LIBRARY: _lbh._SIGNATURES, _cl.LIBRARY: _cl._SIGNATURES,
            _ss.LIBRARY: _ss._SIGNATURES, _mg.LIBRARY: _mg._SIGNATURES,
            **_hm._SIGNATURES}
    _build.build(list(libs))
    for name, signatures in libs.items():
        _build.load(name, signatures)


def bilinear_hash(x, u, v) -> torch.Tensor:
    """Packed BH/LBH codes from materialised factors.

    x: (n, d); u, v: (d, k).  Returns (n, ceil(k/32)) int32 carrying
    uint32 bits, pad bits past k set to 0: the JAX wrapper's output
    without its block padding (the kernel takes any n, d, k).
    """
    return _bh.bilinear_hash(_f32(x), _f32(u), _f32(v))


def bilinear_hash_seeded_grouped(x, seeds, k: int) -> torch.Tensor:
    """Packed seed-generated BH codes for G tables in one launch.

    x: (n, d) shared by all tables; seeds: G uint32 seeds (python ints or a
    1-D tensor).  Returns (G, n, ceil(k/32)) int32 carrying uint32 bits;
    the bits past k are 0 (the kernel masks them, the plain version packs
    only k signs).
    """
    if torch.is_tensor(seeds):
        seeds = seeds.tolist()
    return _bilinear_hash_seeded(_f32(x), [int(s) for s in seeds], k)


def bilinear_hash_seeded(x, seed, k: int) -> torch.Tensor:
    """Single-table seed-generated hash: (n, ceil(k/32)) int32 codes
    carrying uint32 bits, group 0 of ``bilinear_hash_seeded_grouped`` with
    the one seed."""
    return bilinear_hash_seeded_grouped(x, [int(seed)], k)[0]


def hamming_distances(codes, query, *, block_n: int = 2048):
    """(n,) int32 Hamming distances between packed code rows codes (n, W)
    int32 and one packed query (W,).  Any n: the kernel masks the tail, so
    nothing is padded; block_n is the JAX signature's and changes nothing
    here (the kernel's blocks are 256 rows)."""
    return hamming_distance(codes.contiguous(), query.contiguous())


def hamming_distances_batch(codes, queries, *, block_n: int = 2048):
    """(B, n) int32 Hamming distances between one code table codes (n, W)
    int32 and B packed queries (B, W), row b for query b; the kernel writes
    this layout itself.  block_n as in ``hamming_distances``."""
    return hamming_distance_batch(codes.contiguous(), queries.contiguous())


def hamming_topk_grouped(codes, queries, l: int, *, block_n: int = 4096,
                         select: str | None = None, dma: bool = False,
                         active=None, pack: str | None = None):
    """Fused smallest-l scan over G stacked code groups, one kernel launch.

    codes: (G, n, W) int32 — G sub-tables over the same row space;
    queries: (G, B, W) int32 — group g's queries meet group g's codes only.
    Returns (dists (G, B, l), ids (G, B, l)) int32 sorted ascending by
    (distance, id), ties to the lowest id; slots with no live row carry
    (DIST_SENTINEL, -1).  active: optional (n,) bool liveness shared by all
    groups.  pack: the kernel's candidate emission width (``"16"``,
    ``"8"``, ``"none"``; None reads REPRO_CAND_PACK); every pack is
    bit-identical after the merge.  select: ``"hist"`` (histogram select,
    ``hamming_topk_hist``) or ``"argmin"`` (the JAX package's l rounds of
    masked argmin, here the same select emitted in distance order,
    ``hamming_topk_fused``); None reads REPRO_FUSED_SELECT.  dma=True routes
    the hist select through the pipelined kernel
    (``hamming_topk_hist_dma``); argmin ignores it, as in the JAX package.
    All are bit-identical after the merge.  The two stages, the scan and
    the merge, are ``hamming_scan_blocks`` and ``merge_scan_blocks``.
    """
    return merge_scan_blocks(
        hamming_scan_blocks(codes, queries, l, block_n=block_n,
                            select=select, dma=dma, active=active,
                            pack=pack), l)


class ScanBlocks(NamedTuple):
    """The scan kernel's per-block candidates, before the merge: dists and
    ids (G, grid, B, l_k) in the kernel's packed emission, the rows a
    block holds, and the pack's distance sentinel."""
    dists: torch.Tensor
    ids: torch.Tensor
    block_rows: int
    sentinel: int


def hamming_scan_blocks(codes, queries, l: int, *, block_n: int = 4096,
                        select: str | None = None, dma: bool = False,
                        active=None, pack: str | None = None) -> ScanBlocks:
    """The first stage of ``hamming_topk_grouped`` (same arguments): the
    one scan launch, each block's smallest min(l, its rows)."""
    if env_fused_select(select) == "argmin":
        scan = hamming_topk_fused
    else:
        scan = hamming_topk_hist_dma if dma else hamming_topk_hist
    pack = env_cand_pack(pack)
    n, w = codes.shape[1:]
    bn = _block_rows(n, block_n)
    l_k = min(l, bn)    # a block holds bn rows; l_k = bn already emits all
    act = None if active is None else active.to(torch.int32).contiguous()
    cd, ci = scan(codes.contiguous(), queries.contiguous(), l_k, bn, act,
                  pack)
    return ScanBlocks(cd, ci, bn, cand_encoding(pack, w, bn)[2])


def merge_scan_blocks(blocks: ScanBlocks, l: int):
    """The second stage of ``hamming_topk_grouped``: the blocks' candidates
    merged into each (group, query)'s smallest l, (dists, ids) (G, B, l)."""
    cd, ci, bn, d_sent = blocks
    g, grid_n, b, l_k = cd.shape
    # widen: the pack sentinel maps back to DIST_SENTINEL (real distances
    # sit strictly below it — cand_encoding guards) and block-local ids get
    # their block's base.  Sentinel slots keep a garbage id until the
    # final where() turns it into -1.
    cd = cd.to(torch.int32)
    cd = torch.where(cd == d_sent, DIST_SENTINEL, cd)
    base = torch.arange(grid_n, dtype=torch.int32, device=cd.device) * bn
    ci = ci.to(torch.int32) + base.view(1, grid_n, 1, 1)
    # second-stage merge over grid·l_k candidates per (group, query):
    # lexicographic (distance, id), exactly the order of a full top-l
    cd = cd.permute(0, 2, 1, 3).reshape(g, b, grid_n * l_k)
    ci = ci.permute(0, 2, 1, 3).reshape(g, b, grid_n * l_k)
    cd, ci = _pad_topk(*lex_smallest(cd, ci, l), l)
    return cd, torch.where(cd >= DIST_SENTINEL, -1, ci)


def hamming_topk(codes, query, l: int, *, block_n: int = 4096,
                 select: str | None = None, pack: str | None = None):
    """Smallest-l Hamming matches of one query: (dists (l,), ids (l,)),
    through the fused scan (G = B = 1); ties to the lowest id, slots past
    n carry (DIST_SENTINEL, -1).  codes: (n, W) int32; query: (W,)."""
    d, i = hamming_topk_grouped(codes[None], query[None, None, :], l,
                                block_n=block_n, select=select, pack=pack)
    return d[0, 0], i[0, 0]


def hamming_topk_batch(codes, queries, l: int, *, block_n: int = 4096,
                       select: str | None = None, pack: str | None = None):
    """Smallest-l matches for B queries over one code table (G = 1):
    (dists (B, l), ids (B, l))."""
    d, i = hamming_topk_grouped(codes[None], queries[None], l,
                                block_n=block_n, select=select, pack=pack)
    return d[0], i[0]


def lbh_chain(p, q, r):
    """(s*q, s*p) of the fused LBH chain; any m (no padding)."""
    return _lbh.lbh_chain(_f32(p), _f32(q), _f32(r))


def lbh_grad(x, u, v, r):
    """Full eq.-18 gradient (-X^T(s*q), -X^T(s*p)) with the fused chain in
    the middle; the two projections and the two X^T products are
    strict-fp32 matmuls, as the JAX package leaves them to XLA."""
    with strict_fp32():
        p, q = x @ u, x @ v
        sq, sp = lbh_chain(p, q, r)
        return -(sq @ x), -(sp @ x)
