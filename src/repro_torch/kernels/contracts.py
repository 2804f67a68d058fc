"""Launch contracts of the port's CUDA kernels, checked without a
card: the counterpart of the JAX package's Pallas contract checker
(src/repro/lint/kernel_contracts.py).

For each kernel, ``launch_*`` works out the launch its wrapper would make
(the grid, the threads of a block, dynamic and static shared memory) from
the same formulas as its ``csrc/*.cu`` file, or raises ``ValueError``
where the wrapper refuses the shape.  ``check_launch`` holds a launch to
Hopper's limits:

- ``smem-over-budget``: dynamic plus static shared memory within the
  227 KB (232,448 B) a block may opt into;
- ``grid-y-z``: grid y and z within 65,535 (x within 2^31 - 1);
- ``threads``: at most 1,024 threads a block.

``sweep`` walks the declared space (block_n, W, B, l, pack; d and k for
the hash kernels; m for the LBH chain), as the reference's sweep does,
including the uint8 pack's ceiling (W = 7 legal, W = 8 illegal) and the
widest W a scan block holds.  The sentinel rules are checked both ways:
a point ``pack_is_legal`` (computed here, independently of
``hamming.cand_encoding``) calls illegal must be refused by the wrapper
(``sentinel-collision``), a legal one must not be (``sentinel-over-
strict``).

The reckoning is held to the code it copies on the card: the ``*_fits``
functions to each library's export of that name (``topk_hist_fits``,
``topk_hist_dma_fits``, ``topk_fused_fits``, ``distance_fits``), every
launch of the sweep to the ``*_plan`` export through which the library
reports the launch it would make (``compare_plans``), and the static
shared memory to the ptxas report (``chip_smoke.py`` phase 31).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from collections import Counter

from repro_torch.kernels import (_build, bilinear_hash, candidates, hamming,
                                  lbh_grad, margins, shard_select)

MAX_SMEM = 232448            # bytes a block may opt into on sm_90
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535
MAX_THREADS = 1024
SMS = 132                    # streaming multiprocessors of an H100 SXM5
SMEM_PER_SM = 233472         # 228 KB of shared memory per SM
SMEM_RESERVED = 1024         # reserved per resident block
MAX_THREADS_SM = 2048
MAX_BLOCKS_SM = 32

# Independent sentinel ceilings (not read from hamming.cand_encoding: a
# regression there must show).  A narrow pack is legal iff the largest
# real distance 32 W sits strictly below its distance sentinel and
# block-local ids fit the int16 id channel.
_PACK_DIST_SENTINEL = {"16": 2 ** 15 - 1, "8": 2 ** 8 - 1}
_PACK_ID_MAX = 2 ** 15 - 1


def pack_is_legal(pack: str, w: int, block_n: int) -> bool:
    if pack == "none":
        return True
    return 32 * w < _PACK_DIST_SENTINEL[pack] and block_n - 1 <= _PACK_ID_MAX


@dataclasses.dataclass(frozen=True)
class Launch:
    kernel: str
    grid: tuple[int, int, int]
    threads: int
    dynamic_smem: int
    static_smem: int = 0


def _align16(x: int) -> int:
    return (x + 15) & ~15


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# -- the scan kernels' select (csrc/hamming_select.cuh) ----------------------

THREADS = 256
WARPS = THREADS // 32
QUERIES = 8


def _byte_entries(w: int) -> bool:
    return 32 * w + 1 < 0xFF


def select_layout(w: int, block_n: int, bq: int, l_k: int, head: int,
                  wide: bool) -> int:
    """Total bytes of a select's shared memory (``hsel::layout``)."""
    n_units = _cdiv(block_n, 128) * 32
    unit = 4 if _byte_entries(w) else 8
    bins = 32 * w + 2
    tile = _align16(head)
    seg = _align16(tile + bq * n_units * unit)
    qs = _align16(seg + WARPS * bins * 4)
    ids = _align16(qs + bq * w * 4)
    hist = _align16(ids + bq * l_k * 2)
    return hist + WARPS * bins * (4 if wide else 64)


def _chunk_queries(w, block_n, l_k, head, wide) -> int:
    if block_n > 0x10000:
        return 0
    for bq in (8, 4, 2, 1):
        if select_layout(w, block_n, bq, l_k, head, wide) <= MAX_SMEM:
            return bq
    return 0


def choose_select(w: int, block_n: int, l_k: int,
                  head: int = 0) -> tuple[bool, int]:
    """(wide counters, query chunk); chunk 0 if nothing fits."""
    bq = _chunk_queries(w, block_n, l_k, head, False)
    if bq > 0 or _byte_entries(w):
        return False, bq
    return True, _chunk_queries(w, block_n, l_k, head, True)


def topk_hist_fits(w: int, block_n: int) -> bool:
    return choose_select(w, block_n, block_n)[1] > 0


topk_fused_fits = topk_hist_fits


# -- kernel 3's ring (csrc/hamming_topk_hist.cu) -----------------------------

def _slot_bytes(w: int, sub: int) -> int:
    return _align16(4 * w * sub + 16)


def _ring_head(stages: int) -> int:
    return _align16(16 * stages)


@dataclasses.dataclass(frozen=True)
class DmaPlan:
    wide: bool
    bq: int
    groups: int = 0
    sub: int = 0
    stages: int = 0
    group_bytes: int = 0
    total: int = 0


def plan_dma(w: int, block_n: int, l_k: int, nq: int) -> DmaPlan:
    """``plan_dma``: the select, the warp groups, the slab rows and the
    ring's slots of a kernel 3 launch; bq 0 if nothing fits."""
    rows = _cdiv(block_n, 128) * 128
    min_ring = _ring_head(2) + 2 * _slot_bytes(w, 128)
    wide, bq = choose_select(w, block_n, l_k, min_ring)
    if bq == 0:
        return DmaPlan(wide, 0)
    group = _align16(select_layout(w, block_n, bq, l_k, 0, wide))
    chunks = _cdiv(nq, bq)
    g = min(chunks, 4) if chunks > 0 else 1
    while g > 1 and g * group + min_ring > MAX_SMEM:
        g -= 1
    if g * group + min_ring > MAX_SMEM:
        return DmaPlan(wide, 0)
    room = MAX_SMEM - g * group
    sub = (8192 // (4 * w)) // 128 * 128
    sub = min(max(sub, 256), rows)
    while sub > 128 and _ring_head(2) + 2 * _slot_bytes(w, sub) > room:
        sub -= 128
    stages = 2
    while stages < 4 and (_ring_head(stages + 1)
                          + (stages + 1) * _slot_bytes(w, sub) <= room):
        stages += 1
    total = _ring_head(stages) + stages * _slot_bytes(w, sub) + g * group
    if total > MAX_SMEM:
        return DmaPlan(wide, 0)
    return DmaPlan(wide, bq, g, sub, stages, group, total)


def topk_hist_dma_fits(w: int, block_n: int) -> bool:
    return plan_dma(w, block_n, block_n, 1).bq > 0


def resident_blocks(threads: int, smem: int) -> int:
    """Blocks of this shape one SM holds at once by threads and shared
    memory: an upper bound on the occupancy kernel 3 sizes its persistent
    grid by at launch, which the runtime also limits by registers."""
    return max(0, min(MAX_BLOCKS_SM, MAX_THREADS_SM // threads,
                      SMEM_PER_SM // (smem + SMEM_RESERVED)))


def launch_scan(select: str, g: int, n: int, w: int, b: int, l_k: int,
                block_n: int, pack: str = "16",
                per_sm: int | None = None) -> Launch:
    """The launch of ``hamming_topk_hist`` (select "hist"),
    ``hamming_topk_hist_dma`` ("hist_dma") or ``hamming_topk_fused``
    ("fused") on codes (g, n, w) and b queries; raises ValueError where
    the wrapper refuses (``hamming._launch_scan``).  per_sm: kernel 3's
    occupancy (default ``resident_blocks``)."""
    if not 1 <= l_k <= block_n:
        raise ValueError(f"need 1 <= l_k <= block_n, got {l_k}, {block_n}")
    hamming.cand_encoding(pack, w, block_n)
    grid_n = _cdiv(n, block_n)
    if select == "hist_dma":
        if not topk_hist_dma_fits(w, block_n):
            raise ValueError(f"W = {w} at block_n = {block_n} does not fit")
        pl = plan_dma(w, block_n, l_k, b)
        threads = pl.groups * THREADS
        items = g * grid_n * _cdiv(_cdiv(b, pl.bq), pl.groups)
        if per_sm is None:
            per_sm = resident_blocks(threads, pl.total)
        blocks = max(1, min(per_sm * SMS, items))
        if items > MAX_GRID_X:
            blocks = items
        return Launch("topk_hist_dma_kernel", (blocks, 1, 1), threads,
                      pl.total)
    if not topk_hist_fits(w, block_n):
        raise ValueError(f"W = {w} at block_n = {block_n} does not fit")
    wide, bq = choose_select(w, block_n, l_k)
    smem = select_layout(w, block_n, bq, l_k, 0, wide)
    name = "topk_fused_kernel" if select == "fused" else "topk_hist_kernel"
    return Launch(name, (g * grid_n * _cdiv(b, bq), 1, 1), THREADS, smem)


# -- the distance kernels (csrc/hamming_distance.cu) -------------------------

DISTANCE_CHUNK = 32


def distance_fits(w: int) -> bool:
    return 4 * w * DISTANCE_CHUNK <= MAX_SMEM


def launch_distance(n: int, w: int, b: int | None = None) -> Launch:
    """``hamming_distance`` (b None: one query) or
    ``hamming_distance_batch`` (b queries)."""
    if not distance_fits(w):
        raise ValueError(f"W = {w} words per query does not fit")
    if b is None:
        return Launch("distance_kernel", (_cdiv(n, 256), 1, 1), 256, 4 * w)
    return Launch("distance_batch_kernel",
                  (_cdiv(n, 256), _cdiv(b, DISTANCE_CHUNK), 1), 256,
                  4 * w * min(b, DISTANCE_CHUNK))


# -- the hash kernels' product (csrc/bilinear_product.cuh) -------------------

def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


CHAIN = 0                    # ProductPlan.tm of the chain plan (bprod::kChain)
CHAIN_STAGES = 4
CHAIN_UNROLL = 8             # d of a group of a chain's FMAs
CHAIN_AHEAD = 3              # groups a chain's loads run ahead
CHAIN_SMEM = 200 * 1024
MAX_COLS = 128               # columns a pass holds (bprod::kMaxCols)
CHAIN_ROWS = CHAIN_COLS = 4  # a chain block's rows and columns


@dataclasses.dataclass(frozen=True)
class ProductPlan:
    tm: int
    tn: int
    rg: int
    ncg: int
    cols: int
    passes: int
    row_blocks: int
    smem: int
    threads: int = THREADS
    td: int = 32                 # d per tile (a chain plan's stage)

    @property
    def chain(self) -> bool:
        return self.tm == CHAIN


def product_plan(tm: int, tn: int, n: int, k: int, groups: int) -> ProductPlan:
    """``bprod::make_plan``."""
    kp = _round_up(k, tn)
    cols = groups * kp
    cpw = cols if cols < MAX_COLS else MAX_COLS // tn * tn
    ncg = cpw // tn
    rg = THREADS // ncg
    if rg * tm > 256:
        rg = 256 // tm
    rg = min(rg, _cdiv(n, tm))
    br = rg * tm
    brf = _round_up(br, 4)
    passes = _cdiv(cols, cpw)
    words = _cdiv(k, 32)

    def word(c):
        return (c // kp) * words + (c % kp) // 32

    wspan = max(word(min((q + 1) * cpw, cols) - 1) - word(q * cpw) + 1
                for q in range(passes))
    stage = 32 * ((_round_up(brf, 32) + 4) + 2 * _round_up(cpw, 4))
    smem = max(2 * stage * 4, br * wspan * 4)
    return ProductPlan(tm, tn, rg, ncg, cols, passes, _cdiv(n, br), smem)


def chain_plan(n: int, k: int, groups: int, sms: int = SMS) -> ProductPlan:
    """``bprod::make_chain_plan``: blocks of CHAIN_ROWS rows x CHAIN_COLS
    columns (grid x the row groups, y the column groups), a warp of their
    32 chains and one that fills the ring; the stage's d the largest of
    512 .. 32 whose ring of CHAIN_STAGES fits CHAIN_SMEM and fits as many
    blocks an SM as the grid has per SM (else 32)."""
    cols = groups * k
    br = min(CHAIN_ROWS, n)
    row_blocks, col_blocks = _cdiv(n, br), _cdiv(cols, CHAIN_COLS)
    budget = SMEM_PER_SM // _cdiv(row_blocks * col_blocks, sms)
    budget = (CHAIN_SMEM if budget > SMEM_RESERVED + CHAIN_SMEM
              else budget - SMEM_RESERVED)

    def smem(td):
        # the mbarriers, then stages of x rows and factor columns of td + 4
        # floats, then the slack a chain's loads may read past the last
        stage = (br + 2 * CHAIN_COLS) * (td + 4)
        return (16 * CHAIN_STAGES
                + (CHAIN_STAGES * stage + CHAIN_AHEAD * CHAIN_UNROLL + 4) * 4)

    td = next((t for t in (512, 256, 128, 64) if smem(t) <= budget), 32)
    return ProductPlan(CHAIN, 1, br, 2 * CHAIN_COLS, cols, col_blocks,
                       row_blocks, smem(td), 64, td)


def choose_product(n: int, k: int, groups: int,
                   sms: int = SMS) -> ProductPlan:
    """``bprod::choose_plan``: the largest tile whose grid fills the card
    with 90% of a block's threads busy, else the largest that fills it,
    else the chain plan."""
    filled = None
    for tm, tn in ((8, 4), (4, 4), (2, 2), (1, 1)):
        p = product_plan(tm, tn, n, k, groups)
        blocks = p.passes * p.row_blocks
        if blocks >= sms:
            if 10 * p.rg * p.ncg >= 9 * THREADS:
                return p
            filled = filled or p
    return filled or chain_plan(n, k, groups, sms)


def launch_hash(n: int, d: int, k: int, groups: int | None = None) -> list:
    """``bilinear_hash`` (groups None) or ``bilinear_hash_seeded``
    (groups tables): its launches, the seeded generation first; for the
    chain plan ``bilinear_hash`` first copies its factors column-major."""
    if n < 1 or d < 1 or k < 1 or (groups is not None and groups < 1):
        raise ValueError(f"need n, d, k, groups >= 1, got {n}, {d}, {k}, "
                         f"{groups}")
    p = choose_product(n, k, groups or 1)
    out = []
    # the chain plan's copy of x's rows: n d more elements
    x_copy = n * d if p.chain else 0
    if groups is not None:
        out.append(Launch("bh_seeded_generate_kernel",
                          (_cdiv(d * p.cols + x_copy, 256), 1, 1), 256, 0))
    elif p.chain:
        out.append(Launch("bilinear_hash_transpose_kernel",
                          (_cdiv(d * k + x_copy, 256), 1, 1), 256, 0))
    name = ("bh_seeded_product_kernel" if groups is not None
            else "bilinear_hash_kernel")
    out.append(Launch(name, (p.row_blocks, p.passes, 1), p.threads, p.smem))
    return out


# -- the LBH chain (csrc/lbh_chain.cu) ---------------------------------------

LBH_COLS = 32 * 4 * 8            # a chunk of columns: kCols


def launch_lbh_chain(m: int) -> Launch:
    if m < 1:
        raise ValueError(f"need m >= 1, got {m}")
    return Launch("lbh_chain_kernel", (min(m, SMS), 1, 1), 256, 0,
                  static_smem=2 * LBH_COLS * 4)


# -- the candidate lists (csrc/candidate_lists.cu) ---------------------------

LISTS_THREADS = 1024


def launch_cand_lists(b: int, c: int) -> Launch:
    """One block a query over its c union slots; a warp's kept count each
    in static shared memory."""
    if b < 1 or c < 1:
        raise ValueError(f"need b, c >= 1, got {b}, {c}")
    return Launch("cand_lists_kernel", (b, 1, 1), LISTS_THREADS, 0,
                  static_smem=4 * (LISTS_THREADS // 32))


# -- one shard's select (csrc/shard_select.cu) -------------------------------

SHARD_THREADS = 256
SHARD_OFFSET_THREADS = 1024
SHARD_BLOCK_ROWS = 4096
SHARD_SMEM = 48 * 1024           # a chunk of queries with its bins
# the offsets' static shared memory: a warp's two counts each, then one
# int, which ptxas places at the next 16 bytes
SHARD_OFFSET_SMEM = 8 * (SHARD_OFFSET_THREADS // 32) + 16


def launch_shard_select(g: int, rows: int, n_valid: int, w: int, nq: int,
                        width: int) -> list:
    """The histogram pass, then the offsets and the select: a block a
    (row block, group, query chunk), the offsets one a (group, query)."""
    bins = 32 * w + 1
    qb = min(nq, SHARD_SMEM // (4 * (w + bins))) if nq >= 1 else 0
    if (g < 1 or nq < 1 or w < 1 or qb < 1 or width < 1
            or not 1 <= n_valid <= rows):
        raise ValueError(f"need g, nq, w, width >= 1, 1 <= n_valid <= rows "
                         f"and a chunk of queries, got {g}, {nq}, {w}, "
                         f"{width}, {n_valid}, {rows}")
    grid = (_cdiv(n_valid, SHARD_BLOCK_ROWS), g, _cdiv(nq, qb))
    return [Launch("shard_hist_kernel", grid, SHARD_THREADS,
                   4 * qb * (w + bins)),
            Launch("shard_offsets_kernel", (g * nq, 1, 1),
                   SHARD_OFFSET_THREADS, 0, static_smem=SHARD_OFFSET_SMEM),
            Launch("shard_select_kernel", grid, SHARD_THREADS, 4 * qb * w,
                   static_smem=2 * 8 * (SHARD_THREADS // 32))]


# -- the re-rank's margins (csrc/row_margins.cu) ----------------------------

MARGINS_NARROW_MAX = 4096        # widest row one warp sums
MARGINS_WIDE_WARPS = 8           # warps a row past it
MARGINS_NARROW_THREADS = 256     # a narrow block: 8 warps, 32 slots each
MARGINS_WIDE_THREADS = 512
MARGINS_WIDE_ROWS = 4            # slots a wide block takes
MARGINS_STAGE_MAX = 57344        # widest w a block stages (224 KiB)
# the norm's 16 warp partials and two rounds of 16 warp sums, float32
MARGINS_SMEM = 4 * (16 + 2 * 16)


def launch_row_margins(b: int, c: int, d: int) -> Launch:
    """A block a query and a slab of its c slots: narrow rows (d <=
    4,096) one warp a row and 256 slots a block, wide rows 8 warps a row
    and 4 slots a block; w staged in dynamic shared memory up to d =
    57,344."""
    if b < 1 or c < 1 or d < 1:
        raise ValueError(f"need b, c, d >= 1, got {b}, {c}, {d}")
    narrow = d <= MARGINS_NARROW_MAX
    slab = MARGINS_NARROW_THREADS if narrow else MARGINS_WIDE_ROWS
    blocks = b * _cdiv(c, slab)
    if blocks > MAX_GRID_X:
        raise ValueError(f"{blocks} blocks for b {b}, c {c}")
    return Launch("row_margins_kernel", (blocks, 1, 1),
                  MARGINS_NARROW_THREADS if narrow else MARGINS_WIDE_THREADS,
                  4 * d if d <= MARGINS_STAGE_MAX else 0,
                  static_smem=MARGINS_SMEM)


# static shared memory of each kernel's ptxas report (bytes)
STATIC_SMEM = {"bilinear_hash_kernel": 0, "bh_seeded_product_kernel": 0,
               "bilinear_hash_transpose_kernel": 0,
               "bh_seeded_generate_kernel": 0, "lbh_chain_kernel":
               2 * LBH_COLS * 4, "topk_hist_kernel": 0,
               "topk_hist_dma_kernel": 0, "topk_fused_kernel": 0,
               "distance_kernel": 0, "distance_batch_kernel": 0,
               "cand_lists_kernel": 4 * (LISTS_THREADS // 32),
               "shard_hist_kernel": 0,
               "shard_offsets_kernel": SHARD_OFFSET_SMEM,
               "shard_select_kernel": 2 * 8 * (SHARD_THREADS // 32),
               "row_margins_kernel": MARGINS_SMEM}


# -- checks --------------------------------------------------------------------

def check_launch(launch: Launch, case_id: str) -> list[str]:
    out = []
    smem = launch.dynamic_smem + launch.static_smem
    if smem > MAX_SMEM:
        out.append(f"smem-over-budget [{launch.kernel} {case_id}]: {smem} B "
                   f"> {MAX_SMEM}")
    x, y, z = launch.grid
    if not (1 <= x <= MAX_GRID_X and 1 <= y <= MAX_GRID_YZ
            and 1 <= z <= MAX_GRID_YZ):
        out.append(f"grid-y-z [{launch.kernel} {case_id}]: grid {launch.grid}")
    if not 1 <= launch.threads <= MAX_THREADS:
        out.append(f"threads [{launch.kernel} {case_id}]: {launch.threads}")
    return out


@dataclasses.dataclass
class Case:
    kernel: str
    case_id: str
    args: tuple                     # the reckoning's arguments
    legal: bool = True              # the sentinel rules' verdict


_RECKON = {
    "hist": functools.partial(launch_scan, "hist"),
    "hist_dma": functools.partial(launch_scan, "hist_dma"),
    "fused": functools.partial(launch_scan, "fused"),
    "distance": launch_distance, "distance_batch": launch_distance,
    "bilinear_hash": launch_hash, "bilinear_hash_seeded": launch_hash,
    "lbh_chain": launch_lbh_chain,
    "cand_lists": launch_cand_lists,
    "shard_select": launch_shard_select,
    "row_margins": launch_row_margins,
}


def reckon(case: Case):
    """The case's launch (a list for the seeded hash's two); raises the
    wrapper's ValueError where it refuses the case."""
    return _RECKON[case.kernel](*case.args)


def scan_cases():
    """The scans' declared space: every pack at W = 1, 7 (uint8's
    ceiling, legal), 8 (illegal for uint8), 13 (wide counters) and 32 (the
    widest), each at three (block_n, G, B, l) shapes."""
    for select in ("hist", "hist_dma", "fused"):
        for pack in ("none", "16", "8"):
            for w in (1, 7, 8, 13, 32):
                for block_n, g, b, l in ((256, 1, 8, 8), (2048, 4, 32, 128),
                                         (8192, 2, 128, 512)):
                    n = 2 * block_n - 3
                    yield Case(
                        select, f"{select}-bn{block_n}-w{w}-b{b}-l{l}-{pack}",
                        (g, n, w, b, min(l, block_n), block_n, pack),
                        pack_is_legal(pack, w, block_n))


def other_cases():
    for block_n in (256, 2048):
        for w in (1, 8, 1816):
            yield Case("distance", f"bn{block_n}-w{w}", (2 * block_n, w))
            for b in (1, 3, 128, 2 ** 20):
                yield Case("distance_batch", f"bn{block_n}-w{w}-b{b}",
                           (2 * block_n, w, b))
    # the query shapes of tiny1m (10, 385, 20) and news20 (20, 26,215, 16)
    # take the chain plan, as the 32-row one does; 1,000 rows at k 64 too
    for n, d, k in ((32, 385, 20), (1_060_000, 385, 20), (8192, 2048, 64),
                    (1_060_000, 26_215, 256), (100, 1, 1), (10, 385, 20),
                    (20, 26_215, 16), (1000, 26_215, 64), (3, 5, 33)):
        yield Case("bilinear_hash", f"n{n}-d{d}-k{k}", (n, d, k))
        for g in (1, 4, 7):
            yield Case("bilinear_hash_seeded", f"g{g}-n{n}-d{d}-k{k}",
                       (n, d, k, g))
    for m in (1, 1024, 2048, 4000):
        yield Case("lbh_chain", f"m{m}", (m,))
    for b, c in ((1, 1), (10, 6264), (20, 201), (32, 65536), (4096, 33)):
        yield Case("cand_lists", f"b{b}-c{c}", (b, c))
    for g, rows, n_valid, w, nq, width in (
            (1, 19_840_505, 19_840_505, 1, 10, 120_000),
            (1, 19_840_505, 19_840_489, 1, 10, 1),
            (4, 300_000, 1, 1, 32, 5), (2, 8191, 8190, 13, 7, 9000),
            (1, 5000, 4097, 32, 100, 4097)):
        yield Case("shard_select", f"g{g}-r{rows}-v{n_valid}-w{w}-b{nq}",
                   (g, rows, n_valid, w, nq, width))
    # the three cells' shapes (tiny1m, news20, a card of the four-card
    # cell), each side of the narrow / wide split and of staging w
    for b, c, d in ((10, 6264, 385), (20, 201, 26_215), (10, 120_000, 385),
                    (1, 1, 1), (3, 33, 65), (4096, 3, 385), (7, 5, 4096),
                    (7, 5, 4097), (2, 9, 57_344), (2, 9, 57_345),
                    (1, 70_000, 100_000)):
        yield Case("row_margins", f"b{b}-c{c}-d{d}", (b, c, d))


def sweep() -> list[tuple[Case, object]]:
    """Every case with its launch(es), or the ValueError the wrapper would
    raise."""
    out = []
    for case in list(scan_cases()) + list(other_cases()):
        try:
            out.append((case, reckon(case)))
        except ValueError as e:
            out.append((case, e))
    return out


def run() -> list[str]:
    """Findings over the sweep: an empty list is a clean contract."""
    findings = []
    for case, got in sweep():
        if isinstance(got, ValueError):
            if case.legal:
                findings.append(f"sentinel-over-strict [{case.case_id}]: a "
                                f"legal point was refused: {got}")
            continue
        if not case.legal:
            findings.append(f"sentinel-collision [{case.case_id}]: an "
                            f"illegal pack point was accepted")
            continue
        for launch in (got if isinstance(got, list) else [got]):
            findings += check_launch(launch, case.case_id)
    return findings


def widest_w(fits, block_n: int, limit: int) -> int:
    """The widest W (words per code) up to limit that ``fits`` accepts at
    block_n."""
    return max((w for w in range(1, limit + 1) if fits(w, block_n)),
               default=0)


# -- the libraries' own plans (on the card) ------------------------------------

_LIBRARY_SIGNATURES = {
    **hamming._SIGNATURES,
    bilinear_hash.LIBRARY: bilinear_hash._SIGNATURES,
    bilinear_hash.FACTORS_LIBRARY: bilinear_hash._FACTORS_SIGNATURES,
    lbh_grad.LIBRARY: lbh_grad._SIGNATURES,
    candidates.LIBRARY: candidates._SIGNATURES,
    shard_select.LIBRARY: shard_select._SIGNATURES,
    margins.LIBRARY: margins._SIGNATURES,
}


def plan_export(case: Case) -> tuple[str, str, tuple]:
    """(library, its ``*_plan`` export, the export's arguments before its
    output) for the case's launch."""
    k, a = case.kernel, case.args
    if k in ("hist", "hist_dma", "fused"):
        g, n, w, b, l_k, block_n, pack = a
        head = (g, w, b, l_k, block_n, _cdiv(n, block_n))
        if k == "hist_dma":
            return (hamming.LIBRARY, "topk_hist_dma_plan",
                    head + (hamming._PACK_CODE[pack],))
        return ((hamming.LIBRARY, "topk_hist_plan", head) if k == "hist"
                else (hamming.FUSED_LIBRARY, "topk_fused_plan", head))
    return {"distance": (hamming.DISTANCE_LIBRARY, "distance_plan", a),
            "distance_batch": (hamming.DISTANCE_LIBRARY,
                               "distance_batch_plan", a),
            "bilinear_hash": (bilinear_hash.FACTORS_LIBRARY, "bh_plan", a),
            "bilinear_hash_seeded": (bilinear_hash.LIBRARY, "bh_seeded_plan",
                                     a),
            "lbh_chain": (lbh_grad.LIBRARY, "lbh_chain_plan", a),
            "cand_lists": (candidates.LIBRARY, "cand_lists_plan", a),
            "shard_select": (shard_select.LIBRARY, "shard_select_plan",
                             a),
            "row_margins": (margins.LIBRARY, "row_margins_plan", a)}[k]


def library_plan(case: Case, n: int | None = None):
    """The built library's own account of the case's n launches (default:
    the kernel's usual count), from its ``*_plan`` export (needs the
    card): a list of (grid, threads, dynamic shared memory, blocks per SM
    or 0), or the export's error code where the library refuses the
    case."""
    library, export, args = plan_export(case)
    out = (ctypes.c_int64 * 18)()
    rc = getattr(_build.load(library, _LIBRARY_SIGNATURES[library]),
                 export)(*args, out)
    if rc:
        return rc
    if n is None:
        n = {"bilinear_hash_seeded": 2, "shard_select": 3}.get(case.kernel,
                                                                1)
    return [(tuple(out[6 * i:6 * i + 3]), out[6 * i + 3], out[6 * i + 4],
             out[6 * i + 5]) for i in range(n)]


def compare_plans() -> dict:
    """Every launch the sweep reckons against the library's own plan of
    it: grid, threads and dynamic shared memory equal.  Kernel 3's grid
    is reckoned at the occupancy the runtime gave the library, which
    ``resident_blocks`` must bound.  Returns {"launches": compared,
    "differ": [(case id, what)], "dma_per_sm": {"runtime / bound":
    cases}}."""
    compared, wrong, occupancy = 0, [], Counter()
    for case, got in sweep():
        if isinstance(got, ValueError):
            continue
        mine = got if isinstance(got, list) else [got]
        theirs = library_plan(case, len(mine))
        if isinstance(theirs, int):
            wrong.append((case.case_id, f"the library refuses: {theirs}"))
            continue
        if case.kernel == "hist_dma":
            per_sm = theirs[0][3]
            bound = resident_blocks(mine[0].threads, mine[0].dynamic_smem)
            occupancy[f"{per_sm} / {bound}"] += 1
            if per_sm > bound:
                wrong.append((case.case_id, f"occupancy {per_sm} > the "
                              f"bound {bound}"))
            mine = [launch_scan("hist_dma", *case.args, per_sm=per_sm)]
        for m, (grid, threads, smem, _) in zip(mine, theirs):
            compared += 1
            if (m.grid, m.threads, m.dynamic_smem) != (grid, threads, smem):
                wrong.append((case.case_id, f"{m.kernel}: reckoned "
                              f"{(m.grid, m.threads, m.dynamic_smem)}, the "
                              f"library's {(grid, threads, smem)}"))
    return {"launches": compared, "differ": wrong,
            "dma_per_sm": dict(occupancy)}

