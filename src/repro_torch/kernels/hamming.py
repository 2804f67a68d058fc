"""Hamming kernels: the CUDA kernels' wrappers, their launch counts and
their plain PyTorch versions.

The fused scans emit, for each (group, row block) and each of the group's
B queries, the exact block-local smallest-t set of (distance, row) pairs,
t = min(l, live rows in the block), ties to the lowest row:

- ``hamming_topk_hist`` (csrc/hamming_topk_hist.cu, ``topk_hist_kernel``)
  selects by a distance histogram and emits in row order, slots past t
  carrying (pack sentinel, block_n - 1); it replaces the TPU kernel
  ``hamming_topk_hist_kernel`` with dma=False
  (src/repro/kernels/hamming.py:429);
- ``hamming_topk_hist_dma`` (the same source, ``topk_hist_dma_kernel``)
  gives the same output from persistent blocks that prefetch the next code
  tile with cp.async; it replaces ``hamming_topk_hist_kernel`` with
  dma=True;
- ``hamming_topk_fused`` (csrc/hamming_topk_fused.cu) runs the same
  select and emits in (distance, row) order by a stable counting sort of
  the kept rows, slots past t carrying (pack sentinel, 0): the order of the
  TPU kernel ``hamming_topk_fused_kernel``
  (src/repro/kernels/hamming.py:207), which takes l rounds of masked
  argmin to reach it.

The merge that turns block-local candidates into the global top-l lives in
``kernels.ops`` and is the same for all three.  The unfused distances:

- ``hamming_distance`` (csrc/hamming_distance.cu, ``distance_kernel``):
  (n,) distances to one query; it replaces ``hamming_distance_kernel``
  (src/repro/kernels/hamming.py:123);
- ``hamming_distance_batch`` (the same source,
  ``distance_batch_kernel``): the (B, n) distance matrix; it replaces
  ``hamming_distance_batch_kernel`` (src/repro/kernels/hamming.py:516),
  whose (n, B) output the JAX wrapper transposes to (B, n).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.search import DIST_SENTINEL
from repro_torch.kernels import _build
from repro_torch.utils.bits import hamming_packed

# Each candidate pack's distance sentinel (its dtype's max), and the
# block-local id range of the int16 id packs.
CAND_SENTINELS = {"none": DIST_SENTINEL, "16": 0x7FFF, "8": 0xFF}
_CAND_ID_MAX = 0x7FFF
_PACK_CODE = {"none": 0, "16": 1, "8": 2}

LIBRARY = "hamming_topk_hist"
FUSED_LIBRARY = "hamming_topk_fused"
DISTANCE_LIBRARY = "hamming_distance"


def _scan_signatures(*prefixes: str) -> dict:
    sigs = {}
    for prefix in prefixes:
        sigs[f"{prefix}_fits"] = (ctypes.c_int, [ctypes.c_int] * 2)
        sigs[f"{prefix}_launch"] = (ctypes.c_int, [ctypes.c_void_p] * 5
                                    + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        # the launch's shape without launching (kernels.contracts reads it);
        # the pipelined scan's also takes the pack, whose kernel's
        # occupancy sizes its grid
        ints = 7 if prefix == "topk_hist_dma" else 6
        sigs[f"{prefix}_plan"] = (ctypes.c_int, [ctypes.c_int] * ints
                                  + [ctypes.c_void_p])
    return sigs


# every function of each library, declared when the library first loads
_SIGNATURES = {
    LIBRARY: _scan_signatures("topk_hist", "topk_hist_dma"),
    FUSED_LIBRARY: _scan_signatures("topk_fused"),
    DISTANCE_LIBRARY: {
        "distance_fits": (ctypes.c_int, [ctypes.c_int]),
        "distance_launch": (ctypes.c_int, [ctypes.c_void_p] * 3
                            + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
        "distance_batch_launch": (ctypes.c_int, [ctypes.c_void_p] * 3
                                  + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
        "distance_plan": (ctypes.c_int, [ctypes.c_int] * 2
                          + [ctypes.c_void_p]),
        "distance_batch_plan": (ctypes.c_int, [ctypes.c_int] * 3
                                + [ctypes.c_void_p]),
    },
}


def cand_encoding(pack: str, w: int, block_n: int):
    """Resolve a candidate pack to (dist_dtype, id_dtype, sentinel).

    Real distances (<= 32·W) must stay strictly below the narrow sentinel,
    and block-local ids (< block_n) must fit the id dtype; raises
    ValueError instead of corrupting the tie/sentinel contract.
    """
    if pack not in CAND_SENTINELS:
        raise ValueError(f"cand pack must be one of {sorted(CAND_SENTINELS)},"
                         f" got {pack!r}")
    sent = CAND_SENTINELS[pack]
    if pack == "none":
        return torch.int32, torch.int32, sent
    if 32 * w >= sent:
        raise ValueError(
            f"cand pack {pack!r}: max Hamming distance 32·W = {32 * w} "
            f"would reach the narrow sentinel {sent} — masked slots could "
            f"no longer sort after real candidates (use a wider pack)")
    if block_n - 1 > _CAND_ID_MAX:
        raise ValueError(
            f"cand pack {pack!r}: block_n = {block_n} exceeds the int16 "
            f"block-local id range ({_CAND_ID_MAX + 1})")
    return (torch.int16 if pack == "16" else torch.uint8), torch.int16, sent


def _block_distances(codes, queries, block_n: int, active=None):
    """(dist (G, grid, B, block_n) int32, live (grid, block_n) bool): every
    block's distance tile, rows past n or with active == 0 at
    DIST_SENTINEL."""
    g, n, w = codes.shape
    b = queries.shape[1]
    grid = -(-n // block_n)
    n_pad = grid * block_n
    codes_p = torch.nn.functional.pad(codes, (0, 0, 0, n_pad - n))
    live = torch.arange(n_pad, device=codes.device) < n
    if active is not None:
        live &= torch.nn.functional.pad(active.to(torch.int32),
                                        (0, n_pad - n)) > 0
    live = live.view(grid, block_n)
    dist = hamming_packed(codes_p.view(g, grid, 1, block_n, w),
                          queries.view(g, 1, b, 1, w))
    return torch.where(live[None, :, None, :], dist, DIST_SENTINEL), live


def hamming_topk_hist_plain(codes, queries, l_k: int, block_n: int,
                            active=None, pack: str = "none"):
    """Plain version of the kernel, all blocks at once: the per-block
    distance tile, bisection of its CDF to the cutoff r, the tie-rank
    cumsum, then each kept row's slot.  Same arguments and outputs as
    ``hamming_topk_hist``."""
    g, _, w = codes.shape
    b = queries.shape[1]
    d_dtype, i_dtype, d_sent = cand_encoding(pack, w, block_n)
    dev = codes.device
    dist, live = _block_distances(codes, queries, block_n, active)
    grid = live.shape[0]
    t = live.sum(dim=1).clamp(max=l_k).view(1, grid, 1, 1)
    max_dist = 32 * w
    lo = torch.zeros((g, grid, b, 1), dtype=torch.int32, device=dev)
    hi = torch.full((g, grid, b, 1), max_dist, dtype=torch.int32, device=dev)
    for _ in range(max(1, max_dist.bit_length())):
        mid = (lo + hi) >> 1
        ge = (dist <= mid).sum(dim=-1, keepdim=True) >= t
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    r = hi
    less = (dist < r).sum(dim=-1, keepdim=True)
    tie = dist == r
    tie_rank = torch.cumsum(tie, dim=-1) - 1
    keep = (dist < r) | (tie & (tie_rank < (t - less)))
    slot = torch.where(keep, torch.cumsum(keep, dim=-1) - 1, l_k)
    rows = torch.arange(block_n, dtype=torch.int32, device=dev).expand_as(dist)
    out_d = torch.full((g, grid, b, l_k + 1), DIST_SENTINEL,
                       dtype=torch.int32, device=dev)
    out_i = torch.full((g, grid, b, l_k + 1), block_n - 1,
                       dtype=torch.int32, device=dev)
    out_d.scatter_(-1, slot, dist)
    out_i.scatter_(-1, slot, rows)
    return (torch.clamp(out_d[..., :l_k], max=d_sent).to(d_dtype),
            out_i[..., :l_k].to(i_dtype))


def hamming_topk_hist(codes, queries, l_k: int, block_n: int, active=None,
                      pack: str = "16"):
    """Block-local fused scan + histogram select over G stacked code groups.

    codes: (G, n, W) int32 (uint32 bits); queries: (G, B, W) int32; active:
    optional (n,) int32 liveness shared by all groups (0 = dead row);
    1 <= l_k <= block_n.  Returns (dists, ids), each (G, ceil(n/block_n),
    B, l_k) in the pack's dtypes (``cand_encoding``), ids block-local, kept
    rows in row order.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``hamming_topk_hist.launches``) or raises.
    """
    if codes.device.type == "cpu":
        return hamming_topk_hist_plain(codes, queries, l_k, block_n, active,
                                       pack)
    out = _launch_scan(LIBRARY, "topk_hist", codes, queries, l_k, block_n,
                       active, pack)
    _build.count(hamming_topk_hist)
    return out


hamming_topk_hist.launches = 0


def hamming_topk_hist_dma(codes, queries, l_k: int, block_n: int,
                          active=None, pack: str = "16"):
    """The histogram-select scan through the pipelined kernel: persistent
    blocks walk the (group, row block) steps, each copying its next code
    tile into a second shared buffer (cp.async) while it selects from the
    current one.  Same arguments and outputs as ``hamming_topk_hist``, bit
    for bit, so its plain version is ``hamming_topk_hist_plain``.  The
    codes stream through two sub-tiles of at most 4,096 words, so it takes
    every shape ``hamming_topk_hist`` takes (W <= 32 at block_n <= 8192).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``hamming_topk_hist_dma.launches``) or
    raises.
    """
    if codes.device.type == "cpu":
        return hamming_topk_hist_plain(codes, queries, l_k, block_n, active,
                                       pack)
    out = _launch_scan(LIBRARY, "topk_hist_dma", codes, queries, l_k,
                       block_n, active, pack)
    _build.count(hamming_topk_hist_dma)
    return out


hamming_topk_hist_dma.launches = 0


def hamming_topk_fused_plain(codes, queries, l_k: int, block_n: int,
                             active=None, pack: str = "none"):
    """Plain version of the distance-order kernel, all blocks at once: a
    stable sort of each block's distance tile (ties to the lowest row),
    cut to l_k; slots past the live rows carry (pack sentinel, 0), as the
    TPU kernel's argmin over an all-sentinel tile gives.  Same arguments
    and outputs as ``hamming_topk_fused``."""
    w = codes.shape[2]
    d_dtype, i_dtype, d_sent = cand_encoding(pack, w, block_n)
    dist, _ = _block_distances(codes, queries, block_n, active)
    d, rows = torch.sort(dist, dim=-1, stable=True)
    d, rows = d[..., :l_k], rows[..., :l_k]
    rows = torch.where(d >= DIST_SENTINEL, 0, rows)
    return torch.clamp(d, max=d_sent).to(d_dtype), rows.to(i_dtype)


def hamming_topk_fused(codes, queries, l_k: int, block_n: int, active=None,
                       pack: str = "16"):
    """Block-local fused scan + select in (distance, row) order over G
    stacked code groups (the order of the TPU kernel's l_k rounds of masked
    argmin).  Same arguments and output shapes as ``hamming_topk_hist``;
    the kept rows come in (distance, row) order and the slots past the
    live rows carry (pack sentinel, 0).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``hamming_topk_fused.launches``) or raises.
    """
    if codes.device.type == "cpu":
        return hamming_topk_fused_plain(codes, queries, l_k, block_n, active,
                                        pack)
    out = _launch_scan(FUSED_LIBRARY, "topk_fused", codes, queries, l_k,
                       block_n, active, pack)
    _build.count(hamming_topk_fused)
    return out


hamming_topk_fused.launches = 0


def _launch_scan(library: str, prefix: str, codes, queries, l_k: int,
                 block_n: int, active, pack: str):
    """Check the inputs of a block-local scan kernel, allocate its outputs
    and launch ``<prefix>_launch`` from ``csrc/<library>.cu``; raises on
    anything the kernel does not take and on a failed launch."""
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    g, n, w = codes.shape
    b = queries.shape[1]
    for name, t, shape in (("codes", codes, (g, n, w)),
                           ("queries", queries, (g, b, w)),
                           ("active", active, (n,))):
        if t is None:
            continue
        if (t.device != codes.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor of "
                             f"shape {shape} on {codes.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= l_k <= block_n:
        raise ValueError(f"need 1 <= l_k <= block_n, got {l_k}, {block_n}")
    d_dtype, i_dtype, d_sent = cand_encoding(pack, w, block_n)
    grid = -(-n // block_n)
    out_d = torch.empty((g, grid, b, l_k), dtype=d_dtype, device=codes.device)
    out_i = torch.empty((g, grid, b, l_k), dtype=i_dtype, device=codes.device)
    if out_d.numel() == 0:
        return out_d, out_i
    lib = _build.load(library, _SIGNATURES[library])
    if not getattr(lib, f"{prefix}_fits")(w, block_n):
        raise ValueError(f"W = {w} at block_n = {block_n} needs more shared "
                         f"memory than one block may use")
    with torch.cuda.device(codes.device):
        err = getattr(lib, f"{prefix}_launch")(
            codes.data_ptr(), queries.data_ptr(),
            None if active is None else active.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), g, n, w, b, l_k, block_n,
            grid, _PACK_CODE[pack], d_sent,
            torch.cuda.current_stream(codes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{library} launch failed: CUDA error {err}")
    return out_d, out_i


def hamming_distance_plain(codes, query):
    """(n,) int32 distances between packed rows codes (n, W) int32 and one
    packed query (W,) int32."""
    return hamming_packed(codes, query[None, :])


def hamming_distance_batch_plain(codes, queries):
    """(B, n) int32 distances between packed rows codes (n, W) int32 and B
    packed queries (B, W) int32: row b is query b's distances."""
    return hamming_packed(codes[None, :, :], queries[:, None, :])


def hamming_distance(codes, query):
    """(n,) int32 Hamming distances of codes (n, W) int32 to query (W,)
    int32; any n.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``hamming_distance.launches``) or raises.
    """
    if codes.device.type == "cpu":
        return hamming_distance_plain(codes, query)
    out = _launch_distances("distance_launch", codes, query[None, :])
    _build.count(hamming_distance)
    return out[0]


hamming_distance.launches = 0


def hamming_distance_batch(codes, queries):
    """(B, n) int32 Hamming distances of codes (n, W) int32 to queries
    (B, W) int32, row b for query b; any n and B.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``hamming_distance_batch.launches``) or
    raises.
    """
    if codes.device.type == "cpu":
        return hamming_distance_batch_plain(codes, queries)
    out = _launch_distances("distance_batch_launch", codes, queries)
    _build.count(hamming_distance_batch)
    return out


hamming_distance_batch.launches = 0


def _launch_distances(fn: str, codes, queries):
    """Check the inputs of a distance kernel, allocate its (B, n) output
    and launch ``fn`` from ``csrc/hamming_distance.cu``; raises on anything
    the kernel does not take and on a failed launch."""
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    n, w = codes.shape
    b = queries.shape[0]
    for name, t, shape in (("codes", codes, (n, w)),
                           ("queries", queries, (b, w))):
        if (t.device != codes.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor of "
                             f"shape {shape} on {codes.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((b, n), dtype=torch.int32, device=codes.device)
    if out.numel() == 0:
        return out
    lib = _build.load(DISTANCE_LIBRARY, _SIGNATURES[DISTANCE_LIBRARY])
    if not lib.distance_fits(w):
        raise ValueError(f"W = {w} words per query needs more shared memory "
                         f"than one block may use")
    args = [codes.data_ptr(), queries.data_ptr(), out.data_ptr(), n, w]
    if fn == "distance_batch_launch":
        args.append(b)
    with torch.cuda.device(codes.device):
        err = getattr(lib, fn)(
            *args, torch.cuda.current_stream(codes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{DISTANCE_LIBRARY} launch failed: CUDA error "
                           f"{err}")
    return out
