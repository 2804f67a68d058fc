"""Fused Hamming scan + histogram top-l select: the CUDA kernel's wrapper,
its launch count and its plain PyTorch version.

For each (group, row block) and each of the group's B queries: the exact
block-local smallest-t set of (distance, row) pairs, t = min(l, live rows
in the block), ties to the lowest row, in row order; slots past t carry
(pack sentinel, block_n - 1).  The kernel (csrc/hamming_topk_hist.cu)
replaces the TPU kernel ``hamming_topk_hist_kernel`` with dma=False
(src/repro/kernels/hamming.py:429); the merge that turns block-local
candidates into the global top-l lives in ``kernels.ops``.
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
_SIGNATURES = {
    "topk_hist_fits": (ctypes.c_int, [ctypes.c_int] * 2),
    "topk_hist_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                         + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
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


def hamming_topk_hist_plain(codes, queries, l_k: int, block_n: int,
                            active=None, pack: str = "none"):
    """Plain version of the kernel, all blocks at once: the per-block
    distance tile, bisection of its CDF to the cutoff r, the tie-rank
    cumsum, then each kept row's slot.  Same arguments and outputs as
    ``hamming_topk_hist``."""
    g, n, w = codes.shape
    b = queries.shape[1]
    d_dtype, i_dtype, d_sent = cand_encoding(pack, w, block_n)
    dev = codes.device
    grid = -(-n // block_n)
    n_pad = grid * block_n
    codes_p = torch.nn.functional.pad(codes, (0, 0, 0, n_pad - n))
    live = torch.arange(n_pad, device=dev) < n
    if active is not None:
        live &= torch.nn.functional.pad(active.to(torch.int32),
                                        (0, n_pad - n)) > 0
    live = live.view(grid, block_n)
    dist = hamming_packed(codes_p.view(g, grid, 1, block_n, w),
                          queries.view(g, 1, b, 1, w))    # (g, grid, b, bn)
    dist = torch.where(live[None, :, None, :], dist, DIST_SENTINEL)
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
    """Block-local fused scan + select over G stacked code groups.

    codes: (G, n, W) int32 (uint32 bits); queries: (G, B, W) int32; active:
    optional (n,) int32 liveness shared by all groups (0 = dead row);
    1 <= l_k <= block_n.  Returns (dists, ids), each (G, ceil(n/block_n),
    B, l_k) in the pack's dtypes (``cand_encoding``), ids block-local.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``hamming_topk_hist.launches``) or raises.
    """
    if codes.device.type == "cpu":
        return hamming_topk_hist_plain(codes, queries, l_k, block_n, active,
                                       pack)
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
    lib = _build.load(LIBRARY, _SIGNATURES)
    if not lib.topk_hist_fits(w, block_n):
        raise ValueError(f"W = {w} at block_n = {block_n} needs more shared "
                         f"memory than one block may use")
    with torch.cuda.device(codes.device):
        err = lib.topk_hist_launch(
            codes.data_ptr(), queries.data_ptr(),
            None if active is None else active.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), g, n, w, b, l_k, block_n,
            grid, _PACK_CODE[pack], d_sent,
            torch.cuda.current_stream(codes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hamming_topk_hist launch failed: CUDA error "
                           f"{err}")
    hamming_topk_hist.launches += 1
    return out_d, out_i


hamming_topk_hist.launches = 0
