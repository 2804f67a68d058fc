"""One shard's part of the cutoff exchange
(``MultiTableIndex._scan_sharded_rows``): the CUDA kernels' wrappers
(csrc/shard_select.cu), their launch counts and their plain PyTorch
versions.

A shard holds rows [0, R) of a contiguous range, the first n_valid of
them real.  Against its copy of the queries it gives:

- ``shard_histogram(codes, queries, n_valid)``: (hist (G, B, bins) int64,
  blocks (G, B, nblk, bins) int32), bins = 32 W + 1: each (group,
  query)'s count of every distance over the valid rows, and the same per
  row block of BLOCK_ROWS rows (nblk = ceil(n_valid / BLOCK_ROWS)).  The
  shards' hists cross to the index's device; ``core.search.
  cutoff_exchange`` turns their sum into each query's cutoff D and the
  rows at D each shard gives (take).
- ``shard_select(codes, queries, n_valid, blocks, cut, take, width)``:
  (G, B, width) int32, each (group, query)'s rows with distance < D, and
  its first ``take`` rows at D in row order, ascending; R in the slots
  past their count.  ``blocks`` is what ``shard_histogram`` gave.

Both take codes (G, R, W) and queries (G, B, W), int32 carrying uint32
bits, contiguous on one device.  A CPU tensor takes the plain version; a
CUDA tensor launches the kernels (``shard_histogram.launches`` counts the
histogram pass, ``shard_select.launches`` the offsets and the select, 2 a
call) or raises.  The JAX package's sharded scan runs its Pallas
``hamming_topk_hist_kernel`` on each shard and merges the shards' top-l
on one device; these kernels are that histogram select, split at the
exchange (see the .cu file).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.utils.bits import hamming_packed

LIBRARY = "shard_select"
BLOCK_ROWS = 4096        # rows a block of both passes takes (kBlockRows)
SCAN_BLOCK = 4096        # rows a block of the plain running count sums
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "shard_hist_launch": (_I, [_P] * 4 + [_I] * 5 + [_P]),
    "shard_select_launch": (_I, [_P] * 7 + [_I] * 6 + [_P]),
    "shard_select_plan": (_I, [_I] * 6 + [_P]),
}


def row_blocks(n_valid: int) -> int:
    """The row blocks of a pass over n_valid rows."""
    return -(-n_valid // BLOCK_ROWS)


# -- plain versions -----------------------------------------------------------

def distances(codes, queries, n_valid: int) -> torch.Tensor:
    """(G, B, n_valid) int32 distances of the first n_valid rows of codes
    (G, R, W) to queries (G, B, W)."""
    return hamming_packed(codes[:, None, :n_valid, :], queries[:, :, None, :])


def block_histogram(d: torch.Tensor, bins: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(hist, blocks) of distances d (G, B, n): one ``torch.bincount`` of
    (group, query, row block, distance)."""
    g, b, n = d.shape
    nblk = row_blocks(n)
    blk = torch.arange(n, device=d.device) // BLOCK_ROWS
    key = ((torch.arange(g * b, device=d.device).view(g, b, 1) * nblk + blk)
           * bins + d)
    blocks = torch.bincount(key.reshape(-1), minlength=g * b * nblk * bins)
    blocks = blocks.view(g, b, nblk, bins)
    return blocks.sum(2), blocks.to(torch.int32)


def running_count(mask: torch.Tensor) -> torch.Tensor:
    """The inclusive running count along the last axis of a bool (..., R)
    tensor, int32, over R rounded up to a multiple of SCAN_BLOCK (the
    count stays at its total past R): within blocks, then over the blocks'
    totals."""
    r = mask.shape[-1]
    padded = torch.zeros(mask.shape[:-1] + (r + -r % SCAN_BLOCK,),
                         dtype=torch.bool, device=mask.device)
    padded[..., :r] = mask
    within = torch.cumsum(padded.view(mask.shape[:-1] + (-1, SCAN_BLOCK)),
                          -1, dtype=torch.int32)
    total = within[..., -1]
    within += (torch.cumsum(total, -1, dtype=torch.int32) - total)[..., None]
    return within.view(padded.shape)


def select_rows(d: torch.Tensor, cut, take, width: int, rows: int
                ) -> torch.Tensor:
    """(G, B, width) int32: the rows of distances d (G, B, n) with d < cut,
    then the first ``take`` with d == cut, ascending; ``rows`` in the slots
    past their count.  cut (G, B) int32; take (G, B) int64.  The k-th
    selected row is the first whose running count of selected rows
    reaches k (``torch.searchsorted``)."""
    g, b, n = d.shape
    if n == 0:
        return torch.full((g, b, width), rows, dtype=torch.int32,
                          device=d.device)
    c = cut[..., None]
    eq = d == c
    room = take.to(torch.int32)[..., None]
    sel = eq & (running_count(eq)[..., :n] <= room)
    sel |= d < c
    want = torch.arange(1, width + 1, dtype=torch.int32,
                        device=d.device).expand(g, b, width).contiguous()
    got = torch.searchsorted(running_count(sel), want, out_int32=True)
    return torch.where(got < n, got, rows)


def shard_histogram_plain(codes, queries, n_valid: int):
    return block_histogram(distances(codes, queries, n_valid),
                           32 * codes.shape[-1] + 1)


def shard_select_plain(codes, queries, n_valid: int, blocks, cut, take,
                       width: int) -> torch.Tensor:
    return select_rows(distances(codes, queries, n_valid), cut, take, width,
                       codes.shape[1])


# -- the kernels --------------------------------------------------------------

def _check(codes, queries, n_valid: int) -> tuple[int, int, int, int]:
    if codes.dim() != 3 or queries.dim() != 3:
        raise ValueError(f"codes (G, R, W) and queries (G, B, W), got "
                         f"{tuple(codes.shape)} and {tuple(queries.shape)}")
    g, rows, w = codes.shape
    b = queries.shape[1]
    for name, t, shape in (("codes", codes, (g, rows, w)),
                           ("queries", queries, (g, b, w))):
        if (t.device != codes.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor of "
                             f"shape {shape} on {codes.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not 0 <= n_valid <= rows:
        raise ValueError(f"n_valid {n_valid} outside [0, {rows}]")
    return g, rows, w, b


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def shard_histogram(codes, queries, n_valid: int):
    """(hist (G, B, bins) int64, blocks (G, B, nblk, bins) int32) of one
    shard; see the module docstring."""
    if codes.device.type == "cpu":
        return shard_histogram_plain(codes, queries, n_valid)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    g, rows, w, b = _check(codes, queries, n_valid)
    bins, nblk = 32 * w + 1, row_blocks(n_valid)
    dev = codes.device
    hist = torch.zeros((g, b, bins), dtype=torch.int64, device=dev)
    blocks = torch.empty((g, b, nblk, bins), dtype=torch.int32, device=dev)
    if n_valid == 0 or b == 0:
        return hist, blocks
    lib = _build.load(LIBRARY, _SIGNATURES)
    with torch.cuda.device(dev):
        _raise_on(lib.shard_hist_launch(
            codes.data_ptr(), queries.data_ptr(), blocks.data_ptr(),
            hist.data_ptr(), g, rows, n_valid, w, b,
            torch.cuda.current_stream(dev).cuda_stream), "shard_hist")
    _build.count(shard_histogram)
    return hist, blocks


def shard_select(codes, queries, n_valid: int, blocks, cut, take,
                 width: int) -> torch.Tensor:
    """(G, B, width) int32 rows of one shard's share of the top-l; see the
    module docstring.  cut (G, B) int32 and take (G, B) int64 on the
    shard's device."""
    if codes.device.type == "cpu":
        return shard_select_plain(codes, queries, n_valid, blocks, cut, take,
                                  width)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    g, rows, w, b = _check(codes, queries, n_valid)
    dev = codes.device
    for name, t, dtype, shape in (
            ("blocks", blocks, torch.int32,
             (g, b, row_blocks(n_valid), 32 * w + 1)),
            ("cut", cut, torch.int32, (g, b)),
            ("take", take, torch.int64, (g, b))):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    out = torch.empty((g, b, width), dtype=torch.int32, device=dev)
    if width == 0 or b == 0:
        return out
    if n_valid == 0:
        return out.fill_(rows)
    offs = torch.empty((g, b, row_blocks(n_valid), 2), dtype=torch.int32,
                       device=dev)
    lib = _build.load(LIBRARY, _SIGNATURES)
    with torch.cuda.device(dev):
        _raise_on(lib.shard_select_launch(
            codes.data_ptr(), queries.data_ptr(), blocks.data_ptr(),
            cut.data_ptr(), take.data_ptr(), offs.data_ptr(), out.data_ptr(),
            g, rows, n_valid, w, b, width,
            torch.cuda.current_stream(dev).cuda_stream), "shard_select")
    _build.count(shard_select, n=2)
    return out


shard_histogram.launches = 0
shard_select.launches = 0
