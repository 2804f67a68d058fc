"""Device-side Hamming search and exact-margin re-rank: the single-device
scan and the row-sharded scan over a mesh.

Plain PyTorch: the single-device functions run on whatever device their
tensors live on and launch no hand-written kernel (the fused scan kernels
are reached through ``repro_torch.kernels.ops``), but for the exact
re-rank's margins, which a CUDA tensor takes from kernel 11
(``kernels.margins``).  ``merge_topk_shards``
is host numpy: the replicated-shard router (``serving.cluster``) merges
its shards' lists with it.

The row-sharded scan (``hamming_topk_sharded``,
``hamming_topk_grouped_sharded``) splits the packed codes along rows over
the shards of a ``utils.mesh.Mesh``.  One controller (this process) runs
each shard's local scan through ``kernels.ops`` on the shard's device (a
CUDA shard launches the scan kernel, a CPU shard takes its plain
version), and only the shard's top-l (distance, id) pairs, narrowed to
int16 where they fit, are copied to the queries' device: O(l · shards)
per query, independent of n.  There they are widened and merged by
(distance, id), so the answer equals the single-device scan's bit for
bit, ties and l > n sentinels included.  Shards may share a device.

Tie contract shared with the JAX package: top-l by (distance, id)
ascending, ties to the lowest id, impossible slots (l > n, masked rows)
as (DIST_SENTINEL, -1).  ``jax.lax.top_k`` breaks ties to the lowest
index and ``torch.topk`` promises no order, so every selection here is a
stable ``torch.sort`` or a sort on a unique composite key.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core.functions import strict_fp32
from repro_torch.kernels.margins import row_margins
from repro_torch.utils.bits import from_numpy_u32, hamming_packed
from repro_torch.utils.mesh import shard_count

# Fill distance for masked rows and impossible top-k slots (l > n): far
# above any real Hamming distance (<= 32·W) but negatable in int32.  The
# kernels' wrappers (kernels.hamming) share it.
DIST_SENTINEL = 0x3FFFFFFF


def env_fused_select(select: str | None = None) -> str:
    """Resolve the fused-scan selection algorithm: ``"hist"`` (default,
    counting-sort select) or ``"argmin"`` (the legacy selection).  Explicit
    arguments win; otherwise ``REPRO_FUSED_SELECT`` moves the default.
    Both give bit-identical results."""
    if select is not None:
        if select not in ("hist", "argmin"):
            raise ValueError(f"fused_select must be 'hist' or 'argmin', "
                             f"got {select!r}")
        return select
    env = os.environ.get("REPRO_FUSED_SELECT", "").strip().lower()
    return env if env in ("hist", "argmin") else "hist"


def env_cand_pack(pack: str | None = None) -> str:
    """Resolve the fused-scan candidate emission width: ``"16"`` (default,
    int16 pairs), ``"8"`` (uint8 distances + int16 ids, only while
    32·W < 255) or ``"none"`` (int32).  Explicit arguments win; otherwise
    ``REPRO_CAND_PACK`` moves the default.  Every pack is bit-identical
    after the widening merge."""
    if pack is not None:
        if pack not in ("none", "16", "8"):
            raise ValueError(f"cand_pack must be 'none', '16' or '8', "
                             f"got {pack!r}")
        return pack
    env = os.environ.get("REPRO_CAND_PACK", "").strip().lower()
    return env if env in ("none", "16", "8") else "16"


def _pad_topk(dists: torch.Tensor, ids: torch.Tensor, l: int):
    """Pad the trailing top-k axis out to l slots with (DIST_SENTINEL, -1)."""
    have = dists.shape[-1]
    if have >= l:
        return dists, ids
    pad = (0, l - have)
    return (torch.nn.functional.pad(dists, pad, value=DIST_SENTINEL),
            torch.nn.functional.pad(ids, pad, value=-1))


def lex_smallest(dists: torch.Tensor, ids: torch.Tensor, l: int):
    """The l smallest (distance, id) pairs along the last axis, sorted
    lexicographically.  dists in [0, DIST_SENTINEL], ids in [-1, 2^31):
    one int64 key (distance high, id + 1 low) makes the order total, so
    equal keys are equal pairs and the sort's own tie order is moot."""
    key = (dists.to(torch.int64) << 32) | (ids.to(torch.int64) + 1)
    key = torch.sort(key, dim=-1).values[..., :l]
    return (key >> 32).to(torch.int32), ((key & 0xFFFFFFFF) - 1).to(
        torch.int32)


def hamming_topk(codes, query, l: int):
    """Single-table scan: smallest-distance top-l of one query.

    codes: (n, W) int32; query: (W,) int32 -> (dists (l,), ids (l,)) int32,
    ties to the lowest id; when l > n the tail slots carry
    (DIST_SENTINEL, -1), matching the kernel path (kernels.ops.hamming_topk).
    """
    d, i = hamming_topk_batch(codes, query[None, :], l)
    return d[0], i[0]


def hamming_topk_batch(codes, queries, l: int):
    """Batched single-table scan: top-l per query in one pass.

    codes: (n, W) int32; queries: (B, W) int32 -> (dists (B, l),
    ids (B, l)); l > n tails are (DIST_SENTINEL, -1).
    """
    d, i = _grouped_topk_lax(codes[None], queries[None], l)
    return d[0], i[0]


def hamming_topk_grouped(codes, queries, l: int, select: str | None = None,
                         active=None, pack: str | None = None):
    """Grouped scan, plain PyTorch: group g's queries vs group g's codes.

    codes (G, n, W) int32, queries (G, B, W) int32 -> (dists (G, B, l),
    ids (G, B, l)) int32, sorted ascending by (distance, id); tails past
    the live rows carry (DIST_SENTINEL, -1).  active: optional (n,) bool
    liveness shared by all groups.  pack is accepted for call-site
    symmetry with the kernel path and ignored (no block emission here).
    """
    del pack
    if env_fused_select(select) == "hist":
        return hamming_topk_grouped_hist(codes, queries, l, active)
    return _grouped_topk_lax(codes, queries, l, active)


def _masked_distances(codes, queries, active):
    d = hamming_packed(codes[:, None, :, :], queries[:, :, None, :])  # G,B,n
    if active is not None:
        d = torch.where(active.to(torch.bool)[None, None, :], d,
                        DIST_SENTINEL)
    return d


def _grouped_topk_lax(codes, queries, l: int, active=None):
    """Legacy grouped selection: full distance matrix + stable sort (the
    port of the lax.top_k path; ties to the lowest index)."""
    n = codes.shape[1]
    d = _masked_distances(codes, queries, active)
    d, idx = torch.sort(d, dim=-1, stable=True)
    d, idx = d[..., :min(l, n)], idx[..., :min(l, n)].to(torch.int32)
    d, i = _pad_topk(d, idx, l)
    if active is not None:
        i = torch.where(d >= DIST_SENTINEL, -1, i)
    return d, i


def hamming_topk_grouped_hist(codes, queries, l: int, active=None):
    """Plain reference of the two-pass histogram (counting-sort) select,
    over the whole row axis at once: bisect the distance CDF to the
    per-query cutoff radius r, keep rows with d < r plus the lowest-index
    ties at r, and lex-sort only those min(l, n) survivors."""
    g, n, w = codes.shape
    b = queries.shape[1]
    dev = codes.device
    d = _masked_distances(codes, queries, active)
    t = min(l, n)
    max_dist = 32 * w
    lo = torch.zeros((g, b, 1), dtype=torch.int32, device=dev)
    hi = torch.full((g, b, 1), max_dist, dtype=torch.int32, device=dev)
    for _ in range(max(1, max_dist.bit_length())):
        mid = (lo + hi) >> 1
        ge = (d <= mid).sum(dim=2, keepdim=True) >= t
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    r = hi
    less = (d < r).sum(dim=2, keepdim=True)
    tie = d == r
    tie_rank = torch.cumsum(tie, dim=2) - 1
    keep = (d < r) | (tie & (tie_rank < (t - less)))
    # slot in [0, t) for kept rows (row order); t is the discard slot
    slot = torch.where(keep, torch.cumsum(keep, dim=2) - 1, t)
    ids = torch.arange(n, dtype=torch.int32, device=dev).expand(g, b, n)
    out_d = torch.full((g, b, t + 1), DIST_SENTINEL, dtype=torch.int32,
                       device=dev)
    out_i = torch.full((g, b, t + 1), -1, dtype=torch.int32, device=dev)
    out_d.scatter_(2, slot, d)
    out_i.scatter_(2, slot, ids)
    out_d, out_i = out_d[..., :t], out_i[..., :t]
    # rows that were never filled keep (DIST_SENTINEL, -1)
    out_d, out_i = lex_smallest(out_d, out_i, t)
    return _pad_topk(out_d, out_i, l)


def merge_topk_segments(d_a, i_a, d_b, i_b, l: int):
    """Lexicographic (distance, id) merge of two per-(group, query) top-k
    lists, each sorted that way with (DIST_SENTINEL, -1) in impossible
    slots and ids in one id space (the caller offsets segment-local ids
    first).  Returns the combined top-l: what one scan over the
    concatenated segments gives, since real distances never reach
    DIST_SENTINEL."""
    d = torch.cat([d_a, d_b], dim=-1)
    i = torch.cat([i_a, i_b], dim=-1)
    return _pad_topk(*lex_smallest(d, i, l), l)


def drop_tombstones_topk(dists, ids, active, l: int):
    """Filter lex-sorted candidate lists down to their top-l LIVE entries.

    active: (n_seg,) bool over the segment's local id space; False rows
    (tombstones, padding past the segment's length) become
    (DIST_SENTINEL, -1) and sort last.  The slack contract: the input must
    be at least ``l + (#inactive rows)`` deep (or cover the whole segment)
    for the result to equal the top-l of the live rows alone: at most
    #inactive of the scanned slots can be dead, so l live candidates
    survive and they are exactly the live top-l.
    """
    last = active.shape[0] - 1
    ok = (ids >= 0) & active.to(torch.bool)[torch.clamp(ids, 0, last).long()]
    d = torch.where(ok, dists, DIST_SENTINEL)
    i = torch.where(ok, ids, -1)
    return _pad_topk(*lex_smallest(d, i, l), l)


# -- the row-sharded scan ---------------------------------------------------
#
# What crosses from a shard to the merge is bounded like a kernel block's
# emission: distances <= 32·W and SHARD-LOCAL ids (< shard rows), the
# global offset restored after the gather from the shard's position.
# int16 halves the bytes; the widening restores the identical int32
# values, so the merge and its tie order are unchanged bit for bit.
_SENT16 = 0x7FFF      # kernels.hamming.CAND_SENTINELS["16"]


def _narrow_gather(cd, ci, pack: str, w: int, rows: int):
    """Narrow one shard's (…, l) candidate lists for the gather: sentinel
    distances clamp to the int16 sentinel, -1 ids survive the cast.
    Returns (cd, ci, packed_d, packed_i); either stays int32 when its
    values do not fit (32·W >= the int16 sentinel, or shard rows past the
    int16 id range) or pack is "none"."""
    pack_d = pack != "none" and 32 * w < _SENT16
    pack_i = pack != "none" and rows - 1 <= _SENT16
    if pack_d:
        cd = torch.clamp(cd, max=_SENT16).to(torch.int16)
    if pack_i:
        ci = ci.to(torch.int16)
    return cd, ci, pack_d, pack_i


def _widen_gather(all_d, all_i, pack_d: bool, pack_i: bool, rows: int):
    """Undo ``_narrow_gather`` on the gathered (S, …) lists: widen to
    int32, map the int16 sentinel back to DIST_SENTINEL, and add each
    shard's global row offset (its position × shard rows) to the
    non-sentinel ids."""
    if pack_d:
        all_d = all_d.to(torch.int32)
        all_d = torch.where(all_d == _SENT16, DIST_SENTINEL, all_d)
    if pack_i:
        all_i = all_i.to(torch.int32)
    shape = (all_i.shape[0],) + (1,) * (all_i.dim() - 1)
    offsets = (torch.arange(all_i.shape[0], dtype=torch.int32,
                            device=all_i.device) * rows).view(shape)
    return all_d, torch.where(all_i < 0, -1, all_i + offsets)


def shard_rows(codes, mesh, axis: str = "data") -> tuple:
    """The per-shard layout of packed codes: the row axis (the second to
    last) zero-padded to a multiple of the shard count, split into the
    shards' contiguous row ranges, each placed on its shard's device.
    codes: a host uint32 array (padded and split host-side, so only each
    shard's range crosses to its device) or an int32 tensor."""
    shards = shard_count(mesh, axis)
    rows_dim = codes.ndim - 2
    pad = -codes.shape[rows_dim] % shards
    if torch.is_tensor(codes):
        if pad:
            codes = torch.nn.functional.pad(codes, (0, 0, 0, pad))
        return tuple(part.to(dev).contiguous() for part, dev in zip(
            torch.chunk(codes, shards, dim=rows_dim), mesh.devices))
    if pad:
        widths = [(0, 0)] * codes.ndim
        widths[rows_dim] = (0, pad)
        codes = np.pad(codes, widths)
    return tuple(from_numpy_u32(part, dev) for part, dev in zip(
        np.split(codes, shards, axis=rows_dim), mesh.devices))


def _gather(parts, dev):
    """Stack per-shard tensors on dev; a copy to a card is asynchronous."""
    return torch.stack([p.to(dev, non_blocking=dev.type == "cuda")
                        for p in parts])


def hamming_topk_sharded(codes, query, l: int, mesh, axis: str = "data",
                         select: str | None = None, pack: str | None = None):
    """Top-l Hamming scan of one query over a row-sharded code table.

    codes: (n, W) int32, n a multiple of the shard count (as under the JAX
    package's ``shard_map``); query: (W,).  The grouped scan below with one
    group and one query: each shard's ``ops.hamming_topk`` launch on its
    device, the (S, l) candidates merged by (distance, id) on the query's
    device.  Returns (dists (l,), ids (l,)) int32 with global ids: ties to
    the lowest global id, l > n slots (DIST_SENTINEL, -1), as
    ``ops.hamming_topk`` gives on one device.
    """
    shards = shard_count(mesh, axis)
    if codes.shape[0] % shards:
        raise ValueError(f"{codes.shape[0]} code rows do not divide the "
                         f"{shards} shards of mesh axis {axis!r}")
    d, i = hamming_topk_grouped_sharded(codes[None], query[None, None], l,
                                        mesh, axis, select=select, pack=pack)
    return d[0, 0], i[0, 0]


def hamming_topk_grouped_sharded(codes, queries, l: int, mesh,
                                 axis: str = "data",
                                 n_valid: int | None = None,
                                 select: str | None = None,
                                 pack: str | None = None):
    """Grouped top-l scan over row-sharded codes: the multi-table
    counterpart of ``hamming_topk_sharded``.

    codes: (G, n, W) int32, split along rows here (n need not divide the
    shard count: zero rows pad it), or the per-shard layout of
    ``shard_rows`` that the serving paths cache, so that no call splits or
    uploads again.  queries: (G, B, W) int32 on the device that gathers
    and merges (the index's).  n_valid: the true row count (default n, or
    every row of a per-shard layout); rows past it count as padding.
    Returns (dists (G, B, l), ids (G, B, l)) int32 with global ids,
    bit-identical to the single-device ``ops.hamming_topk_grouped``, tie
    order and l > n_valid sentinels included.

    Each shard runs ONE ``ops.hamming_topk_grouped`` launch for all G
    groups and B queries at depth l_local = l plus the padding rows one
    shard can see (the padding is a contiguous tail, so the extra slots
    keep it from crowding a real global top-l row out of a shard's list);
    padding rows then become sentinels, and only the (S, G, B, l_local)
    pairs cross to the merge, which sorts them by (distance, id).
    """
    from repro_torch.kernels import ops
    select, pack = env_fused_select(select), env_cand_pack(pack)
    shards = shard_count(mesh, axis)
    if torch.is_tensor(codes):
        n = codes.shape[1]
        codes = shard_rows(codes, mesh, axis)
    else:
        if len(codes) != shards:
            raise ValueError(f"{len(codes)} code shards for a mesh axis of "
                             f"{shards}")
        n = sum(part.shape[1] for part in codes)
    rows, w = codes[0].shape[1], codes[0].shape[2]
    if any(part.shape[1] != rows for part in codes):
        raise ValueError("code shards must hold equal row counts")
    n_pad = rows * shards
    n_valid = n if n_valid is None else int(n_valid)
    l_local = l + min(n_pad - n_valid, rows)
    local = []
    for s, part in enumerate(codes):
        cd, ci = ops.hamming_topk_grouped(part, queries.to(part.device),
                                          l_local, select=select, pack=pack)
        # rows past the true table end become sentinels before the gather
        pad_row = (ci >= 0) & (ci + s * rows >= n_valid)
        cd = torch.where(pad_row, DIST_SENTINEL, cd)
        ci = torch.where(pad_row, -1, ci)
        local.append(_narrow_gather(cd, ci, pack, w, rows))
    out = queries.device
    all_d = _gather([c[0] for c in local], out)       # (S, G, B, l_local)
    all_i = _gather([c[1] for c in local], out)
    all_d, all_i = _widen_gather(all_d, all_i, local[0][2], local[0][3],
                                 rows)
    g, b = queries.shape[0], queries.shape[1]
    all_d = all_d.permute(1, 2, 0, 3).reshape(g, b, -1)
    all_i = all_i.permute(1, 2, 0, 3).reshape(g, b, -1)
    return lex_smallest(all_d, all_i, l)


# -- the cutoff exchange over row-sharded features ---------------------------
#
# An index whose feature rows are sharded too (``MultiTableIndex.
# fit_sharded``) cannot gather every shard's top-l to one card and send the
# winners back for the re-rank.  Each shard instead sends the histogram of
# its rows' distances (32·W + 1 bins a query; ``kernels.shard_select``);
# their sum gives each query's cutoff distance D and how many rows at D
# the global top-l takes.  Shards hold contiguous row ranges and ties go
# to the lowest id, so shard s takes all its rows below D and its first
# max(0, r - sum_{t<s} count_t(D)) rows at D: the single-device top-l
# set, split by shard.


def cutoff_exchange(hists, t: int):
    """The shards' share of each (group, query)'s top-t by (distance, id),
    from their histograms hists (S, G, B, bins) int64, shard s holding the
    s-th contiguous range of rows: (cut (G, B) int32, the distance D the
    top-t reaches; take (S, G, B) int64, the rows at D shard s gives, its
    lowest ones; counts (S, G, B) int64, the rows shard s gives in all).
    Needs 1 <= t <= the rows the histograms count."""
    total = hists.sum(0)
    cum = torch.cumsum(total, -1)
    cut = torch.clamp((cum < t).sum(-1, keepdim=True),
                      max=hists.shape[-1] - 1)
    need = t - (cum.gather(-1, cut) - total.gather(-1, cut))
    at = cut.expand(hists.shape[:-1] + (1,))
    eq = hists.gather(-1, at)
    take = torch.clamp(torch.minimum(need - (torch.cumsum(eq, 0) - eq), eq),
                       min=0)
    below = torch.cumsum(hists, -1).gather(-1, at) - eq
    return (cut[..., 0].to(torch.int32), take[..., 0],
            (below + take)[..., 0])


def _margins(x, w_batch, rows, valid, delta=None, split=None):
    """The (B, C) margins |w.x| / ||w|| of the candidate rows, +inf at
    invalid slots: ``kernels.margins.row_margins`` (kernel 11 on a CUDA
    tensor, its plain multiply + reduce on the CPU; a row's margin does
    not depend on the batch or the slots around it).  delta / split: the
    two-segment row space of the LSM index."""
    return row_margins(x, w_batch.contiguous(),
                       rows.to(torch.int64).contiguous(),
                       valid.contiguous(), delta=delta, split=split)


def margin_rerank(x, w, candidates, l: int):
    """Exact re-rank of one candidate list by margin |w.x| / ||w||.

    x: (n, d) database; w: (d,) normal; candidates: (c,) int ids.  Returns
    (margins (l,), ids (l,)) ascending by margin, ties to the lowest
    candidate position (``jax.lax.top_k``'s order).
    """
    with strict_fp32():
        m = torch.abs(x[candidates] @ w)
    m = m / torch.clamp(torch.linalg.vector_norm(w), min=1e-12)
    m, sel = torch.sort(m, stable=True)
    k = min(l, candidates.shape[0])
    return m[:k], candidates[sel[:k]]


def margin_rerank_batch(x, w_batch, candidates, valid, l: int):
    """Batched exact re-rank: (margins (B, l), ids (B, l)) ascending by
    margin, ties to the lowest candidate position; invalid slots rank last
    with margin +inf and keep their padded id."""
    m = _margins(x, w_batch, candidates, valid)
    m, sel = torch.sort(m, dim=1, stable=True)
    sel = sel[:, :min(l, candidates.shape[1])]
    return m[:, :sel.shape[1]], torch.gather(candidates, 1, sel)


def margin_rerank_segmented(base_x, delta_x, split: int, w_batch,
                            candidates, valid, l: int):
    """``margin_rerank_batch`` over the LSM index's two-segment row space
    (``kernels.margins._segmented_rows``): equal to it on the concatenation
    [base_x[:split]; delta_x[:rows - split]], since the gathered rows and
    the margin expression are the same."""
    m = _margins(base_x, w_batch, candidates, valid, delta_x, split)
    m, sel = torch.sort(m, dim=1, stable=True)
    sel = sel[:, :min(l, candidates.shape[1])]
    return m[:, :sel.shape[1]], torch.gather(candidates, 1, sel)


def margin_batch_segmented(base_x, delta_x, split: int, w_batch, candidates,
                           valid):
    """``margin_batch`` over the two-segment row space: (B, C) float32,
    +inf at invalid slots."""
    return _margins(base_x, w_batch, candidates, valid, delta_x, split)


def margin_batch(x, w_batch, candidates, valid):
    """Per-candidate exact margins with no selection: (B, C) float32,
    +inf at invalid slots (candidates there may be -1: no row is read
    for them)."""
    return _margins(x, w_batch, candidates, valid)


def merge_topk_shards(dists: list, ids: list, l: int):
    """Host-side lexicographic (dist, id) merge of per-shard top-l lists.

    dists / ids: equal-length lists of (..., l_s) numpy arrays, one per
    covered shard, each sorted ascending by (distance, id) with
    (DIST_SENTINEL, -1) in impossible slots; ids already GLOBAL.  Returns
    (dists (..., l) int32, ids (..., l) int64): the top-l a single scan over
    the union of the shards' rows gives.  Real distances never reach
    DIST_SENTINEL, so sentinels sort last, and equal distances resolve to
    the lowest global id.  Any row of the covered rows' top-l is in its own
    shard's top-l, which is why merging lists (not answers) is exact.
    """
    d = np.concatenate([np.asarray(a, dtype=np.int64) for a in dists],
                       axis=-1)
    i = np.concatenate([np.asarray(a, dtype=np.int64) for a in ids],
                       axis=-1)
    # one composite key per slot: the distance in the high bits, id + 1 in
    # the low 32 (sentinel slots carry id -1 -> 0), so one stable argsort
    # realises the (dist, id) order
    order = np.argsort((d << 32) | (i + 1), axis=-1, kind="stable")
    d = np.take_along_axis(d, order, axis=-1)[..., :l]
    i = np.take_along_axis(i, order, axis=-1)[..., :l]
    have = d.shape[-1]
    if have < l:
        pad = [(0, 0)] * (d.ndim - 1) + [(0, l - have)]
        d = np.pad(d, pad, constant_values=DIST_SENTINEL)
        i = np.pad(i, pad, constant_values=-1)
    return d.astype(np.int32), i
