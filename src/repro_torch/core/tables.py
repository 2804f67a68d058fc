"""Single-table, multi-probe hash index (paper §4, query procedure).

The paper's compact regime: one table keyed by k <= ~32 bit codes; a
hyperplane query w is answered by (1) hashing w query-side (which embeds the
sign flip, equivalently the bitwise-NOT of its database-style code), (2)
probing all buckets within a small Hamming radius of that key, (3) re-ranking
the short candidate list by the exact margin |w.x|/||w||.

Host-side (numpy + dict) by design: bucket maps are pointer-chasing
structures that belong on the host CPU of each serving node, while the
scan/re-rank math runs on the accelerator (see core/search.py and
kernels/hamming.py for the device-side path).

Beyond the seed version this table is *dynamic* (``insert`` / ``delete`` keep
a growing labeled pool indexed without rebuilds, see serving/multi_table.py)
and the probe radius *escalates* when the fixed-radius ball is candidate-
starved (``min_candidates``): compact codes concentrate mass near the query
key, but an unlucky query can land in a sparse region where radius-3 holds
only a handful of points — expanding ring by ring until a minimum candidate
count is reached restores re-rank quality without touching the common case.
"""
from __future__ import annotations

from functools import lru_cache
from itertools import combinations

import numpy as np


def keys_of(packed: np.ndarray) -> np.ndarray:
    """Packed uint32 rows (n, W) -> (n,) uint64 bucket keys
    (key = word0 | word1 << 32).

    Requires W <= 2 (k <= 64 bits — always true in the paper's compact
    regime, which targets k <= ~32).
    """
    packed = np.asarray(packed)
    if packed.shape[-1] > 2:
        raise ValueError("keys_of supports k <= 64 bits (W <= 2)")
    keys = packed[..., 0].astype(np.uint64)
    if packed.shape[-1] == 2:
        keys |= packed[..., 1].astype(np.uint64) << np.uint64(32)
    return keys


@lru_cache(maxsize=64)
def probe_masks(k: int, radius: int) -> np.ndarray:
    """XOR masks for every key within Hamming distance `radius` of a key over
    k bits, ring by ring (nondecreasing distance) — mask 0 first.

    ``key ^ masks`` enumerates the same probes as `hamming_ball_keys(key)`,
    but as one vectorized XOR; batched query paths broadcast it over many
    keys at once (serving/batch_query.py).  Cached per (k, radius) — the
    enumeration is pure-python and identical across calls; treat the
    returned array as read-only.
    """
    masks = [0]
    for r in range(1, radius + 1):
        for bits in combinations(range(k), r):
            m = 0
            for b in bits:
                m |= 1 << b
            masks.append(m)
    return np.asarray(masks, dtype=np.uint64)


def popcount_u64(x: np.ndarray) -> np.ndarray:
    """SWAR popcount for uint64 arrays (host-side sibling of bits.popcount_u32)."""
    x = x.astype(np.uint64)
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = ((x & np.uint64(0x3333333333333333))
         + ((x >> np.uint64(2)) & np.uint64(0x3333333333333333)))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(
        np.int64)


def hamming_ball_keys(key: int, k: int, radius: int):
    """All keys within Hamming distance `radius` of `key` over k bits,
    in nondecreasing distance order (ring by ring)."""
    yield key
    for r in range(1, radius + 1):
        for bits in combinations(range(k), r):
            probe = key
            for b in bits:
                probe ^= (1 << b)
            yield probe


class SingleHashTable:
    """Bucketed single hash table over packed codes, with dynamic rows.

    Bucket values are int64 id arrays.  Ids are stable: ``insert`` assigns
    fresh ids past the current maximum, ``delete`` removes ids from their
    bucket without renumbering survivors.
    """

    def __init__(self, packed: np.ndarray, k: int,
                 ids: np.ndarray | None = None):
        """ids: optional (n,) stable ids the bucket values carry instead of
        the default 0..n-1 row numbering — a refresh shadow index rebuilds
        its tables for rows whose ids were assigned long ago."""
        packed = np.asarray(packed)
        assert packed.ndim == 2
        if packed.shape[1] > 2:
            raise ValueError(
                f"SingleHashTable keys cover the paper's compact regime only "
                f"(k <= 64 bits); got k={k}.  Use the device-side scan path "
                f"(core.search / query_scan) for wider codes.")
        self.k = int(k)
        self.n = packed.shape[0]
        if ids is not None:
            ids = np.asarray(ids, dtype=np.int64)
            assert ids.shape == (self.n,)
        self._next_id = (self.n if ids is None
                         else int(ids.max()) + 1 if self.n else 0)
        self.buckets: dict[int, np.ndarray] = {}
        # id -> bucket key reverse map, built lazily on first insert/delete
        # so fit-only callers keep the fully vectorized constructor
        self._id_key: dict[int, int] | None = None
        self._bkeys: np.ndarray | None = None   # cached bucket-key array
        if self.n:       # an empty table (e.g. full-churn compaction) has
            keys = keys_of(packed)        # no buckets to build
            order = np.argsort(keys, kind="stable")
            sorted_keys = keys[order]
            starts = np.flatnonzero(
                np.r_[True, sorted_keys[1:] != sorted_keys[:-1]])
            bounds = np.r_[starts, self.n]
            vals = order if ids is None else ids[order]
            for s, e in zip(bounds[:-1], bounds[1:]):
                self.buckets[int(sorted_keys[s])] = vals[s:e].astype(np.int64)

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    # -- dynamic updates -----------------------------------------------------

    def _ensure_id_key(self) -> dict[int, int]:
        if self._id_key is None:
            self._id_key = {int(i): key
                            for key, ids in self.buckets.items() for i in ids}
        return self._id_key

    def insert(self, packed: np.ndarray, ids: np.ndarray | None = None
               ) -> np.ndarray:
        """Add rows; returns the ids assigned (fresh unless given)."""
        packed = np.atleast_2d(np.asarray(packed))
        m = packed.shape[0]
        if m == 0:
            return np.empty((0,), dtype=np.int64)
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
        else:
            ids = np.asarray(ids, dtype=np.int64)
            assert ids.shape == (m,)
        id_key = self._ensure_id_key()
        # validate the whole batch first — a mid-batch raise must not leave
        # the table partially mutated
        ids_int = [int(i) for i in ids]
        dupes = [i for i in ids_int if i in id_key]
        if dupes or len(set(ids_int)) != len(ids_int):
            raise ValueError(f"duplicate ids in insert: {dupes or ids_int}")
        keys = keys_of(packed)
        for key_u, i in zip(keys, ids):
            key, i = int(key_u), int(i)
            old = self.buckets.get(key)
            self.buckets[key] = (np.asarray([i], np.int64) if old is None
                                 else np.append(old, i))
            id_key[i] = key
        self.n += m
        self._next_id = max(self._next_id, int(ids.max()) + 1)
        self._bkeys = None
        return ids

    def delete(self, ids) -> None:
        """Remove rows by id.  Unknown ids raise (before any mutation)."""
        id_key = self._ensure_id_key()
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        unknown = [int(i) for i in ids if int(i) not in id_key]
        if unknown:
            raise KeyError(f"delete of unknown ids: {unknown}")
        if np.unique(ids).size != ids.size:
            raise KeyError("duplicate ids in delete")
        for i in ids:
            i = int(i)
            key = id_key.pop(i)
            bucket = self.buckets[key]
            kept = bucket[bucket != i]
            if kept.size:
                self.buckets[key] = kept
            else:
                del self.buckets[key]
            self.n -= 1
        self._bkeys = None

    # -- lookup --------------------------------------------------------------

    def lookup(self, query_packed: np.ndarray, radius: int,
               max_candidates: int | None = None,
               min_candidates: int | None = None) -> np.ndarray:
        """Candidate ids within `radius` of the query key, nearest rings
        first.  With ``min_candidates``, the radius escalates past `radius`
        (still ring by ring) until that many candidates are gathered or the
        table is exhausted.  Empty result => the paper falls back to random
        selection (handled by the caller)."""
        key = int(keys_of(np.asarray(query_packed).reshape(1, -1))[0])
        return self._collect(key, radius, max_candidates, min_candidates)

    def lookup_many(self, keys: np.ndarray, radius: int,
                    max_candidates: int | None = None,
                    min_candidates: int | None = None) -> list[np.ndarray]:
        """Batched lookup for precomputed uint64 query keys (B,).

        The probe keys for the whole batch come from one broadcast XOR with
        `probe_masks`; the per-probe dict hits remain host work.  Semantics
        per query are identical to `lookup`."""
        keys = np.asarray(keys, dtype=np.uint64).reshape(-1)
        masks = probe_masks(self.k, radius)
        probes = keys[:, None] ^ masks[None, :]        # (B, P), ring order
        out = []
        for b in range(keys.shape[0]):
            out.append(self._collect(int(keys[b]), radius, max_candidates,
                                     min_candidates, probes=probes[b]))
        return out

    def _collect(self, key: int, radius: int, max_candidates, min_candidates,
                 probes=None) -> np.ndarray:
        if probes is None:
            probes = hamming_ball_keys(key, self.k, radius)
        elif isinstance(probes, np.ndarray):
            probes = probes.tolist()    # bulk python-int conversion
        out: list[np.ndarray] = []
        count = 0
        for probe in probes:
            hit = self.buckets.get(probe)
            if hit is not None:
                out.append(hit)
                count += len(hit)
                if max_candidates is not None and count >= max_candidates:
                    break
        if min_candidates is not None and count < min_candidates \
                and count < self.n:
            return self._collect_escalated(key, max_candidates, min_candidates)
        if not out:
            return np.empty((0,), dtype=np.int64)
        cand = np.concatenate(out)
        return cand if max_candidates is None else cand[:max_candidates]

    def _collect_escalated(self, key: int, max_candidates,
                           min_candidates) -> np.ndarray:
        """Radius escalation via one vectorized scan over the *bucket keys*
        (cheap: #buckets <= n, and only triggered on starved queries).
        Buckets are consumed in nondecreasing key distance, matching the
        ring-by-ring order of the fast path."""
        if self._bkeys is None:
            self._bkeys = np.fromiter(self.buckets.keys(), dtype=np.uint64,
                                      count=len(self.buckets))
        bkeys = self._bkeys
        dist = popcount_u64(bkeys ^ np.uint64(key))
        # (dist, key) order: deterministic regardless of the insert/delete
        # history that produced the bucket dict.
        order = np.lexsort((bkeys, dist))
        out, count = [], 0
        for bi in order:
            hit = self.buckets[int(bkeys[bi])]
            out.append(hit)
            count += len(hit)
            if count >= min_candidates:
                break
            if max_candidates is not None and count >= max_candidates:
                break
        cand = np.concatenate(out) if out else np.empty((0,), dtype=np.int64)
        return cand if max_candidates is None else cand[:max_candidates]

    def stats(self) -> dict:
        sizes = np.array([len(v) for v in self.buckets.values()])
        return {
            "n": self.n, "k": self.k, "buckets": len(self.buckets),
            "max_bucket": int(sizes.max()) if sizes.size else 0,
            "mean_bucket": float(sizes.mean()) if sizes.size else 0.0,
        }
