// The single-pass block-local select shared by the fused Hamming scans
// (hamming_topk_hist.cu: kernels 2 and 3, row order; hamming_topk_fused.cu:
// kernel 5, (distance, row) order).
//
// For one (group, row block of block_n rows) and a chunk of at most
// kQueries of the group's queries, a block of kThreads threads
// (kernel 3: A as its own slab_distances, B-E by a warp group of a larger
// block on its own barrier)
//
//   A. computes every (row, query) distance exactly once (stage_distances):
//      each thread XORs 4 rows' code words, loaded once, against the
//      chunk's queries, read from shared memory as broadcasts; the
//      distances land in a shared [query][row] tile of U units, each unit 4
//      entries of kBits bits (bytes while 32 W + 1 < 255, i.e. W <= 7, else
//      16 bits).  Unit c * 32 + lane holds the rows c * 128 + 32 k + lane,
//      k = 0..3, so a warp walking the units reads 32 consecutive rows per
//      entry k, in row order.  A dead row (past n, past block_n, or
//      active == 0) holds the all-ones entry, above every distance;
//   B. splits the 8 warps over the chunk's queries (a query gets 8 / the
//      next power of two of the chunk's size warps, each a contiguous
//      segment of the row block) and builds each warp's histogram of its
//      segment from the tile: one 16-bit counter per (bin, lane), bumped by
//      an atomic add whose result nothing waits for and which no other
//      lane's counter shares; the 32 copies then sum to the segment's bins.
//      Wide codes, whose 32 copies of 32 W + 2 bins do not fit beside the
//      tile (W >= 13 at block_n >= 2048), take the second instantiation
//      (kWide): one 32-bit counter per (bin, warp), bumped by a shared
//      atomicAdd, which is the segment's bins itself.  The counts, and so
//      everything after them, are the same;
//   C. sums the segments' bins to the query's histogram, finds the cutoff
//      r (the smallest distance whose running count reaches t = min(l,
//      live rows)), less = count(d < r) and need = t - less, and places
//      each segment by the bins of the segments before it;
//   D. walks the segment's entries once more, reading distances, not
//      recomputing them, and writes the kept rows' ids (d < r, and the
//      ties at r whose rank over the whole block is below need) to a shared
//      list in row order: a kept row's slot is the rows below r before it
//      plus its tie rank, at most need.  The eight ballots of a unit are
//      independent of each other, and the next unit's load is in flight;
//   E. emits the list:
//      - row order (kernels 2, 3): the query's warps write the t slots
//        together, coalesced;
//      - distance order (kernel 5): a stable counting sort of the t rows.
//        Bin d <= r starts at the exclusive prefix of the histogram; a row
//        goes to its bin's running slot plus its rank among the equal
//        distances of its 32 rows (__match_any_sync), and the group's
//        highest lane advances the bin: t / 32 steps, not block_n / 32.
//
// Slots past t carry (pack sentinel, sentinel id): block_n - 1 in row
// order, 0 in distance order, as the plain versions and the TPU kernels.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace hsel {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQueries = 8;             // the largest query chunk
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr size_t kMaxSmem = 232448;     // 227 KB per block on sm_90

// The threads of one select: a whole block of kThreads (kernels 2 and 5),
// or one warp group of kThreads in a larger block (kernel 3), which waits
// on its own named barrier (1 + its index; barrier 0 is __syncthreads').
struct WholeBlock {
  __device__ __forceinline__ int warp() const { return threadIdx.x >> 5; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

struct WarpGroup {
  int index;
  __device__ __forceinline__ int warp() const {
    return (threadIdx.x >> 5) % kWarps;
  }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(index + 1), "n"(kThreads)
                 : "memory");
  }
};

// Entries of the distance tile are bytes while every distance and the
// dead marker 0xFF fit apart.
__host__ __device__ inline bool byte_entries(int w) {
  return 32 * w + 1 < 0xFF;
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Offsets of a block's shared memory, after `head` bytes the caller keeps
// for itself: the distance tile [bq][n_units] of unit_bytes each, the
// segments' bins [kWarps][bins] int, the chunk's queries [bq][w] uint32,
// the kept rows [bq][l_k] uint16 and the per-lane counters
// [kWarps][bins][16] uint32 (two lanes' 16-bit counters a word), or with
// wide codes [kWarps][bins] uint32 (the distance-order emission's running
// slots; the counters are the segments' bins).
struct Layout {
  size_t tile, seg, qs, ids, hist, total;
};

__host__ __device__ inline Layout layout(int w, int block_n, int bq, int l_k,
                                         size_t head, bool wide) {
  const size_t n_units = static_cast<size_t>((block_n + 127) / 128) * 32;
  const size_t unit_bytes = byte_entries(w) ? 4 : 8;
  const size_t bins = 32 * static_cast<size_t>(w) + 2;
  Layout s;
  s.tile = align16(head);
  s.seg = align16(s.tile + bq * n_units * unit_bytes);
  s.qs = align16(s.seg + kWarps * bins * 4);
  s.ids = align16(s.qs + bq * static_cast<size_t>(w) * 4);
  s.hist = align16(s.ids + bq * static_cast<size_t>(l_k) * 2);
  s.total = s.hist + kWarps * bins * (wide ? 4 : 32 * 2);
  return s;
}

// The largest query chunk (8, 4, 2 or 1) whose block fits; 0 if none does
// (and for a block_n whose rows a 16-bit kept-row id cannot name).
inline int chunk_queries(int w, int block_n, int l_k, size_t head,
                         bool wide) {
  if (block_n > 0x10000) return 0;
  for (int bq = kQueries; bq >= 1; bq >>= 1) {
    if (layout(w, block_n, bq, l_k, head, wide).total <= kMaxSmem) return bq;
  }
  return 0;
}

// The select of a launch: the lane-private counters while a chunk of one
// query fits with them (every shape with byte entries, W <= 7), else the
// wide counters.  Returns (wide, query chunk); chunk 0 if neither fits.
struct Select {
  bool wide;
  int bq;
};

inline Select choose_select(int w, int block_n, int l_k, size_t head) {
  const int bq = chunk_queries(w, block_n, l_k, head, false);
  if (bq > 0 || byte_entries(w)) return {false, bq};
  return {true, chunk_queries(w, block_n, l_k, head, true)};
}

// Entry k of a unit: the distance of row c * 128 + 32 k + lane.
template <typename U, int kBits>
__device__ __forceinline__ int entry(U u, int k) {
  return static_cast<int>((u >> (k * kBits)) & ((U(1) << kBits) - 1));
}

// A. Distances of the row block's rows to the chunk's nqc queries (qs,
// [nqc][w] in shared memory) into tile ([nqc][n_units]), for the 128-row
// chunks [c_lo, c_hi).  Row r's word j is codes[(r - r_off) * rs + j * ws];
// base is the block's first global row.  A thread takes the chunks
// c = c_lo + warp + kWarps i; with one word per code it issues the loads of
// four chunks before it uses any, so their latencies overlap.
template <typename U, int kBits>
__device__ __forceinline__ void stage_distances(
    U* tile, const uint32_t* qs, int nqc, const uint32_t* codes, int rs,
    int ws, int w, const int32_t* __restrict__ active, int64_t base, int n,
    int block_n, int n_units, int c_lo, int c_hi, int r_off) {
  constexpr U kDeadEntry = (U(1) << kBits) - 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // row r of unit c is live: inside the block, below n, active
  auto row_in = [&](int c, int k) {
    const int r = c * 128 + 32 * k + lane;
    return c < c_hi && r < block_n && base + r < n;
  };
  auto is_dead = [&](int c, int k) {
    return !row_in(c, k) ||
           (active != nullptr && active[base + c * 128 + 32 * k + lane] == 0);
  };
  auto store = [&](int c, int b, const int* d, unsigned dead) {
    U u = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      u |= (((dead >> k) & 1u) ? kDeadEntry : static_cast<U>(d[k]))
           << (k * kBits);
    }
    tile[b * n_units + c * 32 + lane] = u;
  };
  if (w == 1) {
    for (int c0 = c_lo + warp; c0 < c_hi; c0 += 4 * kWarps) {
      uint32_t x[4][4];
      unsigned dead[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + i * kWarps;
        dead[i] = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          x[i][k] = row_in(c, k) ? codes[static_cast<int64_t>(
                                       c * 128 + 32 * k + lane - r_off) * rs]
                                 : 0u;
          if (is_dead(c, k)) dead[i] |= 1u << k;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + i * kWarps;
        if (c >= c_hi) break;
        for (int b = 0; b < nqc; ++b) {
          const uint32_t q = qs[b];
          int d[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) d[k] = __popc(x[i][k] ^ q);
          store(c, b, d, dead[i]);
        }
      }
    }
    return;
  }
  for (int c = c_lo + warp; c < c_hi; c += kWarps) {
    int acc[kQueries][4];
    unsigned dead = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (is_dead(c, k)) dead |= 1u << k;
#pragma unroll
      for (int b = 0; b < kQueries; ++b) acc[b][k] = 0;
    }
    for (int j = 0; j < w; ++j) {
      uint32_t x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[k] = row_in(c, k) ? codes[static_cast<int64_t>(
                                  c * 128 + 32 * k + lane - r_off) * rs +
                              static_cast<int64_t>(j) * ws]
                            : 0u;
      }
#pragma unroll
      for (int b = 0; b < kQueries; ++b) {
        if (b < nqc) {
          const uint32_t q = qs[b * w + j];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[b][k] += __popc(x[k] ^ q);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kQueries; ++b) {
      if (b < nqc) store(c, b, acc[b], dead);
    }
  }
}

// B-E for the chunk whose first query's output starts at obase0
// (((g * grid_n + blk) * nq + b0) * l_k).  Every thread of the block (or
// of the warp group grp) calls it (it holds their barriers); the caller
// syncs before reusing the shared memory.
template <bool kDistOrder, typename U, int kBits, bool kWide, typename DT,
          typename IT, typename Grp = WholeBlock>
__device__ __forceinline__ void select_chunk(
    const U* tile, int* seg_all, uint16_t* ids_all, uint32_t* hist_all,
    int nqc, int n_units, int w, int l_k, int block_n,
    DT* __restrict__ out_d, IT* __restrict__ out_i, int64_t obase0,
    int d_sent, Grp grp = Grp{}) {
  const int lane = threadIdx.x & 31;
  const int warp = grp.warp();
  const unsigned below = (1u << lane) - 1u;
  int qp2 = 1;
  while (qp2 < nqc) qp2 <<= 1;
  const int spq = kWarps / qp2;            // segments (warps) per query
  const int j = warp / spq, s = warp % spq;
  const bool mine = j < nqc;
  const int n_chunks = n_units / 32;
  const int c0 = s * n_chunks / spq, c1 = (s + 1) * n_chunks / spq;
  const int max_dist = 32 * w, bins = max_dist + 2;
  uint32_t* h = hist_all + static_cast<size_t>(warp) * bins * (kWide ? 1 : 16);
  const U* tq = tile + static_cast<size_t>(j) * n_units;
  uint16_t* ids = ids_all + static_cast<size_t>(j) * l_k;
  const int* segq = seg_all + j * spq * bins;

  // B. this segment's histogram: lane L counts in half L / 16 of word
  // L % 16 of each bin, a fire-and-forget atomic that no other lane's
  // counter shares; wide codes count straight into the segment's bins
  if (mine && kWide) {
    int* hc = seg_all + warp * bins;
    for (int i = lane; i < bins; i += 32) hc[i] = 0;
    __syncwarp();
    for (int c = c0; c < c1; ++c) {
      const U u = tq[c * 32 + lane];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        atomicAdd(&hc[min(entry<U, kBits>(u, k), max_dist + 1)], 1);
      }
    }
  } else if (mine) {
    for (int i = lane; i < bins * 16; i += 32) h[i] = 0u;
    __syncwarp();
    const uint32_t inc = 1u << (16 * (lane >> 4));
    for (int c = c0; c < c1; ++c) {
      const U u = tq[c * 32 + lane];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        atomicAdd(&h[min(entry<U, kBits>(u, k), max_dist + 1) * 16 +
                     (lane & 15)], inc);
      }
    }
    __syncwarp();
    for (int b = lane; b < bins; b += 32) {
      const uint32_t* col = h + b * 16;
      int sum = 0;
      for (int i = 0; i < 16; ++i) {
        const uint32_t v = col[(i + lane) & 15];
        sum += static_cast<int>((v & 0xFFFFu) + (v >> 16));
      }
      seg_all[warp * bins + b] = sum;
    }
  }
  grp.sync();

  // C. the query's cutoff from its segments' bins; D. this segment's kept
  // rows into ids, in row order
  int t = 0, r_cut = max_dist;
  if (mine) {
    int live = 0;
    for (int b = lane; b <= max_dist; b += 32) {
      for (int i = 0; i < spq; ++i) live += segq[i * bins + b];
    }
    t = min(l_k, __reduce_add_sync(kFull, live));
  }
  if (mine && t > 0) {
    int less = 0, carry = 0;
    for (int v0 = 0; v0 <= max_dist; v0 += 32) {
      const int v = v0 + lane;
      int c = 0;
      if (v <= max_dist) {
        for (int i = 0; i < spq; ++i) c += segq[i * bins + v];
      }
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const unsigned hit = __ballot_sync(kFull, carry + incl >= t);
      if (hit) {
        const int f = __ffs(hit) - 1;
        r_cut = v0 + f;
        less = carry + __shfl_sync(kFull, incl - c, f);
        break;
      }
      carry += __shfl_sync(kFull, incl, 31);
    }
    const int need = t - less;
    // the rows below r and the ties at r before this segment and in it
    int lt = 0, my_lt = 0;
    for (int b = lane; b < r_cut; b += 32) {
      for (int i = 0; i < s; ++i) lt += segq[i * bins + b];
      my_lt += segq[s * bins + b];
    }
    lt = __reduce_add_sync(kFull, lt);
    my_lt = __reduce_add_sync(kFull, my_lt);
    int ties = 0;
    for (int i = 0; i < s; ++i) ties += segq[i * bins + r_cut];
    const int end =
        lt + my_lt + min(ties + segq[s * bins + r_cut], need);
    // a kept row's slot: the rows below r before it plus the ties at r
    // before it, at most need; the ballots of a unit's four entries are
    // independent, and the next unit's load is in flight
    U next = c0 < c1 ? tq[c0 * 32 + lane] : U(0);
    for (int c = c0; c < c1 && lt + min(ties, need) < end; ++c) {
      const U u = next;
      if (c + 1 < c1) next = tq[(c + 1) * 32 + lane];
      int e[4];
      unsigned lt_b[4], tie_b[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        e[k] = entry<U, kBits>(u, k);
        lt_b[k] = __ballot_sync(kFull, e[k] < r_cut);
        tie_b[k] = __ballot_sync(kFull, e[k] == r_cut);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int lb = lt + __popc(lt_b[k] & below);
        const int tb = ties + __popc(tie_b[k] & below);
        if (e[k] < r_cut || (e[k] == r_cut && tb < need)) {
          ids[lb + min(tb, need)] = static_cast<uint16_t>(c * 128 + 32 * k + lane);
        }
        lt += __popc(lt_b[k]);
        ties += __popc(tie_b[k]);
      }
    }
  }
  grp.sync();
  if (!mine) return;

  // E. the query's t kept rows, in row order in ids, to the output
  const int64_t obase = obase0 + static_cast<int64_t>(j) * l_k;
  auto dist = [&](int row) {
    return entry<U, kBits>(tq[(row >> 7) * 32 + (row & 31)], (row >> 5) & 3);
  };
  if constexpr (!kDistOrder) {
    // row order: the segments' warps write the slots together, coalesced
    for (int i = s * 32 + lane; i < t; i += spq * 32) {
      const int row = ids[i];
      out_d[obase + i] = static_cast<DT>(dist(row));
      out_i[obase + i] = static_cast<IT>(row);
    }
  } else if (s == 0 && t > 0) {
    // (distance, row) order: a stable counting sort of the t rows.  Bin
    // d <= r starts at the exclusive prefix of the query's histogram; a
    // row goes to its bin's running slot plus its rank among the equal
    // distances of its 32 rows, and the group's highest lane advances the
    // bin.  This warp's counters are spent, so the running slots live there.
    int* start = reinterpret_cast<int*>(h);
    int carry = 0;
    for (int v0 = 0; v0 <= r_cut; v0 += 32) {
      const int v = v0 + lane;
      int c = 0;
      if (v <= r_cut) {
        for (int i = 0; i < spq; ++i) c += segq[i * bins + v];
      }
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (v <= r_cut) start[v] = carry + incl - c;
      carry += __shfl_sync(kFull, incl, 31);
    }
    __syncwarp();
    for (int i0 = 0; i0 < t; i0 += 32) {
      const int i = i0 + lane;
      const unsigned valid = __ballot_sync(kFull, i < t);
      int d = 0, slot = 0;
      unsigned peers = 0u;
      if (i < t) {
        const int row = ids[i];
        d = dist(row);
        peers = __match_any_sync(valid, d);
        slot = start[d] + __popc(peers & below);
        out_d[obase + slot] = static_cast<DT>(d);
        out_i[obase + slot] = static_cast<IT>(row);
      }
      __syncwarp();
      if (i < t && (peers >> lane) == 1u) start[d] = slot + 1;
      __syncwarp();
    }
  }
  if (s == 0) {
    const IT sent_id = static_cast<IT>(kDistOrder ? 0 : block_n - 1);
    for (int i = t + lane; i < l_k; i += 32) {
      out_d[obase + i] = static_cast<DT>(d_sent);
      out_i[obase + i] = sent_id;
    }
  }
}

// A whole block of topk_hist_kernel / topk_fused_kernel: block (group g,
// row block, query chunk), chunk fastest so that the chunks of one row
// block read its codes close together in time.
template <bool kDistOrder, typename U, int kBits, bool kWide, typename DT,
          typename IT>
__device__ __forceinline__ void scan_block(
    unsigned char* smem, const uint32_t* __restrict__ codes,
    const uint32_t* __restrict__ queries, const int32_t* __restrict__ active,
    DT* __restrict__ out_d, IT* __restrict__ out_i, int n, int w, int nq,
    int l_k, int block_n, int grid_n, int bq, int d_sent) {
  const int n_qc = (nq + bq - 1) / bq;
  const int qc = blockIdx.x % n_qc;
  const int blk = (blockIdx.x / n_qc) % grid_n;
  const int g = blockIdx.x / (n_qc * grid_n);
  const Layout lay = layout(w, block_n, bq, l_k, 0, kWide);
  U* tile = reinterpret_cast<U*>(smem + lay.tile);
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + lay.qs);
  const int n_units = (block_n + 127) / 128 * 32;
  const int b0 = qc * bq;
  const int nqc = min(bq, nq - b0);
  const int64_t base = static_cast<int64_t>(blk) * block_n;
  for (int i = threadIdx.x; i < nqc * w; i += kThreads) {
    qs[i] = queries[(static_cast<int64_t>(g) * nq + b0) * w + i];
  }
  __syncthreads();
  stage_distances<U, kBits>(
      tile, qs, nqc, codes + (static_cast<int64_t>(g) * n + base) * w, w, 1,
      w, active, base, n, block_n, n_units, 0, n_units / 32, 0);
  __syncthreads();
  select_chunk<kDistOrder, U, kBits, kWide>(
      tile, reinterpret_cast<int*>(smem + lay.seg),
      reinterpret_cast<uint16_t*>(smem + lay.ids),
      reinterpret_cast<uint32_t*>(smem + lay.hist), nqc, n_units, w, l_k,
      block_n, out_d, out_i,
      ((static_cast<int64_t>(g) * grid_n + blk) * nq + b0) * l_k, d_sent);
}

// The number of scan_block blocks of a launch (0 if it exceeds a grid).
inline unsigned scan_blocks(int groups, int grid_n, int nq, int bq) {
  const int64_t blocks =
      static_cast<int64_t>(groups) * grid_n * ((nq + bq - 1) / bq);
  return blocks > 0x7FFFFFFF ? 0u : static_cast<unsigned>(blocks);
}

// The shape of a scan_block launch (topk_hist_kernel, topk_fused_kernel):
// its select, dynamic shared memory and blocks; bq or blocks 0 where the
// launch is refused.
struct ScanShape {
  Select sel;
  size_t smem;
  unsigned blocks;
};

inline ScanShape scan_shape(int groups, int w, int nq, int l_k, int block_n,
                            int grid_n) {
  ScanShape s{};
  s.sel = choose_select(w, block_n, l_k, 0);
  if (s.sel.bq == 0) return s;
  s.smem = layout(w, block_n, s.sel.bq, l_k, 0, s.sel.wide).total;
  s.blocks = scan_blocks(groups, grid_n, nq, s.sel.bq);
  return s;
}

template <typename T>
struct Tag {
  using type = T;
};

// Calls f(Tag<U>, integral_constant<kBits>, integral_constant<kWide>,
// Tag<DT>, Tag<IT>) with the distance tile's unit (bytes for W <= 7, else
// 16-bit entries), the select's counters (wide only with 16-bit entries)
// and the pack's (distance, id) types: 0 int32/int32, 1 int16/int16, 2
// uint8/int16.  Returns f's cudaError_t, or cudaErrorInvalidValue for an
// unknown pack or wide counters with byte entries.
template <typename F>
int dispatch(int pack, int w, bool wide, F&& f) {
  using Narrow = std::integral_constant<bool, false>;
  using Wide = std::integral_constant<bool, true>;
  auto entries = [&](auto dt, auto it) -> int {
    if (byte_entries(w)) {
      if (wide) return static_cast<int>(cudaErrorInvalidValue);
      return f(Tag<uint32_t>{}, std::integral_constant<int, 8>{}, Narrow{},
               dt, it);
    }
    using U16 = Tag<unsigned long long>;
    using B16 = std::integral_constant<int, 16>;
    if (wide) return f(U16{}, B16{}, Wide{}, dt, it);
    return f(U16{}, B16{}, Narrow{}, dt, it);
  };
  switch (pack) {
    case 0: return entries(Tag<int32_t>{}, Tag<int32_t>{});
    case 1: return entries(Tag<int16_t>{}, Tag<int16_t>{});
    case 2: return entries(Tag<uint8_t>{}, Tag<int16_t>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace hsel
