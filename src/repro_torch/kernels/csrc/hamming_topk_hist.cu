// Fused Hamming scan + histogram top-l select over G stacked code groups,
// in two kernels with one contract.
//
// topk_hist_kernel replaces the TPU kernel hamming_topk_hist_kernel with
// dma=False (src/repro/kernels/hamming.py:429, pallas_call at :475; bodies
// _topk_hist_kernel :354, _popcount_tile :261, _hist_select :271,
// _pack_cand :345, cand_encoding :83).  topk_hist_dma_kernel replaces the
// same function with dma=True (pallas_call at :496; body
// _topk_hist_dma_kernel :375), whose code tiles stream through a
// double-buffered HBM -> VMEM async copy.
//
// For each (group g, row block of block_n rows) and each of the group's B
// queries both emit the exact block-local smallest-t set, t = min(l, live
// rows in the block), ties to the lowest row, as (distance, block-local
// row) pairs in ROW order; slots past t carry (pack sentinel, block_n - 1).
// Rows >= n or with active == 0 never qualify.  The same contract as the
// TPU kernel, so the merge in kernels/ops.py is shared by both kernels and
// by the plain version, and the two kernels' outputs are identical.
//
// What bounds them: G n B W XOR + popcount operations against one read of
// the codes (4 G n W bytes).  At the serving query shape (G = 4, n = 1.06M,
// W = 1, B = 32) that is 1.4e8 popcounts (16 per clock per SM) against
// 17 MB, so the popcount rate bounds them, not the memory.
//
// Design.  The TPU kernel keeps an (block_n, B) int32 distance tile in
// VMEM: 512 KB at block_n = 4096, above the 227 KB a block may have here.
// These kernels keep the distances of a chunk of at most 8 queries instead,
// as bytes (32 KB at block_n = 4096), and select from them in one pass
// (hamming_select.cuh): each (row, query) distance is computed once, the
// histogram needs no atomic that anything waits for, the compaction reads
// distances back from shared memory into a shared list of kept rows, and
// the list goes out in coalesced stores.

// topk_hist_kernel runs one block of 256 threads per (group, row block,
// query chunk), so a scan of B queries has B / 8 times the blocks of one
// per (group, row block), and a chunk smaller than 8 (B = 1) splits its
// rows over the 8 warps.
//
// topk_hist_dma_kernel is the TPU kernel's manual DMA pipeline in
// Hopper's terms.  Persistent blocks, as many as fit on the card at once,
// walk the work items i = blockIdx.x + k gridDim.x in order, as the TPU
// kernel's sequential grid does; an item is one (group, row block) step
// and one pass over its query chunks.
// - A block is up to four warp groups of 256 threads, each with its own
//   distance tile and select memory for one query chunk: as many groups
//   as the 227 KB of shared memory hold beside a ring of code slabs (four
//   at the serving shape W = 1, block_n = 4,096, l = 128, so its 32
//   queries are one pass and a row block's codes are read once; fewer at
//   wide codes, whose items then take more passes).  The groups run their
//   chunks side by side, as kernel 2 runs its chunks in separate blocks;
//   each selects on its own named barrier (hsel::WarpGroup).
// - The step's codes stream through a ring of 2-4 slots, each a slab of
//   `sub` rows x W words (128-row multiples, 8 KB but at least 256 rows),
//   in the rows' own [row][W] order.  Thread 0 issues each slab as one
//   TMA bulk copy (cp.async.bulk) completing on the slot's `full`
//   mbarrier; words before the first and after the last 16-byte boundary
//   (a group's codes start at g n W words, which need not be a multiple
//   of 4) it copies itself before it arrives.  Every warp arrives on the slot's `empty`
//   mbarrier once it has read the slab; thread 0 waits on that and
//   refills the slot with the slab `stages` ahead, so the next item's
//   slabs arrive while this item's selects run.  No block-wide barrier
//   after the start.
// - Each group computes its chunk's distances from every slab while it is
//   resident (each slab is read once per item from device memory;
//   slab_distances), with rows past n skipped and tombstones from `active`
//   applied as in kernel 2.  Then the group selects with
//   hsel::select_chunk, as kernel 2 does (group_select).

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "hamming_select.cuh"
#include "launch_plan.cuh"

namespace {

using hsel::kThreads;

constexpr int kMaxGroups = 4;        // warp groups of a kernel 3 block
constexpr int kMaxStages = 4;        // slots of its code ring
constexpr size_t kSlabCap = 8192;    // bytes of a slab's words, above 256 rows

// Bytes of one ring slot of `sub` rows of w words: 16 more than the words,
// since a slab lands at its first word's offset mod 16 bytes.
__host__ __device__ inline size_t slot_bytes(int w, int sub) {
  return hsel::align16(sizeof(uint32_t) * static_cast<size_t>(w) * sub + 16);
}

// Bytes of the ring's mbarriers (full and empty per slot).
__host__ __device__ inline size_t ring_head(int stages) {
  return hsel::align16(2 * sizeof(uint64_t) * static_cast<size_t>(stages));
}

// The shape of a topk_hist_dma_kernel launch: the select and its query
// chunk (as kernel 2's, with room for the smallest ring), the warp groups,
// the slab rows and the ring's slots; bq == 0 if nothing fits.
struct DmaPlan {
  hsel::Select sel;
  int groups, sub, stages;
  size_t group_bytes, total;
};

inline DmaPlan plan_dma(int w, int block_n, int l_k, int nq) {
  DmaPlan pl{};
  const int rows = (block_n + 127) / 128 * 128;
  const size_t min_ring = ring_head(2) + 2 * slot_bytes(w, 128);
  pl.sel = hsel::choose_select(w, block_n, l_k, min_ring);
  if (pl.sel.bq == 0) return pl;
  pl.group_bytes = hsel::align16(
      hsel::layout(w, block_n, pl.sel.bq, l_k, 0, pl.sel.wide).total);
  const int chunks = (nq + pl.sel.bq - 1) / pl.sel.bq;
  int g = chunks < kMaxGroups ? (chunks > 0 ? chunks : 1) : kMaxGroups;
  while (g > 1 && g * pl.group_bytes + min_ring > hsel::kMaxSmem) --g;
  if (g * pl.group_bytes + min_ring > hsel::kMaxSmem) {
    pl.sel.bq = 0;
    return pl;
  }
  const size_t room = hsel::kMaxSmem - g * pl.group_bytes;
  // slabs of kSlabCap bytes, but at least 256 rows (a 32-row unit for each
  // of a group's 8 warps) and at most the row block, shrunk until two
  // slots fit; then as many slots as fit
  int sub = static_cast<int>(kSlabCap / (sizeof(uint32_t) * w)) / 128 * 128;
  if (sub < 256) sub = 256;
  if (sub > rows) sub = rows;
  while (sub > 128 && ring_head(2) + 2 * slot_bytes(w, sub) > room) {
    sub -= 128;
  }
  int stages = 2;
  while (stages < kMaxStages &&
         ring_head(stages + 1) + (stages + 1) * slot_bytes(w, sub) <= room) {
    ++stages;
  }
  pl.groups = g;
  pl.sub = sub;
  pl.stages = stages;
  pl.total = ring_head(stages) + stages * slot_bytes(w, sub) +
             g * pl.group_bytes;
  if (pl.total > hsel::kMaxSmem) pl.sel.bq = 0;
  return pl;
}

using bulk::bulk_copy;
using bulk::mbar_arrive;
using bulk::mbar_arrive_tx;
using bulk::mbar_init;
using bulk::mbar_wait;

template <typename U, int kBits, bool kWide, typename DT, typename IT>
__global__ void __launch_bounds__(kThreads)
topk_hist_kernel(const uint32_t* __restrict__ codes,
                 const uint32_t* __restrict__ queries,
                 const int32_t* __restrict__ active, DT* __restrict__ out_d,
                 IT* __restrict__ out_i, int n, int w, int nq, int l_k,
                 int block_n, int grid_n, int bq, int d_sent) {
  extern __shared__ __align__(16) unsigned char smem[];
  hsel::scan_block<false, U, kBits, kWide>(smem, codes, queries, active, out_d,
                                    out_i, n, w, nq, l_k, block_n, grid_n,
                                    bq, d_sent);
}

// A for kernel 3: the distances of one slab's rows to the group's nqc
// queries (qs) into its tile.  The slab holds block-local rows
// [r_lo, r_lo + 32 units) (r_lo a multiple of 128) as [row][w] words.
// With at least one 128-row chunk for each of the group's 8 warps, a warp
// takes a chunk at a time, each lane its 4 rows, one tile unit per query
// (as hsel::stage_distances); with fewer (wide codes, whose slabs are
// 256 rows), a warp takes a 32-row unit at a time, one entry per lane and
// query, so the 8 warps still share the slab.  An even w walks each
// lane's words from its own start, (lane w) / 32, so the 32 rows, w words
// apart, meet at most two to a bank.  A row past block_n or n is not
// read; it and a row with active == 0 get the all-ones entry.
template <typename U, int kBits, typename Grp>
__device__ __forceinline__ void slab_distances(
    U* tile, const uint32_t* qs, int nqc, const uint32_t* slab, int w,
    const int32_t* __restrict__ active, int64_t base, int n, int block_n,
    int n_units, int r_lo, int units, Grp grp) {
  using E = typename std::conditional<kBits == 8, uint8_t, uint16_t>::type;
  constexpr int kDead = (1 << kBits) - 1;
  constexpr int kQ = hsel::kQueries;
  const int lane = threadIdx.x & 31;
  const int j0 = (w & 1) ? 0 : (lane * w) >> 5;
  // row r (block-local) is read / is live
  auto row_in = [&](int r) { return r < block_n && base + r < n; };
  auto is_live = [&](int r) {
    return row_in(r) && (active == nullptr || active[base + r] != 0);
  };
  if (units / 4 >= hsel::kWarps) {
    // one code word: the chunk's queries stay in registers
    uint32_t q1[kQ];
#pragma unroll
    for (int b = 0; b < kQ; ++b) q1[b] = w == 1 && b < nqc ? qs[b] : 0u;
    for (int cc = grp.warp(); cc < units / 4; cc += hsel::kWarps) {
      const int c = r_lo / 128 + cc;
      // dead entries are all ones, so OR-ing a distance in keeps them so
      U dead = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!is_live(c * 128 + 32 * k + lane)) dead |= U(kDead) << (k * kBits);
      }
      // the chunk's rows' word j, 4 a lane (0 past block_n or n)
      auto words = [&](uint32_t (&x)[4], int j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          x[k] = row_in(c * 128 + 32 * k + lane)
                     ? slab[static_cast<size_t>(cc * 128 + 32 * k + lane) * w +
                            j]
                     : 0u;
        }
      };
      if (w == 1) {   // no sum over words: each unit straight to the tile
        uint32_t x[4];
        words(x, 0);
#pragma unroll
        for (int b = 0; b < kQ; ++b) {
          if (b < nqc) {
            U u = dead;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              u |= static_cast<U>(__popc(x[k] ^ q1[b])) << (k * kBits);
            }
            tile[b * n_units + c * 32 + lane] = u;
          }
        }
        continue;
      }
      int acc[kQ][4] = {};
      int jr = j0;
      for (int j = 0; j < w; ++j) {
        uint32_t x[4];
        words(x, jr);
#pragma unroll
        for (int b = 0; b < kQ; ++b) {
          if (b < nqc) {
            const uint32_t q = qs[b * w + jr];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[b][k] += __popc(x[k] ^ q);
          }
        }
        jr = jr + 1 == w ? 0 : jr + 1;
      }
#pragma unroll
      for (int b = 0; b < kQ; ++b) {
        if (b < nqc) {
          U u = dead;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            u |= static_cast<U>(acc[b][k]) << (k * kBits);
          }
          tile[b * n_units + c * 32 + lane] = u;
        }
      }
    }
    return;
  }
  E* te = reinterpret_cast<E*>(tile);
  for (int u = grp.warp(); u < units; u += hsel::kWarps) {
    const int r = r_lo + u * 32 + lane;
    int acc[kQ] = {};
    if (row_in(r)) {
      const uint32_t* row = slab + static_cast<size_t>(u * 32 + lane) * w;
      int jr = j0;
      for (int j = 0; j < w; ++j) {
        const uint32_t x = row[jr];
#pragma unroll
        for (int b = 0; b < kQ; ++b) {
          if (b < nqc) acc[b] += __popc(x ^ qs[b * w + jr]);
        }
        jr = jr + 1 == w ? 0 : jr + 1;
      }
    }
    // entry k = (r / 32) % 4 of unit (r / 128) * 32 + r % 32
    const size_t at =
        static_cast<size_t>((r >> 7) * 32 + (r & 31)) * 4 + ((r >> 5) & 3);
    const bool live = is_live(r);
#pragma unroll
    for (int b = 0; b < kQ; ++b) {
      if (b < nqc) {
        te[static_cast<size_t>(b) * n_units * 4 + at] =
            static_cast<E>(live ? acc[b] : kDead);
      }
    }
  }
}

// B-E for kernel 3's group whose select memory starts `head` bytes into
// the block's shared memory: hsel::select_chunk in a function of its own,
// which lays that memory out itself, so that the persistent loop keeps
// little live across it under the 64 registers a 1,024-thread block
// allows (inlined, the loop and the select spilled).
template <typename U, int kBits, bool kWide, typename DT, typename IT>
__device__ __noinline__ void group_select(
    unsigned char* smem, uint32_t head, int nqc, int w, int bq, int l_k,
    int block_n, DT* __restrict__ out_d, IT* __restrict__ out_i,
    int64_t obase0, int d_sent, hsel::WarpGroup grp) {
  const hsel::Layout lay = hsel::layout(w, block_n, bq, l_k, head, kWide);
  hsel::select_chunk<false, U, kBits, kWide>(
      reinterpret_cast<const U*>(smem + lay.tile),
      reinterpret_cast<int*>(smem + lay.seg),
      reinterpret_cast<uint16_t*>(smem + lay.ids),
      reinterpret_cast<uint32_t*>(smem + lay.hist), nqc,
      (block_n + 127) / 128 * 32, w, l_k, block_n, out_d, out_i, obase0,
      d_sent, grp);
}

template <typename U, int kBits, bool kWide, typename DT, typename IT>
__global__ void __launch_bounds__(kMaxGroups * kThreads, 1)
topk_hist_dma_kernel(const uint32_t* __restrict__ codes,
                     const uint32_t* __restrict__ queries,
                     const int32_t* __restrict__ active, DT* __restrict__ out_d,
                     IT* __restrict__ out_i, int n, int w, int nq, int l_k,
                     int block_n, int grid_n, int n_steps, int bq, int sub,
                     int stages, int group_bytes, int d_sent) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = blockDim.x / kThreads;
  const int grp = threadIdx.x / kThreads;
  const int lane = threadIdx.x & 31;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  unsigned char* ring = smem + ring_head(stages);
  const size_t slot = slot_bytes(w, sub);
  const uint32_t head = static_cast<uint32_t>(
      ring_head(stages) + stages * slot +
      static_cast<size_t>(grp) * group_bytes);
  const hsel::Layout lay = hsel::layout(w, block_n, bq, l_k, head, kWide);
  U* tile = reinterpret_cast<U*>(smem + lay.tile);
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + lay.qs);
  const int n_units = (block_n + 127) / 128 * 32;
  const int n_sub = (block_n + sub - 1) / sub;
  const int n_pass = ((nq + bq - 1) / bq + groups - 1) / groups;
  const int n_items = n_steps * n_pass;
  // the launch keeps gridDim.x <= n_items
  const int my_items = (n_items - 1 - blockIdx.x) / gridDim.x + 1;
  const int64_t n_copies = static_cast<int64_t>(my_items) * n_sub;

  // Copy c of this block (slab c % n_sub of its item c / n_sub) into slot
  // c % stages: global words [a, a + len) land at the slot's start plus
  // a % 4 words, so the 16-byte-aligned middle goes by one bulk copy and
  // the words outside it by plain loads; rows past n are not copied.
  auto issue = [&](int64_t c) {
    const int item = blockIdx.x + static_cast<int>(c / n_sub) * gridDim.x;
    const int j = static_cast<int>(c % n_sub);
    const int s = item / n_pass;
    const int64_t r0 = static_cast<int64_t>(s % grid_n) * block_n +
                       static_cast<int64_t>(j) * sub;
    int64_t rows = min(sub, block_n - j * sub);
    if (rows > n - r0) rows = n - r0;
    if (rows < 0) rows = 0;
    const int64_t a = (static_cast<int64_t>(s / grid_n) * n + r0) * w;
    const int64_t end = a + rows * w;
    int64_t lo = (a + 3) & ~int64_t(3), hi = end & ~int64_t(3);
    if (hi <= lo) lo = hi = end;   // no aligned middle: every word by hand
    const int st = static_cast<int>(c % stages);
    uint32_t* dst = reinterpret_cast<uint32_t*>(ring + st * slot) + (a & 3);
    for (int64_t x = a; x < lo; ++x) dst[x - a] = codes[x];
    for (int64_t x = hi; x < end; ++x) dst[x - a] = codes[x];
    if (hi > lo) {
      const uint32_t bytes = static_cast<uint32_t>(hi - lo) * 4u;
      mbar_arrive_tx(full + st, bytes);
      // order the slot's earlier generic-proxy use before the async write
      bulk::fence_proxy_async();
      bulk_copy(dst + (lo - a), codes + lo, bytes, full + st);
    } else {
      mbar_arrive(full + st);
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, groups * hsel::kWarps);
    }
    bulk::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int64_t c = 0; c < stages && c < n_copies; ++c) issue(c);
  }
  const hsel::WarpGroup gsync{grp};
  int64_t c = 0;   // slabs consumed
  for (int k = 0; k < my_items; ++k) {
    const int item = blockIdx.x + k * gridDim.x;
    const int s = item / n_pass;
    const int g = s / grid_n, blk = s % grid_n;
    const int64_t base = static_cast<int64_t>(blk) * block_n;
    const int b0 = ((item % n_pass) * groups + grp) * bq;
    const int nqc = min(bq, nq - b0);   // <= 0: this group idles this pass
    for (int i = threadIdx.x % kThreads; i < nqc * w; i += kThreads) {
      qs[i] = queries[(static_cast<int64_t>(g) * nq + b0) * w + i];
    }
    gsync.sync();   // the queries are in place
    for (int j = 0; j < n_sub; ++j, ++c) {
      const int st = static_cast<int>(c % stages);
      const uint32_t parity = static_cast<uint32_t>(c / stages) & 1u;
      mbar_wait(full + st, parity);
      if (nqc > 0) {
        const int64_t a = (static_cast<int64_t>(g) * n + base +
                           static_cast<int64_t>(j) * sub) * w;
        slab_distances<U, kBits>(
            tile, qs, nqc,
            reinterpret_cast<const uint32_t*>(ring + st * slot) + (a & 3), w,
            active, base, n, block_n, n_units, j * sub,
            min(sub, 4 * n_units - j * sub) / 32, gsync);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
      if (threadIdx.x == 0 && c + stages < n_copies) {
        mbar_wait(empty + st, parity);   // every warp has read the slab
        issue(c + stages);
      }
      __syncwarp();
    }
    gsync.sync();   // this group's distance tile is complete
    if (nqc > 0) {
      group_select<U, kBits, kWide>(
          smem, head, nqc, w, bq, l_k, block_n, out_d, out_i,
          ((static_cast<int64_t>(g) * grid_n + blk) * nq + b0) * l_k, d_sent,
          gsync);
    }
    gsync.sync();   // the select's memory and the queries are reused
  }
}

int launch_hist(const void* codes, const void* queries, const void* active,
                void* out_d, void* out_i, int groups, int n, int w, int nq,
                int l_k, int block_n, int grid_n, int pack, int d_sent,
                void* stream) {
  const hsel::ScanShape sh =
      hsel::scan_shape(groups, w, nq, l_k, block_n, grid_n);
  if (sh.sel.bq == 0 || sh.blocks == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return hsel::dispatch(pack, w, sh.sel.wide, [&](auto u, auto bits,
                                                  auto wide, auto dt,
                                                  auto it) -> int {
    using U = typename decltype(u)::type;
    using DT = typename decltype(dt)::type;
    using IT = typename decltype(it)::type;
    auto kern = topk_hist_kernel<U, decltype(bits)::value,
                                 decltype(wide)::value, DT, IT>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sh.smem));
    if (err != cudaSuccess) return err;
    kern<<<sh.blocks, kThreads, sh.smem, st>>>(
        static_cast<const uint32_t*>(codes),
        static_cast<const uint32_t*>(queries),
        static_cast<const int32_t*>(active), static_cast<DT*>(out_d),
        static_cast<IT*>(out_i), n, w, nq, l_k, block_n, grid_n, sh.sel.bq,
        d_sent);
    return cudaGetLastError();
  });
}

// Sizes kern (a topk_hist_dma_kernel) for plan pl and works out its
// persistent grid: as many blocks as the card holds at once by the
// runtime's occupancy of kern (per_sm a multiprocessor), at most one per
// item.
template <typename Kern>
cudaError_t dma_grid(Kern kern, const DmaPlan& pl, int groups, int grid_n,
                     int nq, int* blocks, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(pl.total));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kern, pl.groups * kThreads, pl.total);
  if (err != cudaSuccess) return err;
  const int64_t n_steps = static_cast<int64_t>(groups) * grid_n;
  const int64_t n_pass =
      ((nq + pl.sel.bq - 1) / pl.sel.bq + pl.groups - 1) / pl.groups;
  if (n_steps * n_pass > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const int n_items = static_cast<int>(n_steps * n_pass);
  *blocks = *per_sm * sms < n_items ? *per_sm * sms : n_items;
  if (*blocks < 1) *blocks = 1;
  return cudaSuccess;
}

int launch_dma(const void* codes, const void* queries, const void* active,
               void* out_d, void* out_i, int groups, int n, int w, int nq,
               int l_k, int block_n, int grid_n, int pack, int d_sent,
               void* stream) {
  const DmaPlan pl = plan_dma(w, block_n, l_k, nq);
  if (pl.sel.bq == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return hsel::dispatch(pack, w, pl.sel.wide, [&](auto u, auto bits,
                                                  auto wide, auto dt,
                                                  auto it) -> int {
    using U = typename decltype(u)::type;
    using DT = typename decltype(dt)::type;
    using IT = typename decltype(it)::type;
    auto kern = topk_hist_dma_kernel<U, decltype(bits)::value,
                                     decltype(wide)::value, DT, IT>;
    int blocks = 0, per_sm = 0;
    const cudaError_t err =
        dma_grid(kern, pl, groups, grid_n, nq, &blocks, &per_sm);
    if (err != cudaSuccess) return err;
    kern<<<blocks, pl.groups * kThreads, pl.total, st>>>(
        static_cast<const uint32_t*>(codes),
        static_cast<const uint32_t*>(queries),
        static_cast<const int32_t*>(active), static_cast<DT*>(out_d),
        static_cast<IT*>(out_i), n, w, nq, l_k, block_n, grid_n,
        groups * grid_n, pl.sel.bq, pl.sub, pl.stages,
        static_cast<int>(pl.group_bytes), d_sent);
    return cudaGetLastError();
  });
}

}  // namespace

// 1 if a block of this shape fits the shared memory a block may use (with
// a query chunk of 8, 4, 2 or 1, and room for l = block_n kept rows), else
// 0; topk_hist_launch refuses the shapes that do not.  Every W <= 32 fits
// at every block_n <= 8192.
extern "C" int topk_hist_fits(int w, int block_n) {
  return hsel::choose_select(w, block_n, block_n, 0).bq > 0 ? 1 : 0;
}

// The same for topk_hist_dma_kernel, whose block also holds a ring of at
// least two code slabs of 128 rows.
extern "C" int topk_hist_dma_fits(int w, int block_n) {
  return plan_dma(w, block_n, block_n, 1).sel.bq > 0 ? 1 : 0;
}

// codes: (groups, n, w) uint32; queries: (groups, nq, w) uint32; active:
// (n,) int32 or null; out_d / out_i: (groups, grid_n, nq, l_k) in the pack's
// types.  Returns the cudaError_t of the launch.
extern "C" int topk_hist_launch(const void* codes, const void* queries,
                                const void* active, void* out_d, void* out_i,
                                int groups, int n, int w, int nq, int l_k,
                                int block_n, int grid_n, int pack, int d_sent,
                                void* stream) {
  if (!topk_hist_fits(w, block_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_hist(codes, queries, active, out_d, out_i, groups, n, w, nq,
                     l_k, block_n, grid_n, pack, d_sent, stream);
}

// Same arguments and outputs as topk_hist_launch, through the pipelined
// persistent kernel.
extern "C" int topk_hist_dma_launch(const void* codes, const void* queries,
                                    const void* active, void* out_d,
                                    void* out_i, int groups, int n, int w,
                                    int nq, int l_k, int block_n, int grid_n,
                                    int pack, int d_sent, void* stream) {
  if (!topk_hist_dma_fits(w, block_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_dma(codes, queries, active, out_d, out_i, groups, n, w, nq,
                    l_k, block_n, grid_n, pack, d_sent, stream);
}

// The launch topk_hist_launch makes for these arguments, without making
// it (launch_plan.cuh).  Returns 0, or the error
// with which the launch refuses.
extern "C" int topk_hist_plan(int groups, int w, int nq, int l_k,
                              int block_n, int grid_n, int64_t* out) {
  if (!topk_hist_fits(w, block_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const hsel::ScanShape sh =
      hsel::scan_shape(groups, w, nq, l_k, block_n, grid_n);
  if (sh.sel.bq == 0 || sh.blocks == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lplan::put(out, sh.blocks, 1, 1, kThreads, sh.smem, 0);
  return 0;
}

// The same for topk_hist_dma_launch, whose grid depends on the occupancy
// of the kernel instance that the pack selects.
extern "C" int topk_hist_dma_plan(int groups, int w, int nq, int l_k,
                                  int block_n, int grid_n, int pack,
                                  int64_t* out) {
  if (!topk_hist_dma_fits(w, block_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DmaPlan pl = plan_dma(w, block_n, l_k, nq);
  if (pl.sel.bq == 0) return static_cast<int>(cudaErrorInvalidValue);
  return hsel::dispatch(pack, w, pl.sel.wide, [&](auto u, auto bits,
                                                  auto wide, auto dt,
                                                  auto it) -> int {
    using U = typename decltype(u)::type;
    using DT = typename decltype(dt)::type;
    using IT = typename decltype(it)::type;
    auto kern = topk_hist_dma_kernel<U, decltype(bits)::value,
                                     decltype(wide)::value, DT, IT>;
    int blocks = 0, per_sm = 0;
    const cudaError_t err =
        dma_grid(kern, pl, groups, grid_n, nq, &blocks, &per_sm);
    if (err != cudaSuccess) return err;
    lplan::put(out, blocks, 1, 1, pl.groups * kThreads, pl.total,
                   per_sm);
    return 0;
  });
}
