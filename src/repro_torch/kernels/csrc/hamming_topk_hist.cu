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
// These kernels keep only a row block's codes in shared memory (transposed
// to [W][block_n], so consecutive lanes read consecutive banks) plus one
// liveness bit per row, and recompute a distance (W XOR + __popc) each
// time they need one: that costs less than storing it.  Each warp owns one
// query at a time (select_block):
//   1. a shared-memory histogram of the live distances (<= 32 W + 1 bins);
//   2. a warp prefix sum over the bins to the cutoff r, the smallest
//      distance whose count reaches t, and less = count(d < r);
//   3. an ordered ballot compaction over the rows that emits d < r and the
//      first t - less ties at r, in row order, stopping once t are out.
//
// topk_hist_kernel runs one block of 256 threads per (group, row block)
// and stages its tile with plain loads.  topk_hist_dma_kernel runs
// persistent blocks of 512 threads, each walking the linear steps
// s = g * grid_n + block, blockIdx.x + k gridDim.x, as the TPU kernel's
// sequential grid does; two shared tiles form a double buffer, and the
// cp.async copy of the next step's tile (4-byte copies landing in the
// transposed slots; rows past n zero-filled with no read) is issued before
// the select of the current one.  Its grid is the number of its blocks
// that fit on the card at once (3 per SM at 42 registers or fewer), so it
// keeps as many warps per SM as topk_hist_kernel (6 blocks of 8 warps at
// 40 registers) while each block walks about G grid_n / (3 SMs) steps:
// 2.6 at the serving shape, so all but a block's last step have a next
// tile in flight.  The select, not the load, sets the time of a step, so
// the copy has little latency to hide.  Later work: more than one query
// per pass over the tile, and fewer candidates per block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // topk_hist_kernel
constexpr int kDmaThreads = 512;        // topk_hist_dma_kernel
constexpr int kDmaMinBlocks = 3;        // its blocks per SM (register cap)
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr size_t kMaxSmem = 232448;     // 227 KB per block on sm_90
constexpr int kDead = 0x7FFFFFFF;       // distance of a row that never qualifies

__device__ __forceinline__ int distance(const uint32_t* tile,
                                        const uint32_t* q, int r, int w,
                                        int block_n) {
  int s = 0;
  for (int j = 0; j < w; ++j) s += __popc(tile[j * block_n + r] ^ q[j]);
  return s;
}

// Shared memory of a block: `tiles` code tiles [w][block_n], the liveness
// bits, and per warp a histogram and a query.
size_t smem_bytes(int w, int block_n, int tiles, int warps) {
  const size_t n_lw = (block_n + 31) / 32;
  return sizeof(uint32_t) * (static_cast<size_t>(tiles) * w * block_n + n_lw +
                             warps * (32 * static_cast<size_t>(w) + 1) +
                             warps * static_cast<size_t>(w));
}

// One liveness bit per row of the row block that starts at `base`.
// n_lw * 32 is a multiple of 32, so whole warps run each iteration and the
// ballot is uniform.
__device__ __forceinline__ void stage_live(uint32_t* live,
                                           const int32_t* active,
                                           int64_t base, int n, int block_n,
                                           int n_lw) {
  for (int r = threadIdx.x; r < n_lw * 32; r += blockDim.x) {
    const int64_t gr = base + r;
    const bool ok = r < block_n && gr < n && (active == nullptr || active[gr] != 0);
    const unsigned bits = __ballot_sync(kFull, ok);
    if ((threadIdx.x & 31) == 0) live[r >> 5] = bits;
  }
}

// Steps 1-3 for every query of group g against the staged row block blk:
// warp k takes the queries k, k + kWarps, ...  tile and live must be
// staged and visible to the whole block; `scratch` holds the warps'
// histograms and queries.
template <int kWarps, typename DT, typename IT>
__device__ __forceinline__ void select_block(
    const uint32_t* tile, const uint32_t* live, uint32_t* scratch,
    const uint32_t* __restrict__ queries, DT* __restrict__ out_d,
    IT* __restrict__ out_i, int g, int blk, int grid_n, int w, int nq,
    int l_k, int block_n, int d_sent) {
  const int n_lw = (block_n + 31) >> 5;
  const int max_dist = 32 * w;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* h = reinterpret_cast<int*>(scratch) + warp * (max_dist + 1);
  uint32_t* q = scratch + kWarps * (max_dist + 1) + warp * w;
  const unsigned lanes_below = (1u << lane) - 1u;
  int live_rows = 0;
  for (int k = lane; k < n_lw; k += 32) live_rows += __popc(live[k]);
  const int t = min(l_k, __reduce_add_sync(kFull, live_rows));
  for (int b = warp; b < nq; b += kWarps) {
    const int64_t obase =
        ((static_cast<int64_t>(g) * grid_n + blk) * nq + b) * l_k;
    for (int j = lane; j < w; j += 32) {
      q[j] = queries[(static_cast<int64_t>(g) * nq + b) * w + j];
    }
    for (int v = lane; v <= max_dist; v += 32) h[v] = 0;
    __syncwarp();
    if (t > 0) {
      // 1. histogram of the live rows' distances
      for (int r0 = 0; r0 < n_lw * 32; r0 += 32) {
        if ((live[r0 >> 5] >> lane) & 1u) {
          atomicAdd(&h[distance(tile, q, r0 + lane, w, block_n)], 1);
        }
      }
      __syncwarp();
      // 2. cutoff r: the first bin whose running count reaches t
      int r_cut = max_dist, less = 0, carry = 0;
      for (int v0 = 0; v0 <= max_dist; v0 += 32) {
        const int v = v0 + lane;
        const int c = v <= max_dist ? h[v] : 0;
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
      // 3. ordered compaction: d < r, then the first t - less ties at r
      const int need = t - less;
      int slots = 0, ties = 0;
      for (int r0 = 0; r0 < n_lw * 32 && slots < t; r0 += 32) {
        const int r = r0 + lane;
        const int dd = ((live[r0 >> 5] >> lane) & 1u)
                           ? distance(tile, q, r, w, block_n) : kDead;
        const bool is_tie = dd == r_cut;
        const unsigned tie_b = __ballot_sync(kFull, is_tie);
        const bool keep =
            dd < r_cut || (is_tie && ties + __popc(tie_b & lanes_below) < need);
        const unsigned keep_b = __ballot_sync(kFull, keep);
        if (keep) {
          const int64_t s = obase + slots + __popc(keep_b & lanes_below);
          out_d[s] = static_cast<DT>(dd);
          out_i[s] = static_cast<IT>(r);
        }
        slots += __popc(keep_b);
        ties += __popc(tie_b);
      }
    }
    for (int s = t + lane; s < l_k; s += 32) {
      out_d[obase + s] = static_cast<DT>(d_sent);
      out_i[obase + s] = static_cast<IT>(block_n - 1);
    }
    __syncwarp();   // q and h are reused by this warp's next query
  }
}

template <typename DT, typename IT>
__global__ void __launch_bounds__(kThreads)
topk_hist_kernel(const uint32_t* __restrict__ codes,
                 const uint32_t* __restrict__ queries,
                 const int32_t* __restrict__ active, DT* __restrict__ out_d,
                 IT* __restrict__ out_i, int n, int w, int nq, int l_k,
                 int block_n, int d_sent) {
  extern __shared__ uint32_t smem[];
  const int n_lw = (block_n + 31) >> 5;
  uint32_t* tile = smem;                                     // [w][block_n]
  uint32_t* live = tile + static_cast<size_t>(w) * block_n;  // [n_lw]
  const int g = blockIdx.y;
  const int blk = blockIdx.x;
  const int64_t base = static_cast<int64_t>(blk) * block_n;
  const uint32_t* gcodes = codes + static_cast<int64_t>(g) * n * w;
  for (int r = threadIdx.x; r < block_n; r += kThreads) {
    const int64_t gr = base + r;
    for (int j = 0; j < w; ++j) tile[j * block_n + r] = gr < n ? gcodes[gr * w + j] : 0u;
  }
  stage_live(live, active, base, n, block_n, n_lw);
  __syncthreads();
  select_block<kThreads / 32>(tile, live, live + n_lw, queries, out_d, out_i,
                              g, blk, gridDim.x, w, nq, l_k, block_n, d_sent);
}

// Issue the asynchronous copy of step s's code tile (group s / grid_n, row
// block s % grid_n) into `tile`, transposed to [w][block_n], as one commit
// group.  Each word is a 4-byte cp.async; a row past n copies 0 bytes from
// the group's first word (a valid address that is not read) and so lands
// as zeros.
__device__ __forceinline__ void fetch_tile(uint32_t* tile,
                                           const uint32_t* codes, int s,
                                           int grid_n, int n, int w,
                                           int block_n) {
  const uint32_t* gcodes = codes + static_cast<int64_t>(s / grid_n) * n * w;
  const int64_t base = static_cast<int64_t>(s % grid_n) * block_n;
  for (int r = threadIdx.x; r < block_n; r += kDmaThreads) {
    const int64_t gr = base + r;
    const bool in = gr < n;
    for (int j = 0; j < w; ++j) {
      const uint32_t dst = static_cast<uint32_t>(
          __cvta_generic_to_shared(tile + j * block_n + r));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                   "l"(in ? gcodes + gr * w + j : gcodes), "r"(in ? 4 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename DT, typename IT>
__global__ void __launch_bounds__(kDmaThreads, kDmaMinBlocks)
topk_hist_dma_kernel(const uint32_t* __restrict__ codes,
                     const uint32_t* __restrict__ queries,
                     const int32_t* __restrict__ active, DT* __restrict__ out_d,
                     IT* __restrict__ out_i, int n, int w, int nq, int l_k,
                     int block_n, int grid_n, int n_steps, int d_sent) {
  extern __shared__ uint32_t smem[];
  const int n_lw = (block_n + 31) >> 5;
  const size_t tile_words = static_cast<size_t>(w) * block_n;
  uint32_t* live = smem + 2 * tile_words;                    // [n_lw]
  int s = blockIdx.x;                    // the launch keeps gridDim.x <= n_steps
  fetch_tile(smem, codes, s, grid_n, n, w, block_n);
  for (int i = 0; s < n_steps; s += gridDim.x, ++i) {
    uint32_t* tile = smem + (i & 1) * tile_words;
    const int next = s + gridDim.x;
    // the other tile was last read by step i - 1, which a barrier closed
    if (next < n_steps) {
      fetch_tile(smem + ((i + 1) & 1) * tile_words, codes, next, grid_n, n, w,
                 block_n);
    }
    const int blk = s % grid_n;
    stage_live(live, active, static_cast<int64_t>(blk) * block_n, n, block_n,
               n_lw);
    if (next < n_steps) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this step's
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    select_block<kDmaThreads / 32>(tile, live, live + n_lw, queries, out_d,
                                   out_i, s / grid_n, blk, grid_n, w, nq, l_k,
                                   block_n, d_sent);
    __syncthreads();   // tile and live are overwritten by the next steps
  }
}

template <bool kDma, typename DT, typename IT>
cudaError_t launch(const void* codes, const void* queries, const void* active,
                   void* out_d, void* out_i, int groups, int n, int w,
                   int nq, int l_k, int block_n, int grid_n, int d_sent,
                   cudaStream_t stream) {
  const auto c = static_cast<const uint32_t*>(codes);
  const auto q = static_cast<const uint32_t*>(queries);
  const auto a = static_cast<const int32_t*>(active);
  const auto od = static_cast<DT*>(out_d);
  const auto oi = static_cast<IT*>(out_i);
  if constexpr (!kDma) {
    const size_t smem = smem_bytes(w, block_n, 1, kThreads / 32);
    cudaError_t err = cudaFuncSetAttribute(
        topk_hist_kernel<DT, IT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    topk_hist_kernel<DT, IT><<<dim3(grid_n, groups), kThreads, smem, stream>>>(
        c, q, a, od, oi, n, w, nq, l_k, block_n, d_sent);
  } else {
    const size_t smem = smem_bytes(w, block_n, 2, kDmaThreads / 32);
    cudaError_t err = cudaFuncSetAttribute(
        topk_hist_dma_kernel<DT, IT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, topk_hist_dma_kernel<DT, IT>, kDmaThreads, smem);
    if (err != cudaSuccess) return err;
    // as many blocks as fit on the card at once, at most one per step
    const int n_steps = groups * grid_n;
    int blocks = per_sm * sms < n_steps ? per_sm * sms : n_steps;
    if (blocks < 1) blocks = 1;
    topk_hist_dma_kernel<DT, IT><<<blocks, kDmaThreads, smem, stream>>>(
        c, q, a, od, oi, n, w, nq, l_k, block_n, grid_n, n_steps, d_sent);
  }
  return cudaGetLastError();
}

// The pack's (distance, id) types: 0 int32/int32, 1 int16/int16, 2
// uint8/int16.
template <bool kDma>
int dispatch(const void* codes, const void* queries, const void* active,
             void* out_d, void* out_i, int groups, int n, int w, int nq,
             int l_k, int block_n, int grid_n, int pack, int d_sent,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (pack) {
    case 0:
      return launch<kDma, int32_t, int32_t>(codes, queries, active, out_d,
                                            out_i, groups, n, w, nq, l_k,
                                            block_n, grid_n, d_sent, s);
    case 1:
      return launch<kDma, int16_t, int16_t>(codes, queries, active, out_d,
                                            out_i, groups, n, w, nq, l_k,
                                            block_n, grid_n, d_sent, s);
    case 2:
      return launch<kDma, uint8_t, int16_t>(codes, queries, active, out_d,
                                            out_i, groups, n, w, nq, l_k,
                                            block_n, grid_n, d_sent, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// 1 if one block of this shape fits the shared memory a block may use
// (kMaxSmem), else 0; topk_hist_launch refuses the shapes that do not.
extern "C" int topk_hist_fits(int w, int block_n) {
  return smem_bytes(w, block_n, 1, kThreads / 32) <= kMaxSmem ? 1 : 0;
}

// The same for topk_hist_dma_kernel, whose block holds two code tiles: W = 4
// at block_n = 8192 fits topk_hist_kernel but not this one.
extern "C" int topk_hist_dma_fits(int w, int block_n) {
  return smem_bytes(w, block_n, 2, kDmaThreads / 32) <= kMaxSmem ? 1 : 0;
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
  return dispatch<false>(codes, queries, active, out_d, out_i, groups, n, w,
                         nq, l_k, block_n, grid_n, pack, d_sent, stream);
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
  return dispatch<true>(codes, queries, active, out_d, out_i, groups, n, w,
                        nq, l_k, block_n, grid_n, pack, d_sent, stream);
}
