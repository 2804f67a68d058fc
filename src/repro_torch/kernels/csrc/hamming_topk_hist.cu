// Fused Hamming scan + histogram top-l select over G stacked code groups.
//
// Replaces the TPU kernel hamming_topk_hist_kernel with dma=False
// (src/repro/kernels/hamming.py:429, pallas_call at :475; bodies
// _topk_hist_kernel :354, _popcount_tile :261, _hist_select :271,
// _pack_cand :345, cand_encoding :83).
//
// One block per (group g, row block of block_n rows).  For each of the
// group's B queries it emits the exact block-local smallest-t set,
// t = min(l, live rows in the block), ties to the lowest row, as
// (distance, block-local row) pairs in ROW order; slots past t carry
// (pack sentinel, block_n - 1).  Rows >= n or with active == 0 never
// qualify.  The same contract as the TPU kernel, so the merge in
// kernels/ops.py is shared by both and by the plain version.
//
// What bounds it: G n B W XOR + popcount operations against one read of
// the codes (4 G n W bytes).  At the serving query shape (G = 4, n = 1.06M,
// W = 1, B = 32) that is 1.4e8 popcounts (16 per clock per SM) against
// 17 MB, so the popcount rate bounds it, not the memory.
//
// Design.  The TPU kernel keeps an (block_n, B) int32 distance tile in
// VMEM: 512 KB at block_n = 4096, above the 227 KB a block may have here.
// This kernel keeps only the block's codes in shared memory (transposed
// to [W][block_n], so consecutive lanes read consecutive banks) plus one
// liveness bit per row, and recomputes a distance (W XOR + __popc) each
// time it needs one: that costs less than storing it.  Each warp owns one
// query at a time:
//   1. a shared-memory histogram of the live distances (<= 32 W + 1 bins);
//   2. a warp prefix sum over the bins to the cutoff r, the smallest
//      distance whose count reaches t, and less = count(d < r);
//   3. an ordered ballot compaction over the rows that emits d < r and the
//      first t - less ties at r, in row order, stopping once t are out.
// Later work: more than one query per pass over the tile, and fewer
// candidates per block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

size_t smem_bytes(int w, int block_n) {
  const size_t n_lw = (block_n + 31) / 32;
  return sizeof(uint32_t) * (static_cast<size_t>(w) * block_n + n_lw +
                             kWarps * (32 * static_cast<size_t>(w) + 1) +
                             kWarps * static_cast<size_t>(w));
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
  const int max_dist = 32 * w;
  uint32_t* tile = smem;                                   // [w][block_n]
  uint32_t* live = tile + static_cast<size_t>(w) * block_n;  // [n_lw]
  int* hist = reinterpret_cast<int*>(live + n_lw);  // [kWarps][max_dist+1]
  uint32_t* qbuf = reinterpret_cast<uint32_t*>(hist + kWarps * (max_dist + 1));
  __shared__ int live_rows;

  const int g = blockIdx.y;
  const int blk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blk) * block_n;
  const uint32_t* gcodes = codes + static_cast<int64_t>(g) * n * w;

  if (threadIdx.x == 0) live_rows = 0;
  __syncthreads();
  // Stage the codes and one liveness bit per row.  n_lw * 32 is a multiple
  // of 32, so whole warps run each iteration and the ballot is uniform.
  for (int r = threadIdx.x; r < n_lw * 32; r += kThreads) {
    const int64_t gr = base + r;
    const bool in = r < block_n && gr < n;
    const bool ok = in && (active == nullptr || active[gr] != 0);
    if (r < block_n) {
      for (int j = 0; j < w; ++j) tile[j * block_n + r] = in ? gcodes[gr * w + j] : 0u;
    }
    const unsigned bits = __ballot_sync(kFull, ok);
    if (lane == 0) {
      live[r >> 5] = bits;
      atomicAdd(&live_rows, __popc(bits));
    }
  }
  __syncthreads();
  const int t = min(l_k, live_rows);

  int* h = hist + warp * (max_dist + 1);
  uint32_t* q = qbuf + warp * w;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int b = warp; b < nq; b += kWarps) {
    const int64_t obase =
        ((static_cast<int64_t>(g) * gridDim.x + blk) * nq + b) * l_k;
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
cudaError_t launch(const void* codes, const void* queries, const void* active,
                   void* out_d, void* out_i, int groups, int n, int w,
                   int nq, int l_k, int block_n, int grid_n, int d_sent,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(w, block_n);
  cudaError_t err = cudaFuncSetAttribute(
      topk_hist_kernel<DT, IT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(grid_n, groups);
  topk_hist_kernel<DT, IT><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(codes),
      static_cast<const uint32_t*>(queries),
      static_cast<const int32_t*>(active), static_cast<DT*>(out_d),
      static_cast<IT*>(out_i), n, w, nq, l_k, block_n, d_sent);
  return cudaGetLastError();
}

}  // namespace

// 1 if one block of this shape fits the shared memory a block may use
// (kMaxSmem), else 0; topk_hist_launch refuses the shapes that do not.
extern "C" int topk_hist_fits(int w, int block_n) {
  return smem_bytes(w, block_n) <= kMaxSmem ? 1 : 0;
}

// codes: (groups, n, w) uint32; queries: (groups, nq, w) uint32; active:
// (n,) int32 or null; out_d / out_i: (groups, grid_n, nq, l_k) in the pack's
// types (pack 0: int32/int32, 1: int16/int16, 2: uint8/int16).  Returns the
// cudaError_t of the launch.
extern "C" int topk_hist_launch(const void* codes, const void* queries,
                                const void* active, void* out_d, void* out_i,
                                int groups, int n, int w, int nq, int l_k,
                                int block_n, int grid_n, int pack, int d_sent,
                                void* stream) {
  if (!topk_hist_fits(w, block_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (pack) {
    case 0:
      return launch<int32_t, int32_t>(codes, queries, active, out_d, out_i,
                                      groups, n, w, nq, l_k, block_n, grid_n,
                                      d_sent, s);
    case 1:
      return launch<int16_t, int16_t>(codes, queries, active, out_d, out_i,
                                      groups, n, w, nq, l_k, block_n, grid_n,
                                      d_sent, s);
    case 2:
      return launch<uint8_t, int16_t>(codes, queries, active, out_d, out_i,
                                      groups, n, w, nq, l_k, block_n, grid_n,
                                      d_sent, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
