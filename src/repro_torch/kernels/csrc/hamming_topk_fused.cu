// Fused Hamming scan + l rounds of masked argmin over G stacked code groups.
//
// Replaces the TPU kernel hamming_topk_fused_kernel
// (src/repro/kernels/hamming.py:207, pallas_call at :243; body
// _topk_fused_kernel :150, with _popcount_tile and cand_encoding :83).
//
// One block per (group g, row block of block_n rows).  For each of the
// group's B queries it emits the block-local smallest-l (distance,
// block-local row) pairs IN DISTANCE ORDER, ties to the lowest row: round
// j emits the lexicographic (distance, row) minimum of the rows not taken
// yet.  Rows >= n or with active == 0 never qualify; once the live rows
// are exhausted every remaining slot carries (pack sentinel, 0), which is
// what the TPU kernel's argmin over an all-sentinel tile returns.  The
// merge in kernels/ops.py is shared with the hist kernel and the plain
// version.
//
// What bounds it: G n B W XOR + popcount operations against one read of
// the codes (4 G n W bytes), as for the hist kernel: at the serving shape
// (G = 4, n ~ 1M, W = 1, B = 32) the popcount rate, not the memory.
//
// Design.  The TPU kernel keeps an (block_n, B) int32 distance tile in
// VMEM and runs l full passes of masked argmin over it: 512 KB at block_n =
// 4096, more than a block's 227 KB here, and O(l block_n) work per query.
// This kernel keeps the block's codes in shared memory (transposed to
// [W][block_n]) plus one liveness bit per row, the layout of
// hamming_topk_hist.cu, and gives each warp one query at a time.  Lane c
// owns the rows r = c + 32 k and holds the smallest key (distance << 32 |
// row) among its live rows above the key it last emitted: its rows leave
// in its own key order, so the taken set needs no bitmap.  Each
// round a shuffle tree takes the warp minimum, the slot is emitted, and
// only the winning lane rescans its own rows for its next key:
// O(block_n + l block_n / 32) distances per (block, query), not
// O(l block_n).  Slots are buffered in registers, one per lane, and written
// 32 at a time.  Later work: more than one query per pass over the tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr size_t kMaxSmem = 232448;                // 227 KB per block on sm_90
using Key = unsigned long long;      // distance << 32 | row; the shuffle
                                     // intrinsics take this type
constexpr Key kNone = ~0ull;         // a lane with no row left

__device__ __forceinline__ int distance(const uint32_t* tile,
                                        const uint32_t* q, int r, int w,
                                        int block_n) {
  int s = 0;
  for (int j = 0; j < w; ++j) s += __popc(tile[j * block_n + r] ^ q[j]);
  return s;
}

// The smallest key >= lo among this lane's live rows.
__device__ __forceinline__ Key lane_min(const uint32_t* tile,
                                        const uint32_t* live,
                                        const uint32_t* q, int lane, int n_lw,
                                        int w, int block_n, Key lo) {
  Key best = kNone;
  for (int k = 0; k < n_lw; ++k) {
    if ((live[k] >> lane) & 1u) {
      const int r = (k << 5) + lane;
      const Key key =
          (static_cast<Key>(distance(tile, q, r, w, block_n)) << 32) |
          static_cast<uint32_t>(r);
      if (key >= lo && key < best) best = key;
    }
  }
  return best;
}

size_t smem_bytes(int w, int block_n) {
  const size_t n_lw = (block_n + 31) / 32;
  return sizeof(uint32_t) * (static_cast<size_t>(w) * block_n + n_lw +
                             kWarps * static_cast<size_t>(w));
}

template <typename DT, typename IT>
__global__ void __launch_bounds__(kThreads)
topk_fused_kernel(const uint32_t* __restrict__ codes,
                  const uint32_t* __restrict__ queries,
                  const int32_t* __restrict__ active, DT* __restrict__ out_d,
                  IT* __restrict__ out_i, int n, int w, int nq, int l_k,
                  int block_n, int d_sent) {
  extern __shared__ uint32_t smem[];
  const int n_lw = (block_n + 31) >> 5;
  uint32_t* tile = smem;                                     // [w][block_n]
  uint32_t* live = tile + static_cast<size_t>(w) * block_n;  // [n_lw]
  uint32_t* qbuf = live + n_lw;                              // [kWarps][w]

  const int g = blockIdx.y;
  const int blk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blk) * block_n;
  const uint32_t* gcodes = codes + static_cast<int64_t>(g) * n * w;

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
    if (lane == 0) live[r >> 5] = bits;
  }
  __syncthreads();

  uint32_t* q = qbuf + warp * w;
  for (int b = warp; b < nq; b += kWarps) {
    const int64_t obase =
        ((static_cast<int64_t>(g) * gridDim.x + blk) * nq + b) * l_k;
    for (int j = lane; j < w; j += 32) {
      q[j] = queries[(static_cast<int64_t>(g) * nq + b) * w + j];
    }
    __syncwarp();
    Key mine = lane_min(tile, live, q, lane, n_lw, w, block_n, 0ull);
    int slot_d = 0, slot_r = 0;   // this lane's buffered slot
    int j = 0;
    for (; j < l_k; ++j) {
      Key m = mine;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const Key y = __shfl_xor_sync(kFull, m, o);
        m = y < m ? y : m;
      }
      if (m == kNone) break;                 // live rows exhausted
      const int r = static_cast<int>(m & 0xFFFFFFFFull);
      if (lane == (j & 31)) {
        slot_d = static_cast<int>(m >> 32);
        slot_r = r;
      }
      if ((j & 31) == 31) {
        out_d[obase + j - 31 + lane] = static_cast<DT>(slot_d);
        out_i[obase + j - 31 + lane] = static_cast<IT>(slot_r);
      }
      if (lane == (r & 31)) {
        mine = lane_min(tile, live, q, lane, n_lw, w, block_n, m + 1);
      }
    }
    // flush the partly filled last group of 32 slots, then the sentinels
    const int done = j & ~31;
    if (lane < (j & 31)) {
      out_d[obase + done + lane] = static_cast<DT>(slot_d);
      out_i[obase + done + lane] = static_cast<IT>(slot_r);
    }
    for (int s = j + lane; s < l_k; s += 32) {
      out_d[obase + s] = static_cast<DT>(d_sent);
      out_i[obase + s] = static_cast<IT>(0);
    }
    __syncwarp();   // q is reused by this warp's next query
  }
}

template <typename DT, typename IT>
cudaError_t launch(const void* codes, const void* queries, const void* active,
                   void* out_d, void* out_i, int groups, int n, int w,
                   int nq, int l_k, int block_n, int grid_n, int d_sent,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(w, block_n);
  cudaError_t err = cudaFuncSetAttribute(
      topk_fused_kernel<DT, IT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(grid_n, groups);
  topk_fused_kernel<DT, IT><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(codes),
      static_cast<const uint32_t*>(queries),
      static_cast<const int32_t*>(active), static_cast<DT*>(out_d),
      static_cast<IT*>(out_i), n, w, nq, l_k, block_n, d_sent);
  return cudaGetLastError();
}

}  // namespace

// 1 if one block of this shape fits the shared memory a block may use
// (kMaxSmem), else 0; topk_fused_launch refuses the shapes that do not.
extern "C" int topk_fused_fits(int w, int block_n) {
  return smem_bytes(w, block_n) <= kMaxSmem ? 1 : 0;
}

// codes: (groups, n, w) uint32; queries: (groups, nq, w) uint32; active:
// (n,) int32 or null; out_d / out_i: (groups, grid_n, nq, l_k) in the pack's
// types (pack 0: int32/int32, 1: int16/int16, 2: uint8/int16).  Returns the
// cudaError_t of the launch.
extern "C" int topk_fused_launch(const void* codes, const void* queries,
                                 const void* active, void* out_d, void* out_i,
                                 int groups, int n, int w, int nq, int l_k,
                                 int block_n, int grid_n, int pack,
                                 int d_sent, void* stream) {
  if (!topk_fused_fits(w, block_n)) {
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
