// Exact re-rank margins of gathered candidate rows: kernel 11.
//
// Replaces no TPU kernel.  The JAX package's re-rank
// (src/repro/core/search.py, margin_rerank_batch) is plain jnp, a gather,
// a multiply and a sum over d that XLA fuses.  In eager PyTorch the same
// expression makes three (B, C, d) float32 tensors (the gathered rows,
// their products with w, the products zero-padded) and then reduces
// them: four passes over every candidate row, 1.8 GB a card a batch in
// the four-card Tiny Images cell.  This kernel reads each candidate row
// once and writes one float a slot:
//
//   m[q, c] = valid[q, c] ? |sum_j x[rows[q, c], j] w[q, j]|
//                           / max(||w[q]||, 1e-12) : +inf
//
// in float32 throughout (no TF32, no tensor cores).  x is one row space
// held as two segments: rows < split from base, rows >= split from delta
// at row - split (the LSM index's base and delta; one segment passes
// delta = base and n_delta = 0).  An invalid slot reads no row, so its
// row id may be anything; a valid slot whose row lies outside both
// segments gets NaN, not a read out of bounds.
//
// What bounds it: bytes.  Each valid slot's row is read once, d 4 bytes
// (kernels/ops.py, row_margins_bound); its 2 d flops are far below the
// float32 rate.
//
// The sum's order.  A margin depends on the row, w and d alone, never on
// the slot, the batch or the candidates' layout (the router's cross-shard
// re-rank and the equality of one card with four rely on it).  A row is
// summed by T = 32 WPR threads, WPR chosen by d alone: thread t
// accumulates x_j w_j for j = t, t + T, t + 2T, ... in ascending order in
// one float; the warp's threads are combined by an xor butterfly, then
// the row's WPR warps in ascending order.  Loads are 4 bytes: a row
// stride of d 4 bytes puts rows at different alignments, and a vector
// load would change the order with them.  ||w|| is summed the same way
// by the block's threads (their count is also chosen by d alone), once a
// block.
//
// Design.  A block takes one query and a slab of its slots, and first
// stages w in shared memory (where d 4 bytes fits: 105 KB at d 26,215)
// while it sums ||w||^2; wider rows read w from global memory.  Narrow
// rows (d <= kNarrowMax): one warp a row; a warp takes 32 consecutive
// slots, each lane loading one slot's flag and row id in one coalesced
// read, then sums the valid rows one after the other (kLoads loads in
// flight a lane) and stores its 32 margins in one write.  Wide rows:
// kWideWarps warps a row, a block two rows at a time, the warps' sums
// met in shared memory.  The grid is every (query, slab); a slab's size
// is fixed by the variant, so the grid grows with B C and fills the SMs
// at the cells' shapes (tiny1m 250 blocks, four-card ~4,600, news20
// 1,020).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "launch_plan.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNarrowMax = 4096;     // widest row a single warp sums
constexpr int kWideWarps = 8;        // warps a row past kNarrowMax
constexpr int kNarrowThreads = 256;
constexpr int kWideThreads = 512;
constexpr int kWideRows = 4;         // slots a wide block takes
constexpr int kLoads = 16;           // loads in flight a lane
constexpr int kStageMax = 57344;     // widest w staged: 224 KiB
// the norm's warp partials, then two rounds of the wide rows' warp sums
constexpr int kNormParts = 16;
constexpr int kScratch = kNormParts + 2 * (kWideThreads / 32);

struct Plan {
  int wpr;          // warps a row
  int threads;
  int slab;         // slots a block takes
  int slabs;        // blocks a query
  int64_t blocks;
  int smem;         // dynamic: w staged, or 0
};

Plan make_plan(int b, int c, int d) {
  Plan p;
  const bool narrow = d <= kNarrowMax;
  p.wpr = narrow ? 1 : kWideWarps;
  p.threads = narrow ? kNarrowThreads : kWideThreads;
  p.slab = narrow ? kNarrowThreads : kWideRows;
  p.slabs = (c + p.slab - 1) / p.slab;
  p.blocks = static_cast<int64_t>(p.slabs) * b;
  p.smem = d <= kStageMax ? d * 4 : 0;
  return p;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// The row's address, or nullptr where it lies outside both segments.
__device__ __forceinline__ const float* row_at(
    int64_t r, const float* base, const float* delta, int64_t split,
    int64_t n_base, int64_t n_delta, int d) {
  if (r >= 0 && r < split) {
    return r < n_base ? base + r * d : nullptr;
  }
  return r >= split && r - split < n_delta ? delta + (r - split) * d
                                           : nullptr;
}

// Thread t's share of the row's dot product: j = t, t + T, ... ascending.
template <int T>
__device__ __forceinline__ float lane_dot(const float* __restrict__ xr,
                                          const float* wv, int t, int d) {
  float acc = 0.f;
  for (int j0 = t; j0 < d; j0 += kLoads * T) {
    float xs[kLoads], ws[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = j0 + u * T;
      xs[u] = j < d ? __ldg(xr + j) : 0.f;
      ws[u] = j < d ? wv[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) acc = fmaf(xs[u], ws[u], acc);
  }
  return acc;
}

template <int WPR>
__global__ void __launch_bounds__(WPR == 1 ? kNarrowThreads : kWideThreads)
row_margins_kernel(const float* __restrict__ base,
                   const float* __restrict__ delta, int64_t split,
                   int64_t n_base, int64_t n_delta,
                   const float* __restrict__ w,
                   const int64_t* __restrict__ rows,
                   const uint8_t* __restrict__ valid, float* __restrict__ out,
                   int c, int d, int slab, int slabs, int staged) {
  constexpr int kThreads = WPR == 1 ? kNarrowThreads : kWideThreads;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float w_smem[];
  __shared__ float scratch[kScratch];
  const int q = blockIdx.x / slabs;
  const int first = (blockIdx.x % slabs) * slab;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* wq = w + static_cast<int64_t>(q) * d;
  const int64_t q_off = static_cast<int64_t>(q) * c;

  // ||w||^2 by the block's threads in a fixed order; w staged meanwhile
  float s = 0.f;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const float v = wq[j];
    if (staged) w_smem[j] = v;
    s = fmaf(v, v, s);
  }
  s = warp_sum(s);
  if (lane == 0) scratch[warp] = s;
  __syncthreads();
  float n2 = 0.f;
  for (int k = 0; k < kWarps; ++k) n2 += scratch[k];
  const float denom = fmaxf(sqrtf(n2), 1e-12f);
  const float* wv = staged ? w_smem : wq;

  if constexpr (WPR == 1) {
    const int slot = first + warp * 32 + lane;
    bool live = false;
    int64_t r = 0;
    if (slot < c) {
      live = valid[q_off + slot] != 0;
      if (live) r = rows[q_off + slot];
    }
    float m = INFINITY;
    unsigned todo = __ballot_sync(kFull, live);
    while (todo) {
      const int i = __ffs(todo) - 1;
      todo &= todo - 1;
      const float* xr = row_at(__shfl_sync(kFull, r, i), base, delta, split,
                               n_base, n_delta, d);
      if (xr == nullptr) {        // the same row for the whole warp
        if (lane == i) m = NAN;
        continue;
      }
      const float dot = warp_sum(lane_dot<32>(xr, wv, lane, d));
      if (lane == i) m = fabsf(dot) / denom;
    }
    if (slot < c) out[q_off + slot] = m;
  } else {
    constexpr int kGroups = kWarps / WPR;
    const int g = warp / WPR;
    const int t = threadIdx.x % (32 * WPR);
    const int last = min(first + slab, c);
    int round = 0;
    for (int s0 = first; s0 < last; s0 += kGroups, ++round) {
      const int slot = s0 + g;
      bool live = false;
      const float* xr = nullptr;
      float dot = 0.f;
      if (slot < last) {
        live = valid[q_off + slot] != 0;
        if (live) {
          xr = row_at(rows[q_off + slot], base, delta, split, n_base,
                      n_delta, d);
          if (xr != nullptr) dot = lane_dot<32 * WPR>(xr, wv, t, d);
        }
      }
      dot = warp_sum(dot);
      float* part = scratch + kNormParts + (round & 1) * kWarps;
      if (lane == 0) part[warp] = dot;
      // one barrier a round: a round's part is rewritten two rounds on,
      // after every thread has passed the next round's barrier
      __syncthreads();
      if (t == 0 && slot < last) {
        float sum = 0.f;
        for (int k = 0; k < WPR; ++k) sum += part[g * WPR + k];
        out[q_off + slot] = !live ? INFINITY
                            : xr == nullptr ? NAN : fabsf(sum) / denom;
      }
    }
  }
}

template <int WPR>
cudaError_t launch(const Plan& p, cudaStream_t stream, const float* base,
                   const float* delta, int64_t split, int64_t n_base,
                   int64_t n_delta, const float* w, const int64_t* rows,
                   const uint8_t* valid, float* out, int c, int d) {
  auto kern = row_margins_kernel<WPR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(p.blocks), p.threads, p.smem, stream>>>(
      base, delta, split, n_base, n_delta, w, rows, valid, out, c, d, p.slab,
      p.slabs, p.smem > 0 ? 1 : 0);
  return cudaGetLastError();
}

bool refused(int b, int c, int d) {
  return b < 1 || c < 1 || d < 1
         || make_plan(b, c, d).blocks > 2147483647LL;
}

}  // namespace

// base (n_base, d), delta (n_delta, d), w (b, d) float32; rows (b, c)
// int64; valid (b, c) bool; out (b, c) float32.  Rows < split read base,
// the others delta at row - split.  Returns the cudaError_t of the launch.
extern "C" int row_margins_launch(const void* base, const void* delta,
                                  int64_t split, int64_t n_base,
                                  int64_t n_delta, const void* w,
                                  const void* rows, const void* valid,
                                  void* out, int b, int c, int d,
                                  void* stream) {
  if (refused(b, c, d)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(b, c, d);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const float*>(base);
  const auto* xd = static_cast<const float*>(delta);
  const auto* wf = static_cast<const float*>(w);
  const auto* ri = static_cast<const int64_t*>(rows);
  const auto* vb = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<float*>(out);
  const cudaError_t err =
      p.wpr == 1 ? launch<1>(p, st, xb, xd, split, n_base, n_delta, wf, ri,
                             vb, o, c, d)
                 : launch<kWideWarps>(p, st, xb, xd, split, n_base, n_delta,
                                      wf, ri, vb, o, c, d);
  return static_cast<int>(err);
}

// The launch row_margins_launch makes for these arguments, without making
// it (launch_plan.cuh).  Returns 0, or the error with which the launch
// refuses.
extern "C" int row_margins_plan(int b, int c, int d, int64_t* out) {
  if (refused(b, c, d)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(b, c, d);
  lplan::put(out, p.blocks, 1, 1, p.threads, p.smem, 0);
  return 0;
}
