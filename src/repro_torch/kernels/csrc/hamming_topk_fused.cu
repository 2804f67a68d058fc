// Fused Hamming scan + block-local top-l in (distance, row) order over G
// stacked code groups.
//
// Replaces the TPU kernel hamming_topk_fused_kernel
// (src/repro/kernels/hamming.py:207, pallas_call at :243; body
// _topk_fused_kernel :150, with _popcount_tile and cand_encoding :83),
// which selects by l rounds of masked argmin.
//
// For each (group g, row block of block_n rows) and each of the group's B
// queries it emits the block-local smallest-l (distance, block-local row)
// pairs IN DISTANCE ORDER, ties to the lowest row: slot j holds the j-th
// lexicographic (distance, row) minimum of the live rows.  Rows >= n or
// with active == 0 never qualify; once the live rows are exhausted every
// remaining slot carries (pack sentinel, 0), which is what the TPU kernel's
// argmin over an all-sentinel tile returns.  The merge in kernels/ops.py is
// shared with the hist kernel and the plain version.
//
// What bounds it: G n B W XOR + popcount operations against one read of
// the codes (4 G n W bytes), as for the hist kernel: at the serving shape
// (G = 4, n ~ 1M, W = 1, B = 32) the popcount rate, not the memory.
//
// Design.  The l rounds of argmin would cost O(l block_n) per query.  The
// set the rounds emit is the hist kernel's block-local smallest-t set, and
// its order follows from the histogram the hist kernel builds anyway: with
// at most 32 W + 1 distinct distances, (distance, row) order is a stable
// counting sort.  So this kernel runs the hist kernel's single-pass select
// (hamming_select.cuh) and changes only how the kept rows, listed in row
// order, go out: each to the first slot of its distance (the exclusive
// prefix of the histogram) plus its rank among the kept rows of that
// distance before it.  O(block_n + t) per query, with the same grid of one
// 256-thread block per (group, row block, chunk of at most 8 queries).

#include <cstdint>
#include <cuda_runtime.h>

#include "hamming_select.cuh"
#include "launch_plan.cuh"

namespace {

using hsel::kThreads;

template <typename U, int kBits, bool kWide, typename DT, typename IT>
__global__ void __launch_bounds__(kThreads)
topk_fused_kernel(const uint32_t* __restrict__ codes,
                  const uint32_t* __restrict__ queries,
                  const int32_t* __restrict__ active, DT* __restrict__ out_d,
                  IT* __restrict__ out_i, int n, int w, int nq, int l_k,
                  int block_n, int grid_n, int bq, int d_sent) {
  extern __shared__ __align__(16) unsigned char smem[];
  hsel::scan_block<true, U, kBits, kWide>(smem, codes, queries, active, out_d,
                                   out_i, n, w, nq, l_k, block_n, grid_n, bq,
                                   d_sent);
}

}  // namespace

// 1 if a block of this shape fits the shared memory a block may use (with
// a query chunk of 8, 4, 2 or 1, and room for l = block_n kept rows), else
// 0; topk_fused_launch refuses the shapes that do not.  Every W <= 32 fits
// at every block_n <= 8192.
extern "C" int topk_fused_fits(int w, int block_n) {
  return hsel::choose_select(w, block_n, block_n, 0).bq > 0 ? 1 : 0;
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
  const hsel::ScanShape sh =
      hsel::scan_shape(groups, w, nq, l_k, block_n, grid_n);
  if (sh.sel.bq == 0 || sh.blocks == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return hsel::dispatch(pack, w, sh.sel.wide, [&](auto u, auto bits,
                                                  auto wide, auto dt,
                                                  auto it) -> int {
    using U = typename decltype(u)::type;
    using DT = typename decltype(dt)::type;
    using IT = typename decltype(it)::type;
    auto kern = topk_fused_kernel<U, decltype(bits)::value,
                                  decltype(wide)::value, DT, IT>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sh.smem));
    if (err != cudaSuccess) return err;
    kern<<<sh.blocks, kThreads, sh.smem,
           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(codes),
        static_cast<const uint32_t*>(queries),
        static_cast<const int32_t*>(active), static_cast<DT*>(out_d),
        static_cast<IT*>(out_i), n, w, nq, l_k, block_n, grid_n, sh.sel.bq,
        d_sent);
    return cudaGetLastError();
  });
}

// The launch topk_fused_launch makes for these arguments, without making
// it (launch_plan.cuh).  Returns 0, or the error
// with which the launch refuses.
extern "C" int topk_fused_plan(int groups, int w, int nq, int l_k,
                               int block_n, int grid_n, int64_t* out) {
  if (!topk_fused_fits(w, block_n)) {
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
