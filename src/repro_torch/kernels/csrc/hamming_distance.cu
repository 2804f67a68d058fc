// Hamming distances between packed code rows and packed queries.
//
// Replaces two TPU kernels of src/repro/kernels/hamming.py:
// - hamming_distance_kernel (:123, pallas_call at :129; body _kernel :117):
//   codes (n, W) uint32 and one query (W,) -> (n,) int32;
// - hamming_distance_batch_kernel (:516, pallas_call at :524; body
//   _batch_kernel :145): codes (n, W) and queries (B, W) -> (n, B) int32,
//   which the JAX wrapper transposes to (B, n) (src/repro/kernels/ops.py:176).
//   Here the kernel writes (B, n) itself, row b holding query b's
//   distances, so nothing is transposed.
//
// What bounds them: bytes.  The batched kernel reads the codes once
// (4 n W bytes) and writes 4 B n bytes of distances: at n = 1.06M, W = 1,
// B = 32 that is 140 MB against 3.4e7 popcounts.  The single-query kernel
// moves 8.5 MB at that n, less than one launch costs.
//
// Design.  One thread per code row, 256 rows per block.  blockIdx.y picks
// a chunk of up to kChunk queries, staged in shared memory, so any B is
// taken: one chunk per 32 queries, each re-reading the code rows (from L2
// once the first chunk has pulled them in).  A thread keeps its chunk's
// sums in registers, reads each of its row's W words once and adds
// __popc(c ^ q) for every query of the chunk; then it writes one distance
// per query, so a warp writes 32 consecutive int32 of each output row.
// Rows past n do nothing: no padding is needed.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_plan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;              // queries per block of the batch kernel
constexpr size_t kMaxSmem = 232448;     // 227 KB per block on sm_90

size_t smem_bytes(int w, int queries) {
  return sizeof(uint32_t) * static_cast<size_t>(w) * queries;
}

// The distances of row blockIdx.x * kThreads + threadIdx.x to the queries
// b0 .. b0 + min(kQ, nq - b0) - 1, b0 = blockIdx.y * kQ, into out[b][row].
template <int kQ>
__device__ __forceinline__ void distances(const uint32_t* __restrict__ codes,
                                          const uint32_t* __restrict__ queries,
                                          int32_t* __restrict__ out,
                                          uint32_t* qs, int n, int w, int nq) {
  const int b0 = blockIdx.y * kQ;
  const int nb = min(kQ, nq - b0);
  for (int i = threadIdx.x; i < nb * w; i += kThreads) {
    qs[i] = queries[static_cast<int64_t>(b0) * w + i];
  }
  __syncthreads();
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  int acc[kQ];
#pragma unroll
  for (int b = 0; b < kQ; ++b) acc[b] = 0;
  const uint32_t* row = codes + r * w;
  for (int j = 0; j < w; ++j) {
    const uint32_t c = row[j];
#pragma unroll
    for (int b = 0; b < kQ; ++b) {
      if (b < nb) acc[b] += __popc(c ^ qs[b * w + j]);
    }
  }
#pragma unroll
  for (int b = 0; b < kQ; ++b) {
    if (b < nb) out[static_cast<int64_t>(b0 + b) * n + r] = acc[b];
  }
}

__global__ void __launch_bounds__(kThreads)
distance_kernel(const uint32_t* __restrict__ codes,
                const uint32_t* __restrict__ query, int32_t* __restrict__ out,
                int n, int w) {
  extern __shared__ uint32_t smem[];
  distances<1>(codes, query, out, smem, n, w, 1);
}

__global__ void __launch_bounds__(kThreads)
distance_batch_kernel(const uint32_t* __restrict__ codes,
                      const uint32_t* __restrict__ queries,
                      int32_t* __restrict__ out, int n, int w, int nq) {
  extern __shared__ uint32_t smem[];
  distances<kChunk>(codes, queries, out, smem, n, w, nq);
}

// A launch's grid (a block per kThreads rows, by chunks of queries) and
// dynamic shared memory: the queries of a chunk.
struct Shape {
  int blocks, chunks;
  size_t smem;
};

Shape single_shape(int n, int w) {
  return {(n + kThreads - 1) / kThreads, 1, smem_bytes(w, 1)};
}

Shape batch_shape(int n, int w, int nq) {
  return {(n + kThreads - 1) / kThreads, (nq + kChunk - 1) / kChunk,
          smem_bytes(w, nq < kChunk ? nq : kChunk)};
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, Shape sh, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sh.smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sh.blocks, sh.chunks), kThreads, sh.smem, stream>>>(args...);
  return cudaGetLastError();
}

void put_plan(int64_t* out, Shape sh) {
  lplan::put(out, sh.blocks, sh.chunks, 1, kThreads,
             static_cast<int64_t>(sh.smem), 0);
}

}  // namespace

// 1 if a block's chunk of kChunk queries of w words fits the shared memory
// a block may use, else 0; both launches refuse the widths that do not.
extern "C" int distance_fits(int w) {
  return smem_bytes(w, kChunk) <= kMaxSmem ? 1 : 0;
}

// codes: (n, w) uint32; query: (w,) uint32; out: (n,) int32.  Returns the
// cudaError_t of the launch.
extern "C" int distance_launch(const void* codes, const void* query,
                               void* out, int n, int w, void* stream) {
  if (!distance_fits(w)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(
      distance_kernel, single_shape(n, w), static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(codes),
      static_cast<const uint32_t*>(query), static_cast<int32_t*>(out), n, w));
}

// codes: (n, w) uint32; queries: (nq, w) uint32; out: (nq, n) int32.
// Returns the cudaError_t of the launch.
extern "C" int distance_batch_launch(const void* codes, const void* queries,
                                     void* out, int n, int w, int nq,
                                     void* stream) {
  if (!distance_fits(w)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(
      distance_batch_kernel, batch_shape(n, w, nq),
      static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(codes),
      static_cast<const uint32_t*>(queries), static_cast<int32_t*>(out), n, w,
      nq));
}

// The launches distance_launch and distance_batch_launch make for these
// arguments, without making them (launch_plan.cuh).
// Return 0, or the error with which the launch refuses.
extern "C" int distance_plan(int n, int w, int64_t* out) {
  if (!distance_fits(w)) return static_cast<int>(cudaErrorInvalidValue);
  put_plan(out, single_shape(n, w));
  return 0;
}

extern "C" int distance_batch_plan(int n, int w, int nq, int64_t* out) {
  if (!distance_fits(w)) return static_cast<int>(cudaErrorInvalidValue);
  put_plan(out, batch_shape(n, w, nq));
  return 0;
}
