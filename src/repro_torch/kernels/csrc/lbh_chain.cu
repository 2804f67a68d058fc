// Fused LBH surrogate-gradient chain (paper eq. 16-18).
//
// Replaces the TPU kernel lbh_chain_kernel
// (src/repro/kernels/lbh_grad.py:44, pallas_call at :49; body _kernel :25).
//
//   b = tanh(p q / 2);  s = (R b) * (1 - b^2);  out = (s q, s p)
//
// for p, q of shape (m,) and the (m, m) residue R, all float32.  The
// gradient of the surrogate g~(u, v) = -b^T R b (symmetric R) is then
// (-X^T (s q), -X^T (s p)), which the caller forms with two matmuls.
//
// What bounds it: reading R once, 4 m^2 bytes (4 MB at the learner's
// m = 1000, ~1.2 us at 3.35 TB/s) against 2 m^2 FLOP; the memory bounds it
// and, at m = 1000, a launch's own latency does in practice.
//
// Design.  No padding (the TPU wrapper pads m to its row block).  Every
// block computes b for all m into shared memory itself (m tanhf, cheap
// against the rows it reads), so b never goes through device memory; each
// warp then reduces whole rows of R, lane j reading columns j, j + 32, ...
// (coalesced 128-byte loads), a shuffle tree sums the lanes, and lane 0
// finishes the row's elementwise chain.  Warps stride over rows, so any
// grid covers any m.  tanhf is the IEEE-accurate one (no --use_fast_math).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;
constexpr size_t kMaxSmem = 232448;     // 227 KB per block on sm_90

__global__ void __launch_bounds__(kThreads)
lbh_chain_kernel(const float* __restrict__ p, const float* __restrict__ q,
                 const float* __restrict__ r, float* __restrict__ sq,
                 float* __restrict__ sp, int m) {
  extern __shared__ float bs[];          // [m]
  for (int j = threadIdx.x; j < m; j += kThreads) {
    bs[j] = tanhf(0.5f * p[j] * q[j]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = blockIdx.x * kWarps + warp; i < m; i += gridDim.x * kWarps) {
    const float* row = r + static_cast<int64_t>(i) * m;
    float acc = 0.0f;
#pragma unroll 4
    for (int j = lane; j < m; j += 32) acc = fmaf(row[j], bs[j], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
    }
    if (lane == 0) {
      const float b = bs[i];
      const float s = acc * (1.0f - b * b);
      sq[i] = s * q[i];
      sp[i] = s * p[i];
    }
  }
}

}  // namespace

// 1 when b for m rows fits one block's shared memory, else 0.
extern "C" int lbh_chain_fits(int m) {
  return sizeof(float) * static_cast<size_t>(m) <= kMaxSmem ? 1 : 0;
}

// p, q: (m,) float32; r: (m, m) float32 row-major; sq, sp: (m,) float32.
// Returns the cudaError_t of the launch.
extern "C" int lbh_chain_launch(const void* p, const void* q, const void* r,
                                void* sq, void* sp, int m, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(m);
  if (smem > 48 * 1024) {   // past the default limit: opt in
    cudaError_t err = cudaFuncSetAttribute(
        lbh_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int blocks = (m + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  lbh_chain_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(
      stream)>>>(static_cast<const float*>(p), static_cast<const float*>(q),
                 static_cast<const float*>(r), static_cast<float*>(sq),
                 static_cast<float*>(sp), m);
  return cudaGetLastError();
}
