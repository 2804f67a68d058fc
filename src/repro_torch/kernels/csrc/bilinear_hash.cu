// Bilinear hash of n points from materialised (d, k) factors U, V.
//
// Replaces the TPU kernel bilinear_hash_kernel
// (src/repro/kernels/bilinear_hash.py:52, pallas_call at :60; bodies
// _kernel :32 and _pack_sign_bits :81).
//
//   codes[i, w] bit j = ((x_i . u_c) * (x_i . v_c) >= 0),  c = 32 w + j < k
//
// and bits >= k are 0.  This is the hash of learned (LBH) and drawn BH
// families; the seeded family has its own kernel (bilinear_hash_seeded.cu),
// which generates the factors before the same product.
//
// What bounds it: 4 n d k float32 operations (two projections, FMA = 2)
// against one read of x (4 n d bytes) and the factors (8 d k bytes); at the
// single-table fit shape (n = 1.06M, d = 385, k = 20) that is ~3.3e10 FLOP
// against 1.6 GB, about 0.49 ms either way on an H100 SXM, so the card's
// float32 rate and its memory bound it about equally.
//
// Design: the d-tiled product of bilinear_product.cuh with G = 1, reading
// U and V from the caller's tensors: x and factor slices of 32 d double-
// buffered through cp.async, each thread 8 rows x 4 columns of both
// products in registers (at k = 20 five column groups, no column past k),
// strict float32 FMAs in d order.  At few rows the chain plan, a lane per
// chain, after bilinear_hash_transpose_kernel has copied U and V
// column-major and x's rows padded into a stream-ordered workspace.  Any
// d >= 1.

#include <cstdint>
#include <cuda_runtime.h>

#include "bilinear_product.cuh"

namespace {

template <int TM, int TN>
__global__ void __launch_bounds__(bprod::kThreads, 2)
bilinear_hash_kernel(const float* __restrict__ x,
                     const float* __restrict__ u,
                     const float* __restrict__ v,
                     uint32_t* __restrict__ codes, int n, int d, int k,
                     int ld, int climit, const bprod::Plan p, bool merge) {
  extern __shared__ float4 smem4[];
  bprod::plan_block<TM, TN>(reinterpret_cast<float*>(smem4), x, u, v, codes,
                            n, d, k, ld, climit, p, merge);
}

template <int TM, int TN>
struct Kernel {
  static constexpr auto fn = bilinear_hash_kernel<TM, TN>;
};

constexpr int kTransposeThreads = 256;

// The chain plan's operands: column-major copies of the caller's (d, k)
// factors (column c of ut at c ld, ld = bprod::chain_ld(d)) and of x's n
// rows (row r at r ld), and the codes' zw words zeroed.  Threads d k ..
// d k + n d copy x.
__global__ void __launch_bounds__(kTransposeThreads)
bilinear_hash_transpose_kernel(const float* __restrict__ u,
                               const float* __restrict__ v,
                               float* __restrict__ ut, float* __restrict__ vt,
                               int d, int k, int ld,
                               const float* __restrict__ x,
                               float* __restrict__ xc, int n,
                               uint32_t* __restrict__ codes, int64_t zw) {
  int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t i = e; i < zw; i += static_cast<int64_t>(gridDim.x) *
                                     blockDim.x) {
    codes[i] = 0u;
  }
  if (e >= static_cast<int64_t>(d) * k) {
    e -= static_cast<int64_t>(d) * k;
    if (e < static_cast<int64_t>(n) * d) xc[e / d * ld + e % d] = x[e];
    return;
  }
  // consecutive threads write consecutive rows of a column
  const int row = static_cast<int>(e % d), c = static_cast<int>(e / d);
  const int64_t at = static_cast<int64_t>(row) * k + c;
  ut[static_cast<int64_t>(c) * ld + row] = u[at];
  vt[static_cast<int64_t>(c) * ld + row] = v[at];
}

unsigned transpose_blocks(int n, int d, int k) {
  return static_cast<unsigned>(
      (static_cast<int64_t>(d) * (k + n) + kTransposeThreads - 1) /
      kTransposeThreads);
}

}  // namespace

// x: (n, d) float32; u, v: (d, k) float32 row-major; codes: (n, ceil(k/32))
// uint32.  Returns the cudaError_t of the launch.
extern "C" int bh_launch(const void* x, const void* u, const void* v,
                         void* codes, int n, int d, int k, void* stream) {
  if (n < 1 || d < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = bprod::device_sms(&sms);
  if (err != cudaSuccess) return err;
  const bprod::Plan p = bprod::choose_plan(n, k, 1, sms);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* fu = static_cast<const float*>(u);
  const auto* fv = static_cast<const float*>(v);
  if (p.tm != bprod::kChain) {
    return bprod::launch_product<Kernel>(
        p, static_cast<const float*>(x), fu, fv,
        static_cast<uint32_t*>(codes), n, d, k, 1, k, k, s);
  }
  // the chain plan reads the factors column-major and x's rows padded,
  // copies in a stream-ordered workspace, into zeroed codes
  if ((err = bprod::keep_pool()) != cudaSuccess) return err;
  const int ld = bprod::chain_ld(d);
  const int64_t elems = static_cast<int64_t>(ld) * k;
  float* work = nullptr;
  err = cudaMallocAsync(
      reinterpret_cast<void**>(&work),
      (2 * elems + static_cast<int64_t>(ld) * n) * sizeof(float), s);
  if (err != cudaSuccess) return err;
  float* xc = work + 2 * elems;
  auto* out = static_cast<uint32_t*>(codes);
  bilinear_hash_transpose_kernel<<<transpose_blocks(n, d, k),
                                   kTransposeThreads, 0, s>>>(
      fu, fv, work, work + elems, d, k, ld, static_cast<const float*>(x), xc,
      n, out, static_cast<int64_t>(n) * ((k + 31) / 32));
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = bprod::launch_product<Kernel>(p, xc, work, work + elems, out, n, d,
                                        k, 1, ld, k, s);
  }
  const cudaError_t freed = cudaFreeAsync(work, s);
  return err != cudaSuccess ? err : freed;
}

// The launches bh_launch makes for these arguments, without making them
// (launch_plan.cuh): the product's six numbers, or for the chain plan the
// transpose's and then the product's, into out[0..11].  Returns 0, or the
// error with which the launch refuses.
extern "C" int bh_plan(int n, int d, int k, int64_t* out) {
  if (n < 1 || d < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = bprod::device_sms(&sms);
  if (err != cudaSuccess) return err;
  const bprod::Plan p = bprod::choose_plan(n, k, 1, sms);
  if (p.tm == bprod::kChain) {
    lplan::put(out, transpose_blocks(n, d, k), 1, 1, kTransposeThreads, 0,
               0);
    out += 6;
  }
  bprod::put_plan(out, p);
  return 0;
}
