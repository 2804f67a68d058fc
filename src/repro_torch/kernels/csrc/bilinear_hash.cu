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
// strict float32 FMAs in d order.  Any d >= 1.

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
  bprod::product_block<TM, TN>(reinterpret_cast<float*>(smem4), x, u, v,
                               codes, n, d, k, ld, climit, p, merge);
}

template <int TM, int TN>
struct Kernel {
  static constexpr auto fn = bilinear_hash_kernel<TM, TN>;
};

}  // namespace

// x: (n, d) float32; u, v: (d, k) float32 row-major; codes: (n, ceil(k/32))
// uint32.  Returns the cudaError_t of the launch.
extern "C" int bh_launch(const void* x, const void* u, const void* v,
                         void* codes, int n, int d, int k, void* stream) {
  if (n < 1 || d < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = bprod::device_sms(&sms);
  if (err != cudaSuccess) return err;
  const bprod::Plan p = bprod::choose_plan(n, k, 1, sms);
  return bprod::launch_product<Kernel>(
      p, static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(v), static_cast<uint32_t*>(codes), n, d, k,
      1, k, k, static_cast<cudaStream_t>(stream));
}

// The launch bh_launch makes for these arguments, without making it
// (launch_plan.cuh).  Returns 0, or the error with
// which the launch refuses.
extern "C" int bh_plan(int n, int d, int k, int64_t* out) {
  if (n < 1 || d < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = bprod::device_sms(&sms);
  if (err != cudaSuccess) return err;
  bprod::put_plan(out, bprod::choose_plan(n, k, 1, sms));
  return 0;
}
