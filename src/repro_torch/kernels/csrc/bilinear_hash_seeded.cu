// Seed-generated bilinear hash of n points into G tables, one call.
//
// Replaces the TPU kernel bilinear_hash_seeded_kernel
// (src/repro/kernels/bilinear_hash.py:125, pallas_call at :141; bodies
// _seeded_kernel :89 and _pack_sign_bits :81).
//
//   codes[g, i, w] bit j = ((x_i . u_c) * (x_i . v_c) >= 0),  c = 32 w + j
//
// where U, V are the (d, k) factors that seeds[g] denotes under the JAX
// package's counter-based generator (core.functions.seeded_gaussian): the
// integer stream is bit-exact, logf/cosf/sqrtf are the IEEE versions (built
// without --use_fast_math).  Bits >= k are written as 0.
//
// What bounds it: 4 n d k G float32 operations (two projections, FMA = 2)
// against one read of x (4 n d bytes); at the serving fit shape (n = 1.06M,
// d = 385, k = 20, G = 4) that is ~1.3e11 FLOP against 1.6 GB, so the card's
// float32 rate bounds it, not its memory.  Generating the factors is
// 2 G d k Gaussians, once per call.
//
// Design, two kernels on the caller's stream:
//  (a) bh_seeded_generate_kernel writes every table's U and V, side by side
//      as (d, G kp) with the pad columns zero (kp = k rounded up to the
//      product's column tile), into a stream-ordered workspace
//      (cudaMallocAsync; 2 G d kp floats, 246 KB at the serving shape, so it
//      stays in L2): one thread per factor element, G d kp / 256 blocks;
//  (b) the d-tiled product of bilinear_product.cuh over those factors,
//      each block looping over all G tables on its staged x slice, so x is
//      read once for all tables (one column pass while G kp <= 128).
// At the query shape (32 rows) the product takes the (1, 1) thread tile and
// splits the 80 columns and the rows over several blocks.  Any d >= 1.

#include <cstdint>
#include <cuda_runtime.h>

#include "bilinear_product.cuh"

namespace {

constexpr uint32_t kGold = 0x9E3779B9u;
constexpr uint32_t kFnv = 0x01000193u;
// the workspace pool keeps this much freed memory for the next call
constexpr uint64_t kPoolKeepBytes = 64ull << 20;
constexpr int kGenThreads = 256;        // threads of a generation block

// Blocks of a generation launch over elems factor elements of U (and V).
unsigned gen_blocks(int64_t elems) {
  return static_cast<unsigned>((elems + kGenThreads - 1) / kGenThreads);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// N(0, 1) at absolute (row, col) of the matrix whose mixed seed is s.
__device__ __forceinline__ float seeded_gaussian(uint32_t s, uint32_t row,
                                                 uint32_t col) {
  uint32_t h = fmix32(s ^ (row * kFnv));
  h = fmix32(h ^ col);
  const uint32_t b1 = fmix32(h ^ 0x632BE59Bu);
  const uint32_t b2 = fmix32(h ^ 0x2545F491u);
  const float u1 = (__uint2float_rn(b1 >> 8) + 0.5f) * 0x1p-24f;
  const float u2 = (__uint2float_rn(b2 >> 8) + 0.5f) * 0x1p-24f;
  const float r = sqrtf(-2.0f * logf(u1));
  return r * cosf(0x1.921fb6p+2f * u2);   // float32(2 pi)
}

// u, v: (d, G kp); element (row, g kp + j) is table g's factor (row, j)
// for j < k, else 0.
__global__ void __launch_bounds__(kGenThreads)
bh_seeded_generate_kernel(const uint32_t* __restrict__ seeds,
                          float* __restrict__ u, float* __restrict__ v,
                          int d, int k, int kp, int groups) {
  const int cols = groups * kp;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= static_cast<int64_t>(d) * cols) return;
  const int row = static_cast<int>(e / cols);
  const int c = static_cast<int>(e - static_cast<int64_t>(row) * cols);
  const int g = c / kp, j = c - g * kp;
  float fu = 0.0f, fv = 0.0f;
  if (j < k) {
    const uint32_t seed = seeds[g];
    fu = seeded_gaussian(fmix32(seed), row, j);           // tag 0: U
    fv = seeded_gaussian(fmix32(seed + kGold), row, j);   // tag 1: V
  }
  u[e] = fu;
  v[e] = fv;
}

template <int TM, int TN>
__global__ void __launch_bounds__(bprod::kThreads, 2)
bh_seeded_product_kernel(const float* __restrict__ x,
                         const float* __restrict__ u,
                         const float* __restrict__ v,
                         uint32_t* __restrict__ codes, int n, int d, int k,
                         int ld, int climit, const bprod::Plan p,
                         bool merge) {
  extern __shared__ float4 smem4[];
  bprod::product_block<TM, TN>(reinterpret_cast<float*>(smem4), x, u, v,
                               codes, n, d, k, ld, climit, p, merge);
}

template <int TM, int TN>
struct Kernel {
  static constexpr auto fn = bh_seeded_product_kernel<TM, TN>;
};

// Let the device's default pool keep the workspace between calls instead
// of returning it at every synchronise.
cudaError_t keep_pool(int dev) {
  static bool done[64] = {};
  if (dev < 0 || dev >= 64 || done[dev]) return cudaSuccess;
  cudaMemPool_t pool;
  cudaError_t err = cudaDeviceGetDefaultMemPool(&pool, dev);
  if (err != cudaSuccess) return err;
  uint64_t keep = kPoolKeepBytes;
  err = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

}  // namespace

// x: (n, d) float32; seeds: (groups,) uint32 on the device; codes:
// (groups, n, ceil(k/32)) uint32.  Returns the cudaError_t of the first
// step that failed (workspace, generation, product), else 0.
extern "C" int bh_seeded_launch(const void* x, const void* seeds,
                                void* codes, int n, int d, int k,
                                int groups, void* stream) {
  if (n < 1 || d < 1 || k < 1 || groups < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = bprod::device_sms(&sms)) != cudaSuccess) return err;
  if ((err = keep_pool(dev)) != cudaSuccess) return err;
  const bprod::Plan p = bprod::choose_plan(n, k, groups, sms);
  const int64_t elems = static_cast<int64_t>(d) * p.cols;
  float* work = nullptr;
  err = cudaMallocAsync(reinterpret_cast<void**>(&work),
                        2 * elems * sizeof(float), s);
  if (err != cudaSuccess) return err;
  float* u = work;
  float* v = work + elems;
  bh_seeded_generate_kernel<<<gen_blocks(elems), kGenThreads, 0, s>>>(
      static_cast<const uint32_t*>(seeds), u, v, d, k, p.kp, groups);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = bprod::launch_product<Kernel>(
        p, static_cast<const float*>(x), u, v, static_cast<uint32_t*>(codes),
        n, d, k, groups, p.cols, p.cols, s);
  }
  const cudaError_t freed = cudaFreeAsync(work, s);
  return err != cudaSuccess ? err : freed;
}

// The two launches bh_seeded_launch makes for these arguments, without
// making them: the generation's six numbers (launch_plan.cuh), then the
// product's, into out[0..11].  Returns 0, or the error with which
// the launch refuses.
extern "C" int bh_seeded_plan(int n, int d, int k, int groups, int64_t* out) {
  if (n < 1 || d < 1 || k < 1 || groups < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  const cudaError_t err = bprod::device_sms(&sms);
  if (err != cudaSuccess) return err;
  const bprod::Plan p = bprod::choose_plan(n, k, groups, sms);
  lplan::put(out, gen_blocks(static_cast<int64_t>(d) * p.cols), 1, 1,
             kGenThreads, 0, 0);
  bprod::put_plan(out + 6, p);
  return 0;
}
