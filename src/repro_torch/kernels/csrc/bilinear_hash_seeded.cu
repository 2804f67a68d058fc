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
//      stays in L2): one thread per factor element, G d kp / 256 blocks; for
//      the chain plan column-major (kp = k, columns padded to 4 floats);
//  (b) the d-tiled product of bilinear_product.cuh over those factors,
//      each block looping over all G tables on its staged x slice, so x is
//      read once for all tables (one column pass while G kp <= 128).
// At a query shape (10-32 normals, too few rows for a tile to fill the
// card) the product takes the chain plan: a lane per (row, column), the
// d-ordered chains spread over the card.  Any d >= 1.

#include <cstdint>
#include <cuda_runtime.h>

#include "bilinear_product.cuh"

namespace {

constexpr uint32_t kGold = 0x9E3779B9u;
constexpr uint32_t kFnv = 0x01000193u;
constexpr int kGenThreads = 256;        // threads of a generation block

// Blocks of a generation launch over elems elements.
unsigned gen_blocks(int64_t elems) {
  return static_cast<unsigned>((elems + kGenThreads - 1) / kGenThreads);
}

// The generation's elements: the d G kp of U (and V), and for the chain
// plan the n d of x's copy.
int64_t gen_elems(const bprod::Plan& p, int n, int d) {
  return static_cast<int64_t>(d) * p.cols +
         (p.tm == bprod::kChain ? static_cast<int64_t>(n) * d : 0);
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
// for j < k, else 0.  For the chain plan (cm > 0) the same elements go
// column-major, column c at c cm (rows d .. cm are not written), the n
// rows of x are copied to xc at r cm, and the codes' zw words are zeroed:
// threads d G kp .. d G kp + n d copy x.
__global__ void __launch_bounds__(kGenThreads)
bh_seeded_generate_kernel(const uint32_t* __restrict__ seeds,
                          float* __restrict__ u, float* __restrict__ v,
                          int d, int k, int kp, int groups, int cm,
                          const float* __restrict__ x, float* __restrict__ xc,
                          int n, uint32_t* __restrict__ codes, int64_t zw) {
  const int cols = groups * kp;
  int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cm > 0) {
    for (int64_t i = e; i < zw; i += static_cast<int64_t>(gridDim.x) *
                                       blockDim.x) {
      codes[i] = 0u;
    }
    const int64_t f = static_cast<int64_t>(d) * cols;
    if (e >= f) {
      e -= f;
      if (e < static_cast<int64_t>(n) * d) {
        const int64_t r = e / d;
        xc[r * cm + (e - r * d)] = x[e];
      }
      return;
    }
  }
  if (e >= static_cast<int64_t>(d) * cols) return;
  // consecutive threads write consecutive elements of either layout
  const int64_t q = cm > 0 ? e / d : e / cols;
  const int row = static_cast<int>(cm > 0 ? e - q * d : q);
  const int c = static_cast<int>(cm > 0 ? q : e - q * cols);
  const int g = c / kp, j = c - g * kp;
  float fu = 0.0f, fv = 0.0f;
  if (j < k) {
    const uint32_t seed = seeds[g];
    fu = seeded_gaussian(fmix32(seed), row, j);           // tag 0: U
    fv = seeded_gaussian(fmix32(seed + kGold), row, j);   // tag 1: V
  }
  const int64_t at = cm > 0 ? static_cast<int64_t>(c) * cm + row : e;
  u[at] = fu;
  v[at] = fv;
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
  bprod::plan_block<TM, TN>(reinterpret_cast<float*>(smem4), x, u, v, codes,
                            n, d, k, ld, climit, p, merge);
}

template <int TM, int TN>
struct Kernel {
  static constexpr auto fn = bh_seeded_product_kernel<TM, TN>;
};

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
  int sms = 0;
  cudaError_t err = bprod::device_sms(&sms);
  if (err != cudaSuccess) return err;
  if ((err = bprod::keep_pool()) != cudaSuccess) return err;
  const bprod::Plan p = bprod::choose_plan(n, k, groups, sms);
  // the chain plan's factors column-major and x's rows, each padded to
  // chain_ld(d), and its codes zeroed
  const bool chain = p.tm == bprod::kChain;
  const int ld = chain ? bprod::chain_ld(d) : p.cols;
  const int64_t elems = static_cast<int64_t>(chain ? ld : d) * p.cols;
  const int64_t x_elems = chain ? static_cast<int64_t>(ld) * n : 0;
  float* work = nullptr;
  err = cudaMallocAsync(reinterpret_cast<void**>(&work),
                        (2 * elems + x_elems) * sizeof(float), s);
  if (err != cudaSuccess) return err;
  float* u = work;
  float* v = work + elems;
  float* xc = work + 2 * elems;
  const auto* fx = static_cast<const float*>(x);
  auto* out = static_cast<uint32_t*>(codes);
  bh_seeded_generate_kernel<<<gen_blocks(gen_elems(p, n, d)), kGenThreads, 0,
                              s>>>(
      static_cast<const uint32_t*>(seeds), u, v, d, k, p.kp, groups,
      chain ? ld : 0, fx, xc, n, out,
      static_cast<int64_t>(groups) * n * ((k + 31) / 32));
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = bprod::launch_product<Kernel>(p, chain ? xc : fx, u, v, out, n, d,
                                        k, groups, ld, p.cols, s);
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
  lplan::put(out, gen_blocks(gen_elems(p, n, d)), 1, 1, kGenThreads, 0, 0);
  bprod::put_plan(out + 6, p);
  return 0;
}
