// Seed-generated bilinear hash of n points into G tables, one launch.
//
// Replaces the TPU kernel bilinear_hash_seeded_kernel
// (src/repro/kernels/bilinear_hash.py:125, pallas_call at :141; bodies
// _seeded_kernel :89 and _pack_sign_bits :81).
//
//   codes[g, i, w] bit j = ((x_i . u_c) * (x_i . v_c) >= 0),  c = 32 w + j
//
// where U, V are the (d, 32 W) factors that seeds[g] denotes under the JAX
// package's counter-based generator (core.functions.seeded_gaussian): the
// integer stream is bit-exact, logf/cosf/sqrtf are the IEEE versions (built
// without --use_fast_math).  Only ceil(k/32)*32 columns are generated, not
// the TPU wrapper's k_pad = 128; bits >= k are written as 0.
//
// What bounds it: 4 n d k G float32 operations (two projections, FMA = 2)
// against one read of x (4 n d bytes); at the serving fit shape (n = 1.06M,
// d = 385, k = 20, G = 4) that is ~1.3e11 FLOP against 1.6 GB, so the card's
// float32 rate bounds it, not its memory.
//
// Design.  One block of 512 threads owns R rows of x and stages them once
// in shared memory for every table and every 32-column word, so x is read
// from device memory once.  For each (table, word) the block regenerates
// the U/V rows in 32-row chunks into shared memory (the factors are never
// read from memory) and lane j of each warp accumulates column j for R/16
// rows with plain float32 FMAs in d order: no tensor cores, since TF32
// would flip sign bits far from zero.  __ballot_sync packs the 32 sign bits
// of a row into its word, lane j = bit j.  R is the largest of 128, 64, 32,
// 16 whose x tile fits the 227 KB a block may use.  Later work: register
// blocking over columns, and sharing the generated factors across blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;              // U/V rows regenerated per stage
constexpr size_t kMaxSmem = 232448;     // 227 KB per block on sm_90
constexpr uint32_t kGold = 0x9E3779B9u;
constexpr uint32_t kFnv = 0x01000193u;

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

size_t smem_bytes(int rows, int d_pad) {
  return sizeof(float) * (static_cast<size_t>(rows) * d_pad + 2 * kChunk * 32);
}

template <int RPW>
__global__ void __launch_bounds__(kThreads)
bh_seeded_kernel(const float* __restrict__ x,
                 const uint32_t* __restrict__ seeds,
                 uint32_t* __restrict__ codes, int n, int d, int d_pad,
                 int k, int groups) {
  constexpr int kRows = RPW * kWarps;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);       // [kRows][d_pad]
  float* us = xs + static_cast<size_t>(kRows) * d_pad;  // [kChunk][32]
  float* vs = us + kChunk * 32;                      // [kChunk][32]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int words = (k + 31) >> 5;

  // Stage this block's rows once.  Columns past d and rows past n are
  // zero; the U/V rows past d are zero too, so padding adds exact zeros.
  for (int i = threadIdx.x; i < kRows * d_pad; i += kThreads) {
    const int r = i / d_pad;
    const int c = i - r * d_pad;
    const int64_t gr = row0 + r;
    xs[i] = (gr < n && c < d) ? x[gr * d + c] : 0.0f;
  }

  for (int g = 0; g < groups; ++g) {
    const uint32_t su = fmix32(seeds[g]);            // tag 0: U
    const uint32_t sv = fmix32(seeds[g] + kGold);    // tag 1: V
    for (int word = 0; word < words; ++word) {
      float acc_u[RPW], acc_v[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        acc_u[r] = 0.0f;
        acc_v[r] = 0.0f;
      }
      for (int d0 = 0; d0 < d; d0 += kChunk) {
        __syncthreads();   // x staged / the previous chunk consumed
        for (int i = threadIdx.x; i < kChunk * 32; i += kThreads) {
          const int dr = d0 + (i >> 5);
          const uint32_t col = static_cast<uint32_t>(word * 32 + (i & 31));
          const bool in = dr < d;
          us[i] = in ? seeded_gaussian(su, dr, col) : 0.0f;
          vs[i] = in ? seeded_gaussian(sv, dr, col) : 0.0f;
        }
        __syncthreads();
        const int len = min(kChunk, d_pad - d0);     // a multiple of 4
        for (int j = 0; j < len; j += 4) {
          float u[4], v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            u[q] = us[(j + q) * 32 + lane];
            v[q] = vs[(j + q) * 32 + lane];
          }
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const float4 xv = *reinterpret_cast<const float4*>(
                &xs[static_cast<size_t>(warp * RPW + r) * d_pad + d0 + j]);
            acc_u[r] = fmaf(xv.x, u[0], acc_u[r]);
            acc_v[r] = fmaf(xv.x, v[0], acc_v[r]);
            acc_u[r] = fmaf(xv.y, u[1], acc_u[r]);
            acc_v[r] = fmaf(xv.y, v[1], acc_v[r]);
            acc_u[r] = fmaf(xv.z, u[2], acc_u[r]);
            acc_v[r] = fmaf(xv.z, v[2], acc_v[r]);
            acc_u[r] = fmaf(xv.w, u[3], acc_u[r]);
            acc_v[r] = fmaf(xv.w, v[3], acc_v[r]);
          }
        }
      }
      const int rem = k - word * 32;
      const uint32_t mask = rem >= 32 ? 0xFFFFFFFFu : ((1u << rem) - 1u);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const uint32_t bits =
            __ballot_sync(0xFFFFFFFFu, acc_u[r] * acc_v[r] >= 0.0f);
        const int64_t gr = row0 + warp * RPW + r;
        if (lane == 0 && gr < n) {
          codes[(static_cast<int64_t>(g) * n + gr) * words + word] =
              bits & mask;
        }
      }
    }
  }
}

template <int RPW>
cudaError_t launch(const float* x, const uint32_t* seeds, uint32_t* codes,
                   int n, int d, int k, int groups, cudaStream_t stream) {
  constexpr int kRows = RPW * kWarps;
  const int d_pad = (d + 3) & ~3;
  const size_t smem = smem_bytes(kRows, d_pad);
  cudaError_t err = cudaFuncSetAttribute(
      bh_seeded_kernel<RPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (n + kRows - 1) / kRows;
  bh_seeded_kernel<RPW><<<blocks, kThreads, smem, stream>>>(
      x, seeds, codes, n, d, d_pad, k, groups);
  return cudaGetLastError();
}

}  // namespace

// Rows of x one block stages for width d (0: no tile fits).
extern "C" int bh_seeded_rows_per_block(int d) {
  const int d_pad = (d + 3) & ~3;
  for (int rpw = 8; rpw >= 1; rpw >>= 1) {
    if (smem_bytes(rpw * kWarps, d_pad) <= kMaxSmem) return rpw * kWarps;
  }
  return 0;
}

// x: (n, d) float32; seeds: (groups,) uint32; codes: (groups, n,
// ceil(k/32)) uint32.  Returns the cudaError_t of the launch.
extern "C" int bh_seeded_launch(const void* x, const void* seeds,
                                void* codes, int n, int d, int k,
                                int groups, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* sd = static_cast<const uint32_t*>(seeds);
  auto* out = static_cast<uint32_t*>(codes);
  auto s = static_cast<cudaStream_t>(stream);
  switch (bh_seeded_rows_per_block(d)) {
    case 8 * kWarps: return launch<8>(xf, sd, out, n, d, k, groups, s);
    case 4 * kWarps: return launch<4>(xf, sd, out, n, d, k, groups, s);
    case 2 * kWarps: return launch<2>(xf, sd, out, n, d, k, groups, s);
    case 1 * kWarps: return launch<1>(xf, sd, out, n, d, k, groups, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
