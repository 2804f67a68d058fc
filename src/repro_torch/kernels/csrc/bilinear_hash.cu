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
// which regenerates the factors instead of reading them.
//
// What bounds it: 4 n d k float32 operations (two projections, FMA = 2)
// against one read of x (4 n d bytes) and the factors (8 d k bytes); at the
// single-table fit shape (n = 1.06M, d = 385, k = 20) that is ~3.3e10 FLOP
// against 1.6 GB, about 0.49 ms either way on an H100 SXM, so the card's
// float32 rate and its memory bound it about equally.
//
// Design.  One block of 512 threads owns R rows of x and stages them once
// in shared memory (coalesced), so x is read from device memory once.  For
// each 32-column word the block copies the U/V rows in 32-row chunks into
// shared memory and lane j of each warp accumulates column j for R/16 rows
// with plain float32 FMAs in d order: no tensor cores, since TF32 would
// flip sign bits far from zero.  __ballot_sync packs the 32 sign bits of a
// row into its word, lane j = bit j; columns past k read zero factors and
// are masked to 0.  R is the largest of 64, 32, 16 whose x tile fits
// 112 KB, so two blocks share an SM and one block's staging overlaps the
// other's FMAs (wider rows take R = 16 in up to 227 KB, one block per
// SM).  Later work: register blocking over columns (k = 20 uses 20 of 32
// lanes), and a pipelined x tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                 // U/V rows staged per step
constexpr size_t kTileSmem = 114688;       // 112 KB: two blocks per SM
constexpr size_t kMaxSmem = 232448;        // 227 KB per block on sm_90

size_t smem_bytes(int rows, int d_pad) {
  return sizeof(float) * (static_cast<size_t>(rows) * d_pad + 2 * kChunk * 32);
}

template <int RPW>
__global__ void __launch_bounds__(kThreads, 2)
bilinear_hash_kernel(const float* __restrict__ x,
                     const float* __restrict__ u,
                     const float* __restrict__ v,
                     uint32_t* __restrict__ codes, int n, int d, int d_pad,
                     int k) {
  constexpr int kRows = RPW * kWarps;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);          // [kRows][d_pad]
  float* us = xs + static_cast<size_t>(kRows) * d_pad;  // [kChunk][32]
  float* vs = us + kChunk * 32;                         // [kChunk][32]
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
        const int col = word * 32 + (i & 31);
        const bool in = dr < d && col < k;
        us[i] = in ? u[static_cast<int64_t>(dr) * k + col] : 0.0f;
        vs[i] = in ? v[static_cast<int64_t>(dr) * k + col] : 0.0f;
      }
      __syncthreads();
      const int len = min(kChunk, d_pad - d0);     // a multiple of 4
      for (int j = 0; j < len; j += 4) {
        float uu[4], vv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uu[q] = us[(j + q) * 32 + lane];
          vv[q] = vs[(j + q) * 32 + lane];
        }
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(
              &xs[static_cast<size_t>(warp * RPW + r) * d_pad + d0 + j]);
          acc_u[r] = fmaf(xv.x, uu[0], acc_u[r]);
          acc_v[r] = fmaf(xv.x, vv[0], acc_v[r]);
          acc_u[r] = fmaf(xv.y, uu[1], acc_u[r]);
          acc_v[r] = fmaf(xv.y, vv[1], acc_v[r]);
          acc_u[r] = fmaf(xv.z, uu[2], acc_u[r]);
          acc_v[r] = fmaf(xv.z, vv[2], acc_v[r]);
          acc_u[r] = fmaf(xv.w, uu[3], acc_u[r]);
          acc_v[r] = fmaf(xv.w, vv[3], acc_v[r]);
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
        codes[gr * words + word] = bits & mask;
      }
    }
  }
}

template <int RPW>
cudaError_t launch(const float* x, const float* u, const float* v,
                   uint32_t* codes, int n, int d, int k,
                   cudaStream_t stream) {
  constexpr int kRows = RPW * kWarps;
  const int d_pad = (d + 3) & ~3;
  const size_t smem = smem_bytes(kRows, d_pad);
  cudaError_t err = cudaFuncSetAttribute(
      bilinear_hash_kernel<RPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (n + kRows - 1) / kRows;
  bilinear_hash_kernel<RPW><<<blocks, kThreads, smem, stream>>>(
      x, u, v, codes, n, d, d_pad, k);
  return cudaGetLastError();
}

}  // namespace

// Rows of x one block stages for width d (0: no tile fits).  Wide rows
// that leave no room for two blocks per SM take one block of 16 rows.
extern "C" int bh_rows_per_block(int d) {
  const int d_pad = (d + 3) & ~3;
  for (int rpw = 4; rpw >= 1; rpw >>= 1) {
    if (smem_bytes(rpw * kWarps, d_pad) <= kTileSmem) return rpw * kWarps;
  }
  return smem_bytes(kWarps, d_pad) <= kMaxSmem ? kWarps : 0;
}

// x: (n, d) float32; u, v: (d, k) float32 row-major; codes: (n, ceil(k/32))
// uint32.  Returns the cudaError_t of the launch.
extern "C" int bh_launch(const void* x, const void* u, const void* v,
                         void* codes, int n, int d, int k, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* uf = static_cast<const float*>(u);
  const auto* vf = static_cast<const float*>(v);
  auto* out = static_cast<uint32_t*>(codes);
  auto s = static_cast<cudaStream_t>(stream);
  switch (bh_rows_per_block(d)) {
    case 4 * kWarps: return launch<4>(xf, uf, vf, out, n, d, k, s);
    case 2 * kWarps: return launch<2>(xf, uf, vf, out, n, d, k, s);
    case 1 * kWarps: return launch<1>(xf, uf, vf, out, n, d, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
