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
// m = 1000, ~1.2 us at 3.35 TB/s) against 2 m^2 FLOP, so the memory.  In
// the learner's step loop R stays the same for a bit's 150 steps and sits
// in the 50 MB L2, so at m = 1000 the latency of one launch's few memory
// rounds is what is left.
//
// Design.  No padding (the TPU wrapper pads m to its row block).
// - The grid is one block per SM (fewer when m is smaller), each block a
//   contiguous range of m / grid rows, so every SM streams rows of R.
// - A block's 8 warps take its rows 8 at a time, a row a warp, and walk
//   the columns in chunks of 1,024: lane j holds the 16-byte slots j,
//   j + 32, ... of a chunk (8 a row), so at m = 1,000 each warp has its
//   whole 4 KB row in flight as 8 independent 16-byte loads a lane.  Two
//   rows a warp (4 warps a block, the same 8 rows) measured slower on the
//   H100 (3.20 against 2.70 us at m = 1,000): the rows of an SM are
//   fixed by m / 132, and 8 warps hide the tanhf and the reduction better
//   than 4.  Rows start 16-byte aligned when m % 4 == 0; otherwise the
//   same slots are read by 4-byte loads.
// - Each thread first loads the p, q of its share of the first chunk's
//   columns, then issues the chunk's R loads, then computes b (tanhf)
//   into shared memory: p and q arrive ahead of the R stream, so b is
//   ready while R is still in flight.  With more than one chunk, the next
//   chunk's loads and b are issued before the current chunk's FMAs
//   (registers and a shared b double buffer).  Shared memory does not grow
//   with m: any m runs.  A row's own p, q come with its first chunk, and
//   its b is computed while the row is in flight.
// - Each row's sum has one fixed order (per lane four partial sums, one
//   per slot component, over the slots in order; then (0 + 1) + (2 + 3);
//   then a shuffle tree), so repeated runs give the same bits.  tanhf is
//   the IEEE-accurate one (no --use_fast_math).

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_plan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 1;                    // rows of R a warp holds at once
constexpr int kBlockRows = kWarps * kRows;  // rows of a block at once
constexpr int kSlots = 8;                   // 16-byte slots of a lane a row
constexpr int kCols = 32 * 4 * kSlots;      // columns of a chunk

constexpr int kPerThread = kCols / kThreads;  // b entries a thread makes

// A step's R slots of this warp's rows (zeros past m and past the block's
// rows) and, with a pass's first chunk, the rows' own p and q.
struct Rows {
  float4 v[kRows][kSlots];
  float p[kRows], q[kRows];
};

// This thread's p, q of chunk c (the columns it makes b for).
struct Pq {
  float p[kPerThread], q[kPerThread];
};

__device__ __forceinline__ void load_pq(Pq& a, const float* __restrict__ p,
                                        const float* __restrict__ q, int m,
                                        int c) {
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int col = c * kCols + e * kThreads + threadIdx.x;
    a.p[e] = col < m ? __ldg(p + col) : 0.0f;
    a.q[e] = col < m ? __ldg(q + col) : 0.0f;
  }
}

// b of the chunk whose p, q are in a, into bs (zeros past m).
__device__ __forceinline__ void make_b(float* bs, const Pq& a) {
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    bs[e * kThreads + threadIdx.x] = tanhf(0.5f * a.p[e] * a.q[e]);
  }
}

template <bool kVec>
__device__ __forceinline__ void load_rows(Rows& rw,
                                          const float* __restrict__ p,
                                          const float* __restrict__ q,
                                          const float* __restrict__ r,
                                          int m, int row0, int hi, int c) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + i;
    if (c == 0) {
      rw.p[i] = row < hi ? __ldg(p + row) : 0.0f;
      rw.q[i] = row < hi ? __ldg(q + row) : 0.0f;
    }
    const float* rr = r + static_cast<int64_t>(row) * m;
    auto& v = rw.v;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int col = c * kCols + (k * 32 + lane) * 4;
      if constexpr (kVec) {
        v[i][k] = row < hi && col < m
                      ? __ldg(reinterpret_cast<const float4*>(rr + col))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        const bool ok = row < hi;
        v[i][k].x = ok && col < m ? __ldg(rr + col) : 0.0f;
        v[i][k].y = ok && col + 1 < m ? __ldg(rr + col + 1) : 0.0f;
        v[i][k].z = ok && col + 2 < m ? __ldg(rr + col + 2) : 0.0f;
        v[i][k].w = ok && col + 3 < m ? __ldg(rr + col + 3) : 0.0f;
      }
    }
  }
}

__device__ __forceinline__ void fma_rows(float (&acc)[kRows][4],
                                         const Rows& rw, const float* bs) {
  const auto& v = rw.v;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const float4 b = reinterpret_cast<const float4*>(bs)[k * 32 + lane];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      acc[i][0] = fmaf(v[i][k].x, b.x, acc[i][0]);
      acc[i][1] = fmaf(v[i][k].y, b.y, acc[i][1]);
      acc[i][2] = fmaf(v[i][k].z, b.z, acc[i][2]);
      acc[i][3] = fmaf(v[i][k].w, b.w, acc[i][3]);
    }
  }
}

// The rows' sums (fixed order), then lane 0 finishes each row's chain
// from the rows' p, q and b.
__device__ __forceinline__ void finish_rows(
    float (&acc)[kRows][4], const float (&rp)[kRows],
    const float (&rq)[kRows], const float (&rb)[kRows],
    float* __restrict__ sq, float* __restrict__ sp, int row0, int hi) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float t = (acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      t += __shfl_xor_sync(0xFFFFFFFFu, t, off);
    }
    const int row = row0 + i;
    if (lane == 0 && row < hi) {
      const float s = t * (1.0f - rb[i] * rb[i]);
      sq[row] = s * rq[i];
      sp[row] = s * rp[i];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
lbh_chain_kernel(const float* __restrict__ p, const float* __restrict__ q,
                 const float* __restrict__ r, float* __restrict__ sq,
                 float* __restrict__ sp, int m) {
  __shared__ __align__(16) float bs[2][kCols];
  const int warp = threadIdx.x >> 5;
  const int lo = static_cast<int>(static_cast<int64_t>(blockIdx.x) * m /
                                  gridDim.x);
  const int hi = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * m /
                                  gridDim.x);
  const int nch = (m + kCols - 1) / kCols;
  const int steps = (hi - lo + kBlockRows - 1) / kBlockRows * nch;
  // first row of this warp in step st
  auto row0 = [&](int st) { return lo + st / nch * kBlockRows + warp * kRows; };
  Rows a, nb;
  Pq pq;
  float acc[kRows][4] = {};
  // the current pass's rows' p, q and b (b while the rows are in flight)
  float rp[kRows], rq[kRows], rb[kRows];
  // one step: the next step's loads (and b, with several chunks) first,
  // then this step's FMAs; `cur` holds this step's slots
  auto step = [&](int st, Rows& cur, Rows& nxt) {
    if (st % nch == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        rp[i] = cur.p[i];
        rq[i] = cur.q[i];
        rb[i] = tanhf(0.5f * rp[i] * rq[i]);
      }
    }
    if (st + 1 < steps) {
      const int c1 = (st + 1) % nch;
      if (nch > 1) load_pq(pq, p, q, m, c1);
      load_rows<kVec>(nxt, p, q, r, m, row0(st + 1), hi, c1);
      if (nch > 1) make_b(bs[(st + 1) & 1], pq);
    }
    fma_rows(acc, cur, bs[nch > 1 ? st & 1 : 0]);
    if (st % nch == nch - 1) {
      finish_rows(acc, rp, rq, rb, sq, sp, row0(st), hi);
    }
    // the next chunk's b is in place, this one's may be refilled
    if (nch > 1) __syncthreads();
  };
  load_pq(pq, p, q, m, 0);
  if (steps > 0) load_rows<kVec>(a, p, q, r, m, row0(0), hi, 0);
  make_b(bs[0], pq);
  __syncthreads();
  for (int st = 0; st < steps; st += 2) {
    step(st, a, nb);
    if (st + 1 < steps) step(st + 1, nb, a);
  }
}

// The grid of a launch: a block per multiprocessor, at most one per row.
cudaError_t chain_blocks(int m, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = m < sms ? m : sms;
  return cudaSuccess;
}

}  // namespace

// p, q: (m,) float32; r: (m, m) float32 row-major; sq, sp: (m,) float32.
// Any m >= 1.  Returns the cudaError_t of the launch.
extern "C" int lbh_chain_launch(const void* p, const void* q, const void* r,
                                void* sq, void* sp, int m, void* stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = chain_blocks(m, &blocks);
  if (err != cudaSuccess) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto pp = static_cast<const float*>(p);
  const auto qq = static_cast<const float*>(q);
  const auto rr = static_cast<const float*>(r);
  const auto oq = static_cast<float*>(sq);
  const auto op = static_cast<float*>(sp);
  if (m % 4 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0) {
    lbh_chain_kernel<true><<<blocks, kThreads, 0, st>>>(pp, qq, rr, oq, op, m);
  } else {
    lbh_chain_kernel<false><<<blocks, kThreads, 0, st>>>(pp, qq, rr, oq, op,
                                                         m);
  }
  return cudaGetLastError();
}

// The launch lbh_chain_launch makes for m, without making it
// (launch_plan.cuh; no dynamic shared memory: the kernel's is static).  Returns 0, or the error with which the launch refuses.
extern "C" int lbh_chain_plan(int m, int64_t* out) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = chain_blocks(m, &blocks);
  if (err != cudaSuccess) return err;
  lplan::put(out, blocks, 1, 1, kThreads, 0, 0);
  return 0;
}
