// The d-tiled float32 bilinear product shared by both hash kernels
// (bilinear_hash.cu: kernel 4, factors from the caller; bilinear_hash_seeded
// .cu: kernel 1, factors generated from seeds into a workspace first).
//
// For x (n, d) row-major and G tables of (d, k) factors U_g, V_g:
//
//   codes[g, i, w] bit j = ((x_i . u_gj) * (x_i . v_gj) >= 0),  j = 32 w + b
//
// for j < k; bits >= k are 0.
//
// Columns.  Each table's k columns are padded to kp = ceil(k / TN) TN (the
// pad columns read zero factors and give no bit), and the G tables' padded
// columns are laid side by side: C = G kp.  Column c of factor row r is
// f[r ld + c] for c < climit, else 0: the caller's (d, k) tensors for
// G = 1 (ld = climit = k), a (d, C) workspace for G > 1 (ld = climit = C).
// A thread owns TM rows x TN columns of both products, so no lane computes
// a column past k beyond that padding (none at k = 20, TN = 4).  A block
// takes a pass of at most 128 of the C columns (one pass at the serving
// shapes: the x slice is read once for all G tables) and as many rows as
// its 256 threads cover: ncg = cols / TN column groups, rg = min(256 / ncg,
// 256 / TM) row groups, br = rg TM rows.
//
// d is tiled by kTd = 32.  Shared memory holds a (kTd x br) x slice,
// transposed so a thread's TM rows are one vector load, and the (kTd x
// cols) slices of U and V, double-buffered: the slices of tile t + 1 are
// in flight while tile t is multiplied.  x goes by 4-byte cp.async (rows
// are 4 d bytes apart, not 16-byte aligned in general; each thread keeps
// one column of the tile and walks rows 8 apart, so a copy costs a few
// instructions), the factors by 16-byte cp.async where aligned.  Shared
// memory does not depend on d, so every d >= 1 launches.
//
// Arithmetic.  Strict float32: one accumulator per (row, column), fmaf in
// increasing d from 0.0f, no tensor cores and no split over d, so each
// product is the same sequence of roundings as a plain d-ordered loop and
// the codes do not depend on the tiling.  The operands of d + 1 are read
// from shared memory while the FMAs of d issue.  The sign bits of a block
// gather in shared words by atomicOr and go out once; a launch of several
// passes zeroes the codes first and ORs each pass's words in.
//
// Tiles (TM, TN) = (8, 4), (4, 4), (2, 2) or (1, 1): the launch takes the
// largest whose grid fills the card (at least one block per SM) with at
// least 90% of the threads busy, else the one with the most blocks (a
// micro-batch of 32 queries).  Two blocks per SM (<= 128 registers).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_plan.cuh"

namespace bprod {

constexpr int kThreads = 256;
constexpr int kTd = 32;                 // d per tile
constexpr int kMaxCols = 128;           // columns per pass
constexpr int kMaxRows = 256;           // rows per block

struct Plan {
  int tm, tn;          // thread tile
  int kp, cols;        // padded columns per table, all tables (G kp)
  int cpw, ncg;        // columns per pass, column groups per pass
  int rg, br;          // row groups, rows per block
  int brf;             // rows staged per block: br rounded up to 4
  int passes, row_blocks;
  int wspan;           // shared words per row of a pass's bits
  size_t smem;         // dynamic shared memory
};

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Shared layout of a stage: x slice [kTd][brp], U and V slices
// [kTd][cpwp]; brp = 4 mod 32, so the transposed 8-by-4 store pattern of
// the x copy hits 32 distinct banks.
__host__ __device__ inline int x_stride(int br) {
  return round_up(br, 32) + 4;
}
__host__ __device__ inline int f_stride(int cpw) { return round_up(cpw, 4); }
__host__ __device__ inline size_t stage_floats(int br, int cpw) {
  return static_cast<size_t>(kTd) * (x_stride(br) + 2 * f_stride(cpw));
}

// Word range [first, last] of the code words that the pass' columns
// [c0, c1) of the padded layout touch.
__host__ __device__ inline void pass_words(int c0, int c1, int kp, int words,
                                           int* first, int* last) {
  *first = (c0 / kp) * words + (c0 % kp) / 32;
  *last = ((c1 - 1) / kp) * words + ((c1 - 1) % kp) / 32;
}

inline Plan make_plan(int tm, int tn, int n, int k, int groups) {
  Plan p;
  p.tm = tm;
  p.tn = tn;
  p.kp = round_up(k, tn);
  p.cols = groups * p.kp;
  p.cpw = p.cols < kMaxCols ? p.cols : kMaxCols / tn * tn;
  p.ncg = p.cpw / tn;
  p.rg = kThreads / p.ncg;
  if (p.rg * tm > kMaxRows) p.rg = kMaxRows / tm;
  // no more row groups than the rows need
  const int need = (n + tm - 1) / tm;
  if (p.rg > need) p.rg = need;
  p.br = p.rg * tm;
  p.brf = round_up(p.br, 4);
  p.passes = (p.cols + p.cpw - 1) / p.cpw;
  p.row_blocks = (n + p.br - 1) / p.br;
  const int words = (k + 31) / 32;
  p.wspan = 0;
  for (int q = 0; q < p.passes; ++q) {
    const int c1 = (q + 1) * p.cpw < p.cols ? (q + 1) * p.cpw : p.cols;
    int f, l;
    pass_words(q * p.cpw, c1, p.kp, words, &f, &l);
    if (l - f + 1 > p.wspan) p.wspan = l - f + 1;
  }
  const size_t stages = 2 * stage_floats(p.brf, p.cpw) * sizeof(float);
  const size_t bits = static_cast<size_t>(p.br) * p.wspan * sizeof(uint32_t);
  p.smem = stages > bits ? stages : bits;
  return p;
}

// The largest tile whose grid fills the card and keeps at least 90% of a
// block's threads busy (k = 20 in one table leaves 96 of 256 idle at
// (8, 4)); else the largest whose grid fills the card; else the one with
// the most blocks.
inline Plan choose_plan(int n, int k, int groups, int sms) {
  const int tiles[4][2] = {{8, 4}, {4, 4}, {2, 2}, {1, 1}};
  Plan best{}, filled{};
  bool any_filled = false;
  int64_t best_blocks = -1;
  for (const auto& t : tiles) {
    const Plan p = make_plan(t[0], t[1], n, k, groups);
    const int64_t blocks = static_cast<int64_t>(p.passes) * p.row_blocks;
    if (blocks >= sms) {
      if (10 * p.rg * p.ncg >= 9 * kThreads) return p;
      if (!any_filled) filled = p;
      any_filled = true;
    }
    if (blocks > best_blocks) {
      best = p;
      best_blocks = blocks;
    }
  }
  return any_filled ? filled : best;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// Issue the copies of d tile [d0, d0 + kTd) into one stage: the x slice of
// rows [row0, row0 + brf) transposed to [kTd][brp], and the U / V slices of
// the pass' cpw columns [c0, c0 + cpw) to [kTd][cpwp] (cpwp: the stride of
// the plan's widest pass, which a narrower last pass keeps); factor column
// c of d row r is f[r ld + c], c < climit.  Out-of-range elements land as
// zeros (a 0-byte copy from a valid address).  The factors go in units of
// `unit` floats (4: 16-byte copies, where the launch found ld, climit,
// the columns and the pointers 16-byte aligned; else 1).  x goes in pieces of 8 consecutive d
// of one row, a warp's 4 pieces on 4 consecutive rows: 4 row pieces of 32
// bytes read, 32 banks written (brp = 4 mod 32).
__device__ __forceinline__ void fetch_stage(
    float* st, const float* __restrict__ x, const float* __restrict__ u,
    const float* __restrict__ v, int64_t row0, int n, int d, int d0,
    int ld, int climit, int c0, int cpw, int cpwp, int brf, int unit,
    int dd_t, int cl_t, int step_dd, int step_cl) {
  const int brp = x_stride(brf);
  float* xs = st;
  float* us = xs + kTd * brp;
  float* vs = us + kTd * cpwp;
  // element i = t + 256 m is (row r_t + 8 m, column xdd of the tile) with
  // q = i / 8: r = q % 4 + 4 (q / 16), xdd = 8 ((q / 4) % 4) + i % 8
  const int q0 = threadIdx.x >> 3;
  const int r_t = (q0 & 3) + ((q0 >> 4) << 2);
  const int xdd = ((q0 >> 2) & 3) * 8 + (threadIdx.x & 7);
  const bool d_in = d0 + xdd < d;
  const float* src = x + (row0 + r_t) * d + d0 + xdd;
  float* dst = xs + xdd * brp + r_t;
  const int64_t step = 8 * static_cast<int64_t>(d);
  for (int r = r_t; r < brf; r += 8, src += step, dst += 8) {
    const bool in = d_in && row0 + r < n;
    cp_async4(dst, in ? src : x, in);
  }
  // unit t + 256 m of the [kTd][cpw / unit] slices, its (dd, cl) stepped
  const int units = cpw / unit;
  for (int dd = dd_t, cl = cl_t; dd < kTd;) {
    const int c = c0 + cl * unit;
    const bool in = c < climit && d0 + dd < d;
    const int64_t off = static_cast<int64_t>(d0 + dd) * ld + c;
    if (unit == 4) {
      cp_async16(us + dd * cpwp + cl * 4, in ? u + off : u, in);
      cp_async16(vs + dd * cpwp + cl * 4, in ? v + off : v, in);
    } else {
      cp_async4(us + dd * cpwp + cl, in ? u + off : u, in);
      cp_async4(vs + dd * cpwp + cl, in ? v + off : v, in);
    }
    cl += step_cl;
    dd += step_dd;
    if (cl >= units) {
      cl -= units;
      ++dd;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One block of the product: rows [blockIdx.x br, ...), pass blockIdx.y.
// merge: the launch has several passes and codes were zeroed; OR the words
// in.  Otherwise the block owns whole words and stores them.
template <int TM, int TN>
__device__ __forceinline__ void product_block(
    float* smem, const float* __restrict__ x, const float* __restrict__ u,
    const float* __restrict__ v, uint32_t* __restrict__ codes, int n, int d,
    int k, int ld, int climit, const Plan p, bool merge) {
  const int words = (k + 31) >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * p.br;
  const int c0 = blockIdx.y * p.cpw;
  const int cpw_b = min(p.cpw, p.cols - c0);   // this pass' columns
  const int ncg_b = cpw_b / TN;
  const int brp = x_stride(p.brf), cpwp = f_stride(p.cpw);
  const size_t stage = stage_floats(p.brf, p.cpw);
  const int t = threadIdx.x;
  const int cg = t % p.ncg, rgi = t / p.ncg;
  const bool active = rgi < p.rg && cg < ncg_b;
  const int r0 = rgi * TM, cl0 = cg * TN;
  // 16-byte factor copies where every copy is aligned
  const int unit =
      ld % 4 == 0 && climit % 4 == 0 && p.cpw % 4 == 0 && p.cols % 4 == 0 &&
              (reinterpret_cast<uintptr_t>(u) & 15) == 0 &&
              (reinterpret_cast<uintptr_t>(v) & 15) == 0
          ? 4 : 1;
  // this thread's first factor unit of a stage and the step to its next
  const int units = cpw_b / unit;
  const int dd_t = t / units, cl_t = t % units;
  const int step_dd = kThreads / units, step_cl = kThreads % units;

  float au[TM][TN], av[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      au[i][j] = 0.0f;
      av[i][j] = 0.0f;
    }
  }
  const int tiles = (d + kTd - 1) / kTd;
  auto fetch = [&](int t) {
    fetch_stage(smem + (t & 1) * stage, x, u, v, row0, n, d, t * kTd, ld,
                climit, c0, cpw_b, cpwp, p.brf, unit, dd_t, cl_t, step_dd,
                step_cl);
  };
  fetch(0);
  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      // the other stage was last read by tile - 1, which a barrier closed
      fetch(tile + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* xs = smem + (tile & 1) * stage;
    const float* us = xs + kTd * brp;
    const float* vs = us + kTd * cpwp;
    const int len = min(kTd, d - tile * kTd);
    if (active) {
      // the operands of d + 1 load while d's FMAs issue
      float xr[TM], uc[TN], vc[TN];
      load_vec<TM>(xs + r0, xr);
      load_vec<TN>(us + cl0, uc);
      load_vec<TN>(vs + cl0, vc);
#pragma unroll 8
      for (int dd = 0; dd < len; ++dd) {
        const int nx = min(dd + 1, len - 1);
        float xn[TM], un[TN], vn[TN];
        load_vec<TM>(xs + nx * brp + r0, xn);
        load_vec<TN>(us + nx * cpwp + cl0, un);
        load_vec<TN>(vs + nx * cpwp + cl0, vn);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            au[i][j] = fmaf(xr[i], uc[j], au[i][j]);
            av[i][j] = fmaf(xr[i], vc[j], av[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) xr[i] = xn[i];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          uc[j] = un[j];
          vc[j] = vn[j];
        }
      }
    }
    __syncthreads();   // this stage is refilled by tile + 2
  }

  // the block's sign bits: shared words [br][span], then out
  uint32_t* wb = reinterpret_cast<uint32_t*>(smem);
  int wfirst, wlast;
  pass_words(c0, c0 + cpw_b, p.kp, words, &wfirst, &wlast);
  const int span = wlast - wfirst + 1;
  for (int i = t; i < p.br * span; i += kThreads) wb[i] = 0u;
  __syncthreads();
  if (active) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + cl0 + j;
      const int g = c / p.kp, jj = c - g * p.kp;
      if (jj >= k) continue;
      const int wl = g * words + (jj >> 5) - wfirst;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (row0 + r0 + i < n && au[i][j] * av[i][j] >= 0.0f) {
          atomicOr(&wb[(r0 + i) * span + wl], 1u << (jj & 31));
        }
      }
    }
  }
  __syncthreads();
  // word-major, row-minor: consecutive threads write consecutive rows
  for (int i = t; i < p.br * span; i += kThreads) {
    const int wl = i / p.br, r = i - wl * p.br;
    const int64_t gr = row0 + r;
    if (gr >= n) continue;
    const int gw = wfirst + wl;
    const int g = gw / words, w = gw - g * words;
    uint32_t* dst = codes + (static_cast<int64_t>(g) * n + gr) * words + w;
    const uint32_t bits = wb[r * span + wl];
    if (!merge) {
      *dst = bits;
    } else if (bits) {
      atomicOr(dst, bits);
    }
  }
}

// The multiprocessors of the current device, which choose_plan fills.
inline cudaError_t device_sms(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Writes the product launch of plan p as the *_plan exports give it
// (launch_plan.cuh).
inline void put_plan(int64_t* out, const Plan& p) {
  lplan::put(out, p.row_blocks, p.passes, 1, kThreads,
             static_cast<int64_t>(p.smem), 0);
}

// Launch the product of plan p on `stream` through the kernel K<TM,
// TN>::fn for p's tile: a __global__ function of (x, u, v, codes, n, d, k,
// ld, climit, p, merge) that calls product_block<TM, TN>.
template <template <int, int> class K>
cudaError_t launch_product(const Plan& p, const float* x, const float* u,
                           const float* v, uint32_t* codes, int n, int d,
                           int k, int groups, int ld, int climit,
                           cudaStream_t stream) {
  const bool merge = p.passes > 1;
  if (merge) {
    const size_t bytes =
        sizeof(uint32_t) * groups * static_cast<size_t>(n) * ((k + 31) / 32);
    cudaError_t err = cudaMemsetAsync(codes, 0, bytes, stream);
    if (err != cudaSuccess) return err;
  }
  auto run = [&](auto kern) -> cudaError_t {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(p.row_blocks, p.passes);
    kern<<<grid, kThreads, p.smem, stream>>>(x, u, v, codes, n, d, k, ld,
                                            climit, p, merge);
    return cudaGetLastError();
  };
  if (p.tm == 8) return run(K<8, 4>::fn);
  if (p.tm == 4) return run(K<4, 4>::fn);
  if (p.tm == 2) return run(K<2, 2>::fn);
  return run(K<1, 1>::fn);
}

}  // namespace bprod
