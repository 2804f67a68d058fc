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
// least 90% of the threads busy, else the largest whose grid fills it,
// else the chain plan.  Two blocks per SM (<= 128 registers).
//
// The chain plan.  Where no tile's grid fills the card (a micro-batch of
// query normals), a tile's few blocks would each walk TM x TN x 2 chains
// of d FMAs one after another, a barrier every 32 d: at 20 normals of
// 26,215 features, 2 blocks on 132 SMs.  The chain plan spreads the 2 n G
// k chains over the card instead, one lane per chain (the u or the v
// product of one row and column), so a lane's FMAs wait only on each other
// and the FMA's latency paces it.  A block is kChainRows rows x kChainCols
// columns: one warp of their 32 chains and one warp that fills the ring;
// grid x the row groups, grid y the column groups.  Each SM so reads only
// 2 kChainCols factor columns and kChainRows x rows a d, which its share
// of L2's bandwidth carries at the chains' pace.  The chains read their
// operands as 16-byte runs in d from shared memory: the factors
// column-major and x's rows padded to 16 bytes (chain_ld), copies that the
// kernel before the product writes (the seeded generation, or kernel 4's
// transpose), which also zero the codes; each block ORs its bits in.
// Those runs stream through a ring of kChainStages stages of td d (td the
// largest of 512 .. 32 whose ring fits kChainSmem and the blocks an SM
// holds), one TMA bulk copy a row or column slice, completing on the
// stage's `full` mbarrier; the chains arrive on its `empty` one when done.
// The arithmetic is the tiles': each product one accumulator, fmaf in
// increasing d from 0.0f, so the codes equal the fill plans' bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "launch_plan.cuh"

namespace bprod {

constexpr int kThreads = 256;
constexpr int kTd = 32;                 // d per tile
constexpr int kMaxCols = 128;           // columns per pass
constexpr int kMaxRows = 256;           // rows per block
constexpr int kChain = 0;               // Plan::tm of the chain plan
constexpr int kChainStages = 4;         // stages of its ring
constexpr int kChainUnroll = 8;         // d of a group of a chain's FMAs
constexpr int kChainRows = 4;           // rows of a chain block
constexpr int kChainCols = 4;           // columns of a chain block (U and V)
constexpr size_t kChainSmem = 200 * 1024;   // its ring's budget
constexpr size_t kSmemPerSm = 233472;   // shared memory of an SM (sm_90)
constexpr size_t kSmemReserved = 1024;  // reserved per resident block

// A launch of the product.  The chain plan (tm = kChain) takes kp = k, a
// block's kChainCols columns as its pass (passes: the column groups) and
// its 2 kChainCols chains a row as its column groups (ncg).
struct Plan {
  int tm, tn;          // thread tile; tm = kChain: the chain plan
  int kp, cols;        // padded columns per table, all tables (G kp)
  int cpw, ncg;        // columns per pass, column groups per pass
  int rg, br;          // row groups, rows per block
  int brf;             // rows staged per block: br rounded up to 4
  int passes, row_blocks;
  int wspan;           // shared words per row of a pass's bits
  int threads;         // a block's
  int td;              // d per tile (a chain plan's stage)
  size_t smem;         // dynamic shared memory
};

__host__ __device__ constexpr int round_up(int a, int b) {
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
  p.threads = kThreads;
  p.td = kTd;
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

// The chain plan reads column-major factors and a copy of x, each column
// or row padded to chain_ld(d) floats, so a d-slice of one is one aligned
// bulk copy (the generation or transpose kernel before it writes them).
__host__ __device__ inline int chain_ld(int d) { return round_up(d, 4); }

// A chain block's shared memory: its mbarriers (full and empty a stage),
// then kChainStages stages, each its br x rows and its 2 kChainCols factor
// columns (U's, then V's) as runs of td + 4 floats, so a lane's operands
// are 16-byte runs in d; td + 4 = 4 (mod 32) puts the 8 lanes of a 16-byte
// load's phase on distinct banks.  Then slack for the loads that run past
// the last stage (chain_tile).
__host__ __device__ inline int chain_row(int td) { return td + 4; }
__host__ __device__ inline size_t chain_stage_floats(int td, int br) {
  return static_cast<size_t>(br + 2 * kChainCols) * chain_row(td);
}
constexpr int kChainHead = round_up(16 * kChainStages, 16);   // bytes
constexpr int kChainAhead = 3;   // groups a chain's loads run ahead
constexpr int kChainSlack = kChainAhead * kChainUnroll + 4;   // floats
inline size_t chain_smem(const Plan& p) {
  return kChainHead +
         (kChainStages * chain_stage_floats(p.td, p.br) + kChainSlack) *
             sizeof(float);
}

// The chain plan of n rows, k bits, G tables on `sms` SMs: blocks of
// kChainRows rows x kChainCols columns (grid x the row groups, grid y the
// column groups), one warp of their 32 chains and one that fills the
// ring.  Where the grid has more blocks than the card has SMs, the ring
// shrinks (td down to 32) until that many blocks an SM are resident.
inline Plan make_chain_plan(int n, int k, int groups, int sms) {
  Plan p{};
  p.tm = kChain;
  p.tn = 1;
  p.kp = k;
  p.cols = groups * k;
  p.cpw = kChainCols;
  p.ncg = 2 * kChainCols;
  p.br = p.rg = p.brf = n < kChainRows ? n : kChainRows;
  p.passes = (p.cols + kChainCols - 1) / kChainCols;
  p.row_blocks = (n + p.br - 1) / p.br;
  p.threads = 64;
  const int64_t blocks = static_cast<int64_t>(p.row_blocks) * p.passes;
  const int64_t per_sm = (blocks + sms - 1) / sms;
  size_t budget = kSmemPerSm / per_sm;
  budget = budget > kSmemReserved + kChainSmem ? kChainSmem
                                                : budget - kSmemReserved;
  for (p.td = 512; p.td > 32; p.td /= 2) {
    if (chain_smem(p) <= budget) break;
  }
  p.smem = chain_smem(p);
  return p;
}

// The largest tile whose grid fills the card and keeps at least 90% of a
// block's threads busy (k = 20 in one table leaves 96 of 256 idle at
// (8, 4)); else the largest whose grid fills the card; else the chain
// plan.
inline Plan choose_plan(int n, int k, int groups, int sms) {
  const int tiles[4][2] = {{8, 4}, {4, 4}, {2, 2}, {1, 1}};
  for (const auto& t : tiles) {
    const Plan p = make_plan(t[0], t[1], n, k, groups);
    const int64_t blocks = static_cast<int64_t>(p.passes) * p.row_blocks;
    if (blocks >= sms && 10 * p.rg * p.ncg >= 9 * kThreads) return p;
  }
  for (const auto& t : tiles) {
    const Plan p = make_plan(t[0], t[1], n, k, groups);
    if (static_cast<int64_t>(p.passes) * p.row_blocks >= sms) return p;
  }
  return make_chain_plan(n, k, groups, sms);
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

// -- the chain plan ----------------------------------------------------------

// The filling warp: fill stage `st` with tile d0, arriving on bar with the
// bytes of its copies.  Copy i < rows is x row row0 + i, then the block's
// ccols U columns and its ccols V columns, each d-slice [d0, d0 + len)
// one TMA bulk copy, read rounded up to whole 16 bytes (inside the row's
// or column's padding).
__device__ __forceinline__ void chain_fill(
    float* st, uint64_t* bar, const float* __restrict__ xc,
    const float* __restrict__ ut, const float* __restrict__ vt,
    int64_t row0, int rows, int c0, int ccols, int d, int ld, int d0,
    const Plan& p) {
  const int lane = threadIdx.x & 31;
  const int len = min(p.td, d - d0);
  const int row = chain_row(p.td);
  const uint32_t bytes = 4 * round_up(len, 4);
  const int copies = rows + 2 * ccols;
  if (lane == 0) bulk::mbar_arrive_tx(bar, copies * bytes);
  __syncwarp();
  bulk::fence_proxy_async();
  for (int i = lane; i < copies; i += 32) {
    const float* src;
    float* dst;
    if (i < rows) {
      src = xc + (row0 + i) * ld;
      dst = st + i * row;
    } else {
      const int j = i - rows, f = j / ccols, c = j - f * ccols;
      src = (f == 0 ? ut : vt) + static_cast<int64_t>(c0 + c) * ld;
      dst = st + (p.br + f * kChainCols + c) * row;
    }
    bulk::bulk_copy(dst, src + d0, bytes, bar);
  }
}

// A float, and four, of shared memory at byte address a.  Volatile: the
// loads stay where chain_tile puts them, ahead of the FMAs they feed.
__device__ __forceinline__ float lds(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

template <int N>
__device__ __forceinline__ void lds_run(uint32_t a, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v[i]), "=f"(v[i + 1]), "=f"(v[i + 2]),
                   "=f"(v[i + 3])
                 : "r"(a + 4 * i));
  }
}

template <int N>
__device__ __forceinline__ void chain_fma(const float (&xv)[N],
                                          const float (&fv)[N], float& acc) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc = fmaf(xv[j], fv[j], acc);
}

// A lane's chain over the len d of one stage: x at byte address xa, its
// factor column at fa, both runs of floats in d.  kChainAhead groups of
// kChainUnroll d are loaded ahead of the FMAs (16-byte loads, three
// register sets in turn), so a group's loads have two groups' FMAs' time
// to land; the last groups' loads read up to kChainAhead kChainUnroll
// floats past the slices, unused (kChainSlack).
__device__ __forceinline__ float chain_tile(uint32_t xa, uint32_t fa,
                                            int len, float acc) {
  constexpr int N = kChainUnroll;
  const int groups = len / N;
  if (groups > 0) {
    float x0[N], f0[N], x1[N], f1[N], x2[N], f2[N];
    lds_run(xa, x0);
    lds_run(fa, f0);
    lds_run(xa + 4 * N, x1);
    lds_run(fa + 4 * N, f1);
    lds_run(xa + 8 * N, x2);
    lds_run(fa + 8 * N, f2);
    uint32_t xn = xa + 12 * N, fn = fa + 12 * N;   // kChainAhead groups on
    auto step = [&](float (&xv)[N], float (&fv)[N]) {
      chain_fma(xv, fv, acc);
      lds_run(xn, xv);
      lds_run(fn, fv);
      xn += 4 * N;
      fn += 4 * N;
    };
    for (int g = 0;;) {
      step(x0, f0);
      if (++g == groups) break;
      step(x1, f1);
      if (++g == groups) break;
      step(x2, f2);
      if (++g == groups) break;
    }
  }
  for (int dd = groups * N; dd < len; ++dd) {
    acc = fmaf(lds(xa + 4 * dd), lds(fa + 4 * dd), acc);
  }
  return acc;
}

// One block of the chain plan: rows [blockIdx.x br, ...) and columns
// [blockIdx.y kChainCols, ...), from xc (x's rows at r ld) and the
// column-major factors ut, vt (column c at c ld, ld = chain_ld(d)).  Warp
// 1 fills the ring; lane t of warp 0 holds row t / 8's chain q = t % 8, U's
// column q for q < 4, else V's column q - 4.  A stage is refilled once the
// chains have arrived on its `empty` mbarrier.  The codes were zeroed
// before (by the kernel that wrote xc): each block ORs its bits in.
__device__ __forceinline__ void chain_block(
    float* smem, const float* __restrict__ xc, const float* __restrict__ ut,
    const float* __restrict__ vt, uint32_t* __restrict__ codes, int n, int d,
    int k, int ld, const Plan p) {
  constexpr int S = kChainStages;
  const int words = (k + 31) >> 5;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  float* ring = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) +
                                         kChainHead);
  const size_t stage = chain_stage_floats(p.td, p.br);
  const int row = chain_row(p.td);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * p.br;
  const int rows = static_cast<int>(min(static_cast<int64_t>(p.br),
                                        n - row0));
  const int c0 = blockIdx.y * kChainCols;
  const int ccols = min(kChainCols, p.cols - c0);
  const int t = threadIdx.x;
  const int r = t / (2 * kChainCols), q = t % (2 * kChainCols);
  const int c = q % kChainCols;
  const bool active = t < 32 && r < rows && c < ccols;
  const int tiles = (d + p.td - 1) / p.td;

  if (t == 0) {
    for (int i = 0; i < S; ++i) {
      bulk::mbar_init(full + i, 1);
      bulk::mbar_init(empty + i, 1);
    }
    bulk::fence_mbar_init();
  }
  __syncthreads();
  if (t >= 32) {
    for (int tile = 0; tile < tiles; ++tile) {
      const int s = tile % S;
      if (tile >= S) {
        bulk::mbar_wait(empty + s, static_cast<uint32_t>(tile / S - 1) & 1u);
      }
      chain_fill(ring + s * stage, full + s, xc, ut, vt, row0, rows, c0,
                 ccols, d, ld, tile * p.td, p);
    }
    return;
  }
  float acc = 0.0f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int s = tile % S;
    bulk::mbar_wait(full + s, static_cast<uint32_t>(tile / S) & 1u);
    const float* st = ring + s * stage;
    if (active) {
      acc = chain_tile(bulk::smem_addr(st + r * row),
                       bulk::smem_addr(st + (p.br + q) * row),
                       min(p.td, d - tile * p.td), acc);
    }
    __syncwarp();
    if (t == 0) bulk::mbar_arrive(empty + s);
  }
  // the U lane of (row, column) meets its V lane kChainCols lanes up
  const float av = __shfl_down_sync(0xffffffffu, acc, kChainCols);
  if (active && q < kChainCols && acc * av >= 0.0f) {
    const int col = c0 + c, g = col / k, j = col - g * k;
    atomicOr(codes + (static_cast<int64_t>(g) * n + row0 + r) * words +
                 (j >> 5),
             1u << (j & 31));
  }
}

// The block of plan p's kind: a tile's (product_block) or the chain plan's.
template <int TM, int TN>
__device__ __forceinline__ void plan_block(
    float* smem, const float* __restrict__ x, const float* __restrict__ u,
    const float* __restrict__ v, uint32_t* __restrict__ codes, int n, int d,
    int k, int ld, int climit, const Plan p, bool merge) {
  if constexpr (TM == kChain) {
    chain_block(smem, x, u, v, codes, n, d, k, ld, p);
  } else {
    product_block<TM, TN>(smem, x, u, v, codes, n, d, k, ld, climit, p,
                          merge);
  }
}

// Let the current device's default pool keep a launch's stream-ordered
// workspace (cudaMallocAsync) between calls, up to kPoolKeepBytes, instead
// of returning it at every synchronise.
constexpr uint64_t kPoolKeepBytes = 64ull << 20;
inline cudaError_t keep_pool() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= 64 || done[dev]) return err;
  cudaMemPool_t pool;
  if ((err = cudaDeviceGetDefaultMemPool(&pool, dev)) != cudaSuccess) {
    return err;
  }
  uint64_t keep = kPoolKeepBytes;
  err = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep);
  if (err == cudaSuccess) done[dev] = true;
  return err;
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
  lplan::put(out, p.row_blocks, p.passes, 1, p.threads,
             static_cast<int64_t>(p.smem), 0);
}

// Launch the product of plan p on `stream` through the kernel K<TM,
// TN>::fn for p's tile (K<kChain, kChain> for the chain plan): a
// __global__ function of (x, u, v, codes, n, d, k, ld, climit, p, merge)
// that calls plan_block<TM, TN>.  For the chain plan x is the padded copy
// of x's rows and u, v the column-major factors (ld = chain_ld(d), climit
// = p.cols), and the codes are zeroed already.
template <template <int, int> class K>
cudaError_t launch_product(const Plan& p, const float* x, const float* u,
                           const float* v, uint32_t* codes, int n, int d,
                           int k, int groups, int ld, int climit,
                           cudaStream_t stream) {
  const bool merge = p.passes > 1 && p.tm != kChain;
  if (p.tm == kChain && (ld != chain_ld(d) || climit != p.cols)) {
    return cudaErrorInvalidValue;
  }
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
    kern<<<grid, p.threads, p.smem, stream>>>(x, u, v, codes, n, d, k, ld,
                                              climit, p, merge);
    return cudaGetLastError();
  };
  if (p.tm == kChain) return run(K<kChain, kChain>::fn);
  if (p.tm == 8) return run(K<8, 4>::fn);
  if (p.tm == 4) return run(K<4, 4>::fn);
  if (p.tm == 2) return run(K<2, 2>::fn);
  return run(K<1, 1>::fn);
}

}  // namespace bprod
