// One shard's part of the cutoff exchange: the distance histogram of its
// rows, then its share of the global top-l, in row order.
//
// Counterpart of the TPU kernel hamming_topk_hist_kernel
// (src/repro/kernels/hamming.py:429; bodies _topk_hist_kernel :354,
// _hist_select :271) as the JAX package's sharded scan runs it on each
// shard (core/search.py, _grouped_local_then_merge): count each query's
// distances into a histogram, find the cutoff, then keep the rows below it
// and the lowest rows at it, in row order.  Here the shards' histograms
// are summed on the index's card between the two passes (the cutoff
// exchange, core/search.py cutoff_exchange), so the count and the select
// are separate launches with the exchange between them:
//
// shard_hist_kernel     codes (G, R, W) and queries (G, B, W) -> each
//                       (group, query)'s histogram of 32 W + 1 distances
//                       over the first n_valid rows (int64, summed over
//                       blocks by atomics), and each row block's own
//                       histogram (int32), kept on the card for the select.
// shard_offsets_kernel  after the exchange, from the cutoff D and the rows
//                       at D this shard gives (take): for each row block,
//                       the rows below D and at D in the blocks before it;
//                       the output slots past the shard's count set to R.
// shard_select_kernel   each row block again: the rows below D, and the
//                       rows at D while fewer than take are kept before
//                       them, written in row order at their place.
//
// Output (G, B, width) int32: local rows ascending, then R in the slots
// past the (group, query)'s count.  Rows >= n_valid never count.
//
// What bounds them: G R B W popcounts against the codes read (4 G R W
// bytes) and the selected rows written (perfbench/costs_mesh.py,
// shard_select_bound).  At the four-card cell's shape (R = 19.8M, W = 1,
// B = 10) that is 2.0e8 popcounts, ~0.05 ms at 16 a clock per SM, against
// 79 MB of codes read once, ~0.024 ms; the codes are read twice here,
// once a pass.
//
// Design.  A block of 256 threads takes kBlockRows rows of one group and
// a chunk of queries (as many as 48 KB of shared memory hold with their
// bins).  The histogram pass counts into shared bins by atomicAdd (the
// distances of 20-bit codes crowd into a few bins, so lanes of a warp
// meet on one bin; the hardware serialises them).  The select pass walks
// its rows in steps of 256: per query, two warp ballots (below D, at D),
// each warp's two counts into shared memory (double-buffered, one barrier
// a step), and a row's place is the block's base, the rows below D before
// it, and min(rows at D before it, the rows at D this block may still
// take).  Rows therefore leave in row order without a sort or a scan of
// the whole shard.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_plan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockRows = 4096;
constexpr int kOffsetThreads = 1024;
constexpr size_t kSmemBudget = 48 * 1024;

__host__ __device__ inline int bins_of(int w) { return 32 * w + 1; }

// Queries a block of the histogram or select pass takes: as many as 48 KB
// of shared memory hold with their bins, at most nq.
int chunk_of(int w, int nq) {
  const size_t per = sizeof(int32_t) * (static_cast<size_t>(w) + bins_of(w));
  const int c = static_cast<int>(kSmemBudget / per);
  return c < nq ? c : nq;
}

int blocks_of(int n_valid) { return (n_valid + kBlockRows - 1) / kBlockRows; }

__device__ __forceinline__ int distance(const uint32_t* __restrict__ row,
                                        const uint32_t* qs, int w) {
  int d = 0;
  for (int j = 0; j < w; ++j) d += __popc(row[j] ^ qs[j]);
  return d;
}

__global__ void __launch_bounds__(kThreads)
shard_hist_kernel(const uint32_t* __restrict__ codes,
                  const uint32_t* __restrict__ queries,
                  int32_t* __restrict__ blocks,
                  unsigned long long* __restrict__ hist, int rows,
                  int n_valid, int w, int nq, int qb, int nblk) {
  extern __shared__ uint32_t smem[];
  const int bins = bins_of(w);
  const int g = blockIdx.y;
  const int q0 = blockIdx.z * qb;
  const int nb = min(qb, nq - q0);
  uint32_t* qs = smem;
  int* h = reinterpret_cast<int*>(smem + static_cast<size_t>(qb) * w);
  const uint32_t* gq = queries + (static_cast<int64_t>(g) * nq + q0) * w;
  for (int i = threadIdx.x; i < nb * w; i += kThreads) qs[i] = gq[i];
  for (int i = threadIdx.x; i < nb * bins; i += kThreads) h[i] = 0;
  __syncthreads();
  const uint32_t* gc = codes + static_cast<int64_t>(g) * rows * w;
  const int r0 = blockIdx.x * kBlockRows;
  const int r1 = min(r0 + kBlockRows, n_valid);
  for (int r = r0 + static_cast<int>(threadIdx.x); r < r1; r += kThreads) {
    if (w == 1) {   // the row's word once, in a register
      const uint32_t c = gc[r];
      for (int b = 0; b < nb; ++b) {
        atomicAdd(&h[b * bins + __popc(c ^ qs[b])], 1);
      }
    } else {
      const uint32_t* row = gc + static_cast<int64_t>(r) * w;
      for (int b = 0; b < nb; ++b) {
        atomicAdd(&h[b * bins + distance(row, qs + b * w, w)], 1);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * bins; i += kThreads) {
    const int b = i / bins;
    const int k = i - b * bins;
    const int64_t gqi = static_cast<int64_t>(g) * nq + q0 + b;
    const int v = h[i];
    blocks[(gqi * nblk + blockIdx.x) * bins + k] = v;
    if (v != 0) {
      atomicAdd(&hist[gqi * bins + k], static_cast<unsigned long long>(v));
    }
  }
}

// One block per (group, query): its row blocks' counts below and at the
// cutoff, an exclusive scan over the blocks, and the tail of its output.
__global__ void __launch_bounds__(kOffsetThreads)
shard_offsets_kernel(const int32_t* __restrict__ blocks,
                     const int32_t* __restrict__ cut,
                     const int64_t* __restrict__ take,
                     int2* __restrict__ offs, int32_t* __restrict__ out,
                     int nblk, int bins, int width, int rows) {
  __shared__ int2 warp_sum[kOffsetThreads / 32];
  __shared__ int total_below;
  const int64_t gq = blockIdx.x;
  const int dc = cut[gq];
  const int per = (nblk + kOffsetThreads - 1) / kOffsetThreads;
  const int b0 = min(static_cast<int>(threadIdx.x) * per, nblk);
  const int b1 = min(b0 + per, nblk);
  const int32_t* bh = blocks + gq * nblk * bins;
  int below = 0;
  int at = 0;
  for (int k = b0; k < b1; ++k) {
    const int32_t* hk = bh + static_cast<int64_t>(k) * bins;
    for (int d = 0; d < dc; ++d) below += hk[d];
    at += hk[dc];
  }
  // inclusive scan of (below, at) over the threads: within each warp by
  // shuffles, then over the warps' totals
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int ib = below;
  int ia = at;
  for (int o = 1; o < 32; o <<= 1) {
    const int vb = __shfl_up_sync(0xffffffffu, ib, o);
    const int va = __shfl_up_sync(0xffffffffu, ia, o);
    if (lane >= o) {
      ib += vb;
      ia += va;
    }
  }
  if (lane == 31) warp_sum[warp] = make_int2(ib, ia);
  __syncthreads();
  int eb = ib - below;
  int ea = ia - at;
  for (int k = 0; k < warp; ++k) {
    eb += warp_sum[k].x;
    ea += warp_sum[k].y;
  }
  if (threadIdx.x == kOffsetThreads - 1) total_below = eb + below;
  for (int k = b0; k < b1; ++k) {
    offs[gq * nblk + k] = make_int2(eb, ea);
    const int32_t* hk = bh + static_cast<int64_t>(k) * bins;
    for (int d = 0; d < dc; ++d) eb += hk[d];
    ea += hk[dc];
  }
  __syncthreads();
  const int count = total_below + static_cast<int>(take[gq]);
  int32_t* o = out + gq * width;
  for (int j = count + static_cast<int>(threadIdx.x); j < width;
       j += kOffsetThreads) {
    o[j] = rows;
  }
}

__global__ void __launch_bounds__(kThreads)
shard_select_kernel(const uint32_t* __restrict__ codes,
                    const uint32_t* __restrict__ queries,
                    const int32_t* __restrict__ cut,
                    const int64_t* __restrict__ take,
                    const int2* __restrict__ offs, int32_t* __restrict__ out,
                    int rows, int n_valid, int w, int nq, int qb, int nblk,
                    int width) {
  extern __shared__ uint32_t qs[];
  __shared__ int2 warp_n[2][kWarps];
  const int g = blockIdx.y;
  const int q0 = blockIdx.z * qb;
  const int nb = min(qb, nq - q0);
  const uint32_t* gq = queries + (static_cast<int64_t>(g) * nq + q0) * w;
  for (int i = threadIdx.x; i < nb * w; i += kThreads) qs[i] = gq[i];
  __syncthreads();
  const uint32_t* gc = codes + static_cast<int64_t>(g) * rows * w;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int r0 = blockIdx.x * kBlockRows;
  const int r1 = min(r0 + kBlockRows, n_valid);
  int buf = 0;
  for (int b = 0; b < nb; ++b) {
    const int64_t gqi = static_cast<int64_t>(g) * nq + q0 + b;
    const int dc = cut[gqi];
    const int2 o = offs[gqi * nblk + blockIdx.x];
    const int tk = static_cast<int>(take[gqi]);
    // rows at D this block may still take, and its first slot
    const int room = max(0, min(tk - o.y, kBlockRows));
    const int base = o.x + min(o.y, tk);
    int32_t* dst = out + gqi * width;
    int cb = 0;
    int ce = 0;
    for (int s = r0; s < r1; s += kThreads) {
      const int r = s + static_cast<int>(threadIdx.x);
      bool lo = false;
      bool eq = false;
      if (r < r1) {
        const int d = distance(gc + static_cast<int64_t>(r) * w,
                               qs + b * w, w);
        lo = d < dc;
        eq = d == dc;
      }
      const unsigned bl = __ballot_sync(0xffffffffu, lo);
      const unsigned be = __ballot_sync(0xffffffffu, eq);
      if (lane == 0) warp_n[buf][warp] = make_int2(__popc(bl), __popc(be));
      __syncthreads();
      int pb = __popc(bl & lt);
      int pe = __popc(be & lt);
      int tb = 0;
      int te = 0;
      for (int k = 0; k < kWarps; ++k) {
        const int2 v = warp_n[buf][k];
        if (k < warp) {
          pb += v.x;
          pe += v.y;
        }
        tb += v.x;
        te += v.y;
      }
      const int e = ce + pe;
      if (lo || (eq && e < room)) dst[base + cb + pb + min(e, room)] = r;
      cb += tb;
      ce += te;
      buf ^= 1;
    }
  }
}

struct Shape {
  int nblk, chunks, qb;
  size_t hist_smem, select_smem;
};

Shape shape_of(int n_valid, int w, int nq) {
  const int qb = chunk_of(w, nq);
  return {blocks_of(n_valid), (nq + qb - 1) / qb, qb,
          sizeof(uint32_t) * static_cast<size_t>(qb) * (w + bins_of(w)),
          sizeof(uint32_t) * static_cast<size_t>(qb) * w};
}

bool refuses(int g, int rows, int n_valid, int w, int nq) {
  return g < 1 || g > 65535 || nq < 1 || w < 1 || n_valid < 1 ||
         n_valid > rows || chunk_of(w, nq) < 1 ||
         (nq + chunk_of(w, nq) - 1) / chunk_of(w, nq) > 65535;
}

}  // namespace

// codes: (g, rows, w) uint32; queries: (g, nq, w) uint32; blocks: (g, nq,
// nblk, 32 w + 1) int32, nblk = ceil(n_valid / kBlockRows); hist: (g, nq,
// 32 w + 1) int64, zeroed by the caller.  Returns the cudaError_t of the
// launch.
extern "C" int shard_hist_launch(const void* codes, const void* queries,
                                 void* blocks, void* hist, int g, int rows,
                                 int n_valid, int w, int nq, void* stream) {
  if (refuses(g, rows, n_valid, w, nq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape sh = shape_of(n_valid, w, nq);
  shard_hist_kernel<<<dim3(sh.nblk, g, sh.chunks), kThreads, sh.hist_smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(codes),
      static_cast<const uint32_t*>(queries), static_cast<int32_t*>(blocks),
      static_cast<unsigned long long*>(hist), rows, n_valid, w, nq, sh.qb,
      sh.nblk);
  return static_cast<int>(cudaGetLastError());
}

// After the exchange.  blocks as shard_hist_launch wrote them; cut: (g,
// nq) int32; take: (g, nq) int64; offs: (g, nq, nblk) int2 scratch; out:
// (g, nq, width) int32.  Two launches on the stream: the offsets, then the
// select.  Returns the cudaError_t of the launches.
extern "C" int shard_select_launch(const void* codes, const void* queries,
                                   const void* blocks, const void* cut,
                                   const void* take, void* offs, void* out,
                                   int g, int rows, int n_valid, int w,
                                   int nq, int width, void* stream) {
  if (refuses(g, rows, n_valid, w, nq) || width < 1 ||
      static_cast<int64_t>(g) * nq > 2147483647) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape sh = shape_of(n_valid, w, nq);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  shard_offsets_kernel<<<g * nq, kOffsetThreads, 0, st>>>(
      static_cast<const int32_t*>(blocks), static_cast<const int32_t*>(cut),
      static_cast<const int64_t*>(take), static_cast<int2*>(offs),
      static_cast<int32_t*>(out), sh.nblk, bins_of(w), width, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  shard_select_kernel<<<dim3(sh.nblk, g, sh.chunks), kThreads,
                        sh.select_smem, st>>>(
      static_cast<const uint32_t*>(codes),
      static_cast<const uint32_t*>(queries),
      static_cast<const int32_t*>(cut), static_cast<const int64_t*>(take),
      static_cast<const int2*>(offs), static_cast<int32_t*>(out), rows,
      n_valid, w, nq, sh.qb, sh.nblk, width);
  return static_cast<int>(cudaGetLastError());
}

// The launches shard_hist_launch and shard_select_launch make for these
// arguments, without making them (launch_plan.cuh): hist, then offsets,
// then select, six int64s each.  Returns 0, or the error with which the
// launch refuses.
extern "C" int shard_select_plan(int g, int rows, int n_valid, int w, int nq,
                                 int width, int64_t* out) {
  if (refuses(g, rows, n_valid, w, nq) || width < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape sh = shape_of(n_valid, w, nq);
  lplan::put(out, sh.nblk, g, sh.chunks, kThreads,
             static_cast<int64_t>(sh.hist_smem), 0);
  lplan::put(out + 6, static_cast<int64_t>(g) * nq, 1, 1, kOffsetThreads, 0,
             0);
  lplan::put(out + 12, sh.nblk, g, sh.chunks, kThreads,
             static_cast<int64_t>(sh.select_smem), 0);
  return 0;
}
