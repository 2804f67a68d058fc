// Fused Hamming scan + histogram top-l select over G stacked code groups,
// in two kernels with one contract.
//
// topk_hist_kernel replaces the TPU kernel hamming_topk_hist_kernel with
// dma=False (src/repro/kernels/hamming.py:429, pallas_call at :475; bodies
// _topk_hist_kernel :354, _popcount_tile :261, _hist_select :271,
// _pack_cand :345, cand_encoding :83).  topk_hist_dma_kernel replaces the
// same function with dma=True (pallas_call at :496; body
// _topk_hist_dma_kernel :375), whose code tiles stream through a
// double-buffered HBM -> VMEM async copy.
//
// For each (group g, row block of block_n rows) and each of the group's B
// queries both emit the exact block-local smallest-t set, t = min(l, live
// rows in the block), ties to the lowest row, as (distance, block-local
// row) pairs in ROW order; slots past t carry (pack sentinel, block_n - 1).
// Rows >= n or with active == 0 never qualify.  The same contract as the
// TPU kernel, so the merge in kernels/ops.py is shared by both kernels and
// by the plain version, and the two kernels' outputs are identical.
//
// What bounds them: G n B W XOR + popcount operations against one read of
// the codes (4 G n W bytes).  At the serving query shape (G = 4, n = 1.06M,
// W = 1, B = 32) that is 1.4e8 popcounts (16 per clock per SM) against
// 17 MB, so the popcount rate bounds them, not the memory.
//
// Design.  The TPU kernel keeps an (block_n, B) int32 distance tile in
// VMEM: 512 KB at block_n = 4096, above the 227 KB a block may have here.
// These kernels keep the distances of a chunk of at most 8 queries instead,
// as bytes (32 KB at block_n = 4096), and select from them in one pass
// (hamming_select.cuh): each (row, query) distance is computed once, the
// histogram needs no atomic that anything waits for, the compaction reads
// distances back from shared memory into a shared list of kept rows, and
// the list goes out in coalesced stores.

// topk_hist_kernel runs one block of 256 threads per (group, row block,
// query chunk), so a scan of B queries has B / 8 times the blocks of one
// per (group, row block), and a chunk smaller than 8 (B = 1) splits its
// rows over the 8 warps.  topk_hist_dma_kernel runs persistent blocks of
// the same 256 threads, as many as fit on the card at once, each walking
// the linear steps s = g * grid_n + block, blockIdx.x + k gridDim.x, as the
// TPU kernel's sequential grid does, and every query chunk within a step.
// The codes of a step stream through two shared sub-tiles of S rows x W
// words (S = 4,096 / W rows rounded down to 128, at least 128, at most the
// row block: the whole block while W = 1) as a double buffer, each a
// cp.async copy (4-byte copies landing in the transposed slots; rows past
// n zero-filled with no read) issued one sub-tile ahead, so the next
// step's first sub-tile is in flight during the current step's select.
// The buffers' size does not grow with block_n W: every W <= 32 fits at
// every block_n <= 8192.  A row block of one sub-tile stays resident for
// all the step's query chunks; with several sub-tiles each chunk streams
// them again.  Its distances come from the staged sub-tiles instead of
// HBM.

#include <cstdint>
#include <cuda_runtime.h>

#include "hamming_select.cuh"

namespace {

using hsel::kThreads;

constexpr int kSubWords = 4096;   // code words of one sub-tile, at most

// Rows of one sub-tile of topk_hist_dma_kernel's double buffer.
__host__ __device__ inline int sub_rows(int w, int block_n) {
  const int full = (block_n + 127) / 128 * 128;
  int s = kSubWords / w / 128 * 128;
  if (s < 128) s = 128;
  return s < full ? s : full;
}

// Bytes of the two code sub-tiles [w][sub_rows] ahead of
// topk_hist_dma_kernel's select memory.
__host__ __device__ inline size_t dma_head(int w, int block_n) {
  return 2 * sizeof(uint32_t) * static_cast<size_t>(w) * sub_rows(w, block_n);
}

template <typename U, int kBits, bool kWide, typename DT, typename IT>
__global__ void __launch_bounds__(kThreads)
topk_hist_kernel(const uint32_t* __restrict__ codes,
                 const uint32_t* __restrict__ queries,
                 const int32_t* __restrict__ active, DT* __restrict__ out_d,
                 IT* __restrict__ out_i, int n, int w, int nq, int l_k,
                 int block_n, int grid_n, int bq, int d_sent) {
  extern __shared__ __align__(16) unsigned char smem[];
  hsel::scan_block<false, U, kBits, kWide>(smem, codes, queries, active, out_d,
                                    out_i, n, w, nq, l_k, block_n, grid_n,
                                    bq, d_sent);
}

// Issue the asynchronous copy of sub-tile j (rows j * sub .. of the row
// block) of step s (group s / grid_n, row block s % grid_n) into `tile`,
// transposed to [w][sub], as one commit group.  Each word is a 4-byte
// cp.async; a row past n or past the row block copies 0 bytes from the
// group's first word (a valid address that is not read) and so lands as
// zeros.
__device__ __forceinline__ void fetch_sub(uint32_t* tile,
                                          const uint32_t* codes, int s, int j,
                                          int grid_n, int n, int w,
                                          int block_n, int sub) {
  const uint32_t* gcodes = codes + static_cast<int64_t>(s / grid_n) * n * w;
  const int r0 = j * sub;
  const int64_t base = static_cast<int64_t>(s % grid_n) * block_n + r0;
  for (int r = threadIdx.x; r < sub; r += kThreads) {
    const int64_t gr = base + r;
    const bool in = r0 + r < block_n && gr < n;
    for (int k = 0; k < w; ++k) {
      const uint32_t dst = static_cast<uint32_t>(
          __cvta_generic_to_shared(tile + k * sub + r));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                   "l"(in ? gcodes + gr * w + k : gcodes), "r"(in ? 4 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename U, int kBits, bool kWide, typename DT, typename IT>
__global__ void __launch_bounds__(kThreads)
topk_hist_dma_kernel(const uint32_t* __restrict__ codes,
                     const uint32_t* __restrict__ queries,
                     const int32_t* __restrict__ active, DT* __restrict__ out_d,
                     IT* __restrict__ out_i, int n, int w, int nq, int l_k,
                     int block_n, int grid_n, int n_steps, int bq,
                     int d_sent) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sub = sub_rows(w, block_n);
  const size_t sub_words = static_cast<size_t>(w) * sub;
  uint32_t* ctiles = reinterpret_cast<uint32_t*>(smem);
  const hsel::Layout lay =
      hsel::layout(w, block_n, bq, l_k, dma_head(w, block_n), kWide);
  U* tile = reinterpret_cast<U*>(smem + lay.tile);
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + lay.qs);
  const int n_units = (block_n + 127) / 128 * 32;
  const int n_chunks = n_units / 32;
  const int n_sub = (block_n + sub - 1) / sub;
  const int sub_chunks = sub / 128;
  // the sub-tile copies of one step: one that stays for every query chunk,
  // or every sub-tile again for each chunk
  const int per_step = n_sub == 1 ? 1 : (nq + bq - 1) / bq * n_sub;
  // copy number it of this block, into buffer it & 1; false past its steps
  auto fetch = [&](int it) {
    const int s = blockIdx.x + (it / per_step) * gridDim.x;
    if (s >= n_steps) return false;
    fetch_sub(ctiles + (it & 1) * sub_words, codes, s, it % per_step % n_sub,
              grid_n, n, w, block_n, sub);
    return true;
  };
  int it = 0, cur = 0;
  fetch(0);                              // the launch keeps gridDim.x <= n_steps
  for (int s = blockIdx.x; s < n_steps; s += gridDim.x) {
    const int g = s / grid_n, blk = s % grid_n;
    const int64_t base = static_cast<int64_t>(blk) * block_n;
    for (int b0 = 0; b0 < nq; b0 += bq) {
      const int nqc = min(bq, nq - b0);
      for (int k = threadIdx.x; k < nqc * w; k += kThreads) {
        qs[k] = queries[(static_cast<int64_t>(g) * nq + b0) * w + k];
      }
      for (int j = 0; j < n_sub; ++j) {
        if (n_sub > 1 || b0 == 0) {
          // the other buffer was last read before a barrier below
          if (fetch(it + 1)) {
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
          } else {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
          }
          cur = it & 1;
          ++it;
        }
        __syncthreads();   // the sub-tile and the queries are in place
        hsel::stage_distances<U, kBits>(
            tile, qs, nqc, ctiles + cur * sub_words, 1, sub, w, active, base,
            n, block_n, n_units, j * sub_chunks,
            min(n_chunks, (j + 1) * sub_chunks), j * sub);
        __syncthreads();   // the sub-tile may be refilled
      }
      hsel::select_chunk<false, U, kBits, kWide>(
          tile, reinterpret_cast<int*>(smem + lay.seg),
          reinterpret_cast<uint16_t*>(smem + lay.ids),
          reinterpret_cast<uint32_t*>(smem + lay.hist), nqc, n_units, w, l_k,
          block_n, out_d, out_i,
          ((static_cast<int64_t>(g) * grid_n + blk) * nq + b0) * l_k, d_sent);
      __syncthreads();   // the select's memory and the queries are reused
    }
  }
}

template <bool kDma>
int launch(const void* codes, const void* queries, const void* active,
           void* out_d, void* out_i, int groups, int n, int w, int nq,
           int l_k, int block_n, int grid_n, int pack, int d_sent,
           void* stream) {
  const size_t head = kDma ? dma_head(w, block_n) : 0;
  const hsel::Select sel = hsel::choose_select(w, block_n, l_k, head);
  const int bq = sel.bq;
  if (bq == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = hsel::layout(w, block_n, bq, l_k, head, sel.wide).total;
  const auto c = static_cast<const uint32_t*>(codes);
  const auto q = static_cast<const uint32_t*>(queries);
  const auto a = static_cast<const int32_t*>(active);
  const auto st = static_cast<cudaStream_t>(stream);
  return hsel::dispatch(pack, w, sel.wide, [&](auto u, auto bits, auto wide,
                                               auto dt, auto it) -> int {
    using U = typename decltype(u)::type;
    using DT = typename decltype(dt)::type;
    using IT = typename decltype(it)::type;
    constexpr int kBits = decltype(bits)::value;
    constexpr bool kWide = decltype(wide)::value;
    const auto od = static_cast<DT*>(out_d);
    const auto oi = static_cast<IT*>(out_i);
    if constexpr (!kDma) {
      auto kern = topk_hist_kernel<U, kBits, kWide, DT, IT>;
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      const unsigned blocks = hsel::scan_blocks(groups, grid_n, nq, bq);
      if (blocks == 0) return cudaErrorInvalidValue;
      kern<<<blocks, kThreads, smem, st>>>(c, q, a, od, oi, n, w, nq, l_k,
                                          block_n, grid_n, bq, d_sent);
    } else {
      auto kern = topk_hist_dma_kernel<U, kBits, kWide, DT, IT>;
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      int dev = 0, sms = 0, per_sm = 0;
      if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kThreads, smem);
      if (err != cudaSuccess) return err;
      // as many blocks as fit on the card at once, at most one per step
      const int n_steps = groups * grid_n;
      int blocks = per_sm * sms < n_steps ? per_sm * sms : n_steps;
      if (blocks < 1) blocks = 1;
      kern<<<blocks, kThreads, smem, st>>>(c, q, a, od, oi, n, w, nq, l_k,
                                          block_n, grid_n, n_steps, bq,
                                          d_sent);
    }
    return cudaGetLastError();
  });
}

}  // namespace

// 1 if a block of this shape fits the shared memory a block may use (with
// a query chunk of 8, 4, 2 or 1, and room for l = block_n kept rows), else
// 0; topk_hist_launch refuses the shapes that do not.  Every W <= 32 fits
// at every block_n <= 8192.
extern "C" int topk_hist_fits(int w, int block_n) {
  return hsel::choose_select(w, block_n, block_n, 0).bq > 0 ? 1 : 0;
}

// The same for topk_hist_dma_kernel, whose block also holds two code
// sub-tiles of at most kSubWords words each.
extern "C" int topk_hist_dma_fits(int w, int block_n) {
  return hsel::choose_select(w, block_n, block_n, dma_head(w, block_n)).bq > 0
             ? 1 : 0;
}

// codes: (groups, n, w) uint32; queries: (groups, nq, w) uint32; active:
// (n,) int32 or null; out_d / out_i: (groups, grid_n, nq, l_k) in the pack's
// types.  Returns the cudaError_t of the launch.
extern "C" int topk_hist_launch(const void* codes, const void* queries,
                                const void* active, void* out_d, void* out_i,
                                int groups, int n, int w, int nq, int l_k,
                                int block_n, int grid_n, int pack, int d_sent,
                                void* stream) {
  if (!topk_hist_fits(w, block_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<false>(codes, queries, active, out_d, out_i, groups, n, w,
                       nq, l_k, block_n, grid_n, pack, d_sent, stream);
}

// Same arguments and outputs as topk_hist_launch, through the pipelined
// persistent kernel.
extern "C" int topk_hist_dma_launch(const void* codes, const void* queries,
                                    const void* active, void* out_d,
                                    void* out_i, int groups, int n, int w,
                                    int nq, int l_k, int block_n, int grid_n,
                                    int pack, int d_sent, void* stream) {
  if (!topk_hist_dma_fits(w, block_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<true>(codes, queries, active, out_d, out_i, groups, n, w,
                      nq, l_k, block_n, grid_n, pack, d_sent, stream);
}
