// Per-query candidate lists of the scan path's union, in stable-id space.
//
// Replaces no TPU kernel.  The JAX package reads the union's sorted
// live-row slots back and builds each query's list on the host; on the
// card that per-query host loop, after the device has finished the batch,
// took a quarter of a Tiny-1M micro-batch.  This kernel builds the lists
// on the device, so that the batch's answers cross to the host in one
// read and each list is a view of it.
//
// Input, per query q of B: the union's C = L l live-row slots sorted
// ascending (-1 = empty slot, so empty slots come first), the C bool
// slots of ``valid`` (unique, live and inside the caller's mask), and the
// live-row -> stable-id map.  Output, one int64 row of C + 2 per query:
// its unique live rows as stable ids, left-aligned in ascending row order
// (which is stable-id order), -1 after them; then the count; then 1 if
// any slot is valid, else 0.
//
// What bounds it: bytes, B C (4 + 1) read, the kept ids' 8-byte map
// entries read and B (C + 2) 8 written (kernels/ops.py,
// candidate_lists_bound): a few microseconds at the serving shapes,
// where it is latency, not bandwidth, that the block pays.
//
// Design.  One block of kThreads threads per query walks its row in
// chunks of kThreads slots.  A slot is kept if it is live and differs
// from the slot before it; its place in the output is the number of kept
// slots before it: a warp ballot and popcount within the warp, the warps'
// counts in shared memory before it within the chunk, and the running
// total of the chunks before.  Slots past the count are then filled with
// -1 and __syncthreads_or gives the valid flag.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_plan.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
cand_lists_kernel(const int32_t* __restrict__ flat,
                  const uint8_t* __restrict__ valid,
                  const int64_t* __restrict__ id_map,
                  int64_t* __restrict__ out, int c) {
  __shared__ int warp_kept[kWarps];
  const int64_t q = blockIdx.x;
  const int32_t* f = flat + q * c;
  const uint8_t* v = valid + q * c;
  int64_t* o = out + q * (static_cast<int64_t>(c) + 2);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int base = 0;
  int any = 0;
  for (int s = 0; s < c; s += kThreads) {
    const int j = s + static_cast<int>(threadIdx.x);
    int row = -1;
    bool keep = false;
    if (j < c) {
      row = f[j];
      keep = row >= 0 && (j == 0 || f[j - 1] != row);
      any |= v[j];
    }
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(kept);
    __syncthreads();
    int before = 0;
    int total = 0;
    for (int k = 0; k < kWarps; ++k) {
      const int n = warp_kept[k];
      before += k < warp ? n : 0;
      total += n;
    }
    if (keep) {
      o[base + before + __popc(kept & ((1u << lane) - 1u))] = id_map[row];
    }
    base += total;
    __syncthreads();  // warp_kept is rewritten by the next chunk
  }
  for (int j = base + static_cast<int>(threadIdx.x); j < c; j += kThreads) {
    o[j] = -1;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    o[c] = base;
    o[c + 1] = any ? 1 : 0;
  }
}

}  // namespace

// flat: (b, c) int32 sorted rows; valid: (b, c) bool; id_map: (n_live,)
// int64; out: (b, c + 2) int64.  Returns the cudaError_t of the launch.
extern "C" int cand_lists_launch(const void* flat, const void* valid,
                                 const void* id_map, void* out, int b, int c,
                                 void* stream) {
  if (b < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  cand_lists_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(flat), static_cast<const uint8_t*>(valid),
      static_cast<const int64_t*>(id_map), static_cast<int64_t*>(out), c);
  return static_cast<int>(cudaGetLastError());
}

// The launch cand_lists_launch makes for these arguments, without making
// it (launch_plan.cuh).  Returns 0, or the error with which the launch
// refuses.
extern "C" int cand_lists_plan(int b, int c, int64_t* out) {
  if (b < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  lplan::put(out, b, 1, 1, kThreads, 0, 0);
  return 0;
}
