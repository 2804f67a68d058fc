// The layout of the libraries' *_plan exports.  Each export reports the
// launch that its library's *_launch function makes for the same
// arguments, without making it, as six int64s a launch: grid x, y, z,
// threads, dynamic shared memory bytes, and the blocks per SM that the
// runtime's occupancy gave the launch (0 where the launch asks for none).
// kernels/contracts.py holds its reckoning of every launch to them.
#pragma once

#include <cstdint>

namespace lplan {

inline void put(int64_t* out, int64_t x, int64_t y, int64_t z,
                int64_t threads, int64_t smem, int64_t per_sm) {
  const int64_t v[6] = {x, y, z, threads, smem, per_sm};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

}  // namespace lplan
