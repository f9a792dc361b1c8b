// Definitions shared by the strata PG-SGD kernels (strata_sgd.cu,
// strata_stream.cu, strata_blocked.cu).
#pragma once

#include <stdint.h>

namespace strata {

constexpr int LANE = 128;
constexpr int CHUNK = 4096;  // pairs per chunk (one shared jump distance)
constexpr int TILE = 4096;   // slots per merge tile (TR * LANE)

// The reference's per-pair coin hash (odgi_tpu/ops/pallas_sgd.py
// _pair_coins) in uint32 arithmetic: i = pair index, sel = 0 for side a,
// 1 for side b, gch = the chunk key gl * 1000003 (wrapped).  Only bit 0 is
// used.
__device__ __forceinline__ uint32_t coin_hash(uint32_t i, uint32_t sel, uint32_t gch) {
  uint32_t h = i * 0x9E3779B9u + sel * 0x6A09E667u + gch * 0xBB67AE85u;
  h = (h ^ (h >> 16)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  return h ^ (h >> 16);
}

}  // namespace strata
