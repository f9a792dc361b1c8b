// Definitions shared by the strata PG-SGD kernels (strata_sgd.cu,
// strata_stream.cu, strata_blocked.cu, strata_levels.cu): the coin hash and
// the bodies of one 2D and one 1D chunk, which the chain kernels and the
// leveled kernels both run.
#pragma once

#include <cuda_runtime.h>
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

// One 2D chunk (the twin's _twin_chunks_2d body) run by a block of THREADS
// threads, each owning CHUNK / THREADS pairs: every pair reads base+drift
// at both slots first; then all A adds; then all B adds.  A slots are
// distinct within a chunk, and so are B slots; A and B windows overlap when
// D < CHUNK, and the barriers order them as the twin does.  No atomics,
// deterministic.  gl is the chunk's global index (its coins and eta row);
// o is the window start slot.  The caller orders this chunk's B adds
// before any later chunk that shares a slot with it.  With TRACK the
// thread returns the max of |delta| over its valid pairs (the reference's
// Delta_max, odgi_tpu/ops/pallas_sgd.py:763-769), else 0 and the
// instance is the untracked body unchanged.
template <int THREADS, bool TRACK = false>
__device__ __forceinline__ float chunk_2d(float* drift, const float* __restrict__ base,
                                          const int* __restrict__ planes, long long L,
                                          long long o, long long D, float lr, int gl) {
  constexpr int PPT = CHUNK / THREADS;
  float dm = 0.0f;
  const int tid = threadIdx.x;
  const int* pos0 = planes;          // pos
  const int* pos1 = planes + L;      // pos_end
  const int* path = planes + 3 * L;  // path id, -1 past the last step
  const uint32_t gch = (uint32_t)gl * 1000003u;

  long long xa_i[PPT], xb_i[PPT];
  float dxa_old[PPT], dya_old[PPT];
  float rx[PPT], ry[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tid + k * THREADS;
    const long long a = o + i;
    const long long b = a + D;
    const bool caf = (coin_hash((uint32_t)i, 0u, gch) & 1u) == 0u;
    const bool cbf = (coin_hash((uint32_t)i, 1u, gch) & 1u) == 0u;
    // replica planes [xf, xr, yf, yr]: x plane q, y plane q + 2
    const long long qa = caf ? 0 : 1;
    const long long qb = cbf ? 0 : 1;
    const int pa = caf ? pos0[a] : pos1[a];
    const int pb = cbf ? pos0[b] : pos1[b];
    const int path_a = path[a];
    const bool valid = (path_a == path[b]) && (path_a >= 0);
    const long long ixa = qa * L + a, iya = (qa + 2) * L + a;
    const long long ixb = qb * L + b, iyb = (qb + 2) * L + b;
    const float dxa = drift[ixa], dya = drift[iya];
    const float xa = base[ixa] + dxa;
    const float ya = base[iya] + dya;
    const float xb = base[ixb] + drift[ixb];
    const float yb = base[iyb] + drift[iyb];

    const float term = fmaxf((float)abs(pa - pb), 1e-9f);
    const float mu = fminf(lr / term, 1.0f);
    float dx = xa - xb;
    if (dx == 0.0f) dx = 1e-9f;
    const float dy = ya - yb;
    const float mag = sqrtf(dx * dx + dy * dy);
    const float delta = mu * (mag - term) * 0.5f;
    const float r = valid ? delta / mag : 0.0f;
    if constexpr (TRACK) dm = fmaxf(dm, valid ? fabsf(delta) : 0.0f);
    xa_i[k] = ixa;
    xb_i[k] = ixb;
    dxa_old[k] = dxa;
    dya_old[k] = dya;
    rx[k] = r * dx;
    ry[k] = r * dy;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PPT; ++k) {  // A adds
    drift[xa_i[k]] = dxa_old[k] + (-rx[k]);
    drift[xa_i[k] + 2 * L] = dya_old[k] + (-ry[k]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PPT; ++k) {  // B adds, after the A adds
    drift[xb_i[k]] = drift[xb_i[k]] + rx[k];
    drift[xb_i[k] + 2 * L] = drift[xb_i[k] + 2 * L] + ry[k];
  }
  return dm;
}

// One 1D chunk (the twin's _twin_chunks_1d body) run by a block of THREADS
// threads, each owning CHUNK / THREADS pairs: one X plane, no coins; a pair
// is valid only if also pos_a != pos_b, and its weight is 1/d; the A slot
// subtracts rr and the B slot adds it.  Read phase, A adds, B adds, as
// chunk_2d; a pair keeps two floats across the barriers (its B slot is
// recomputed).  TRACK as chunk_2d (:820-823); valid includes di != 0.
template <int THREADS, bool TRACK = false>
__device__ __forceinline__ float chunk_1d(float* drift, const float* __restrict__ base,
                                          const int* __restrict__ planes, long long L,
                                          long long o, long long D, float lr) {
  constexpr int PPT = CHUNK / THREADS;
  float dm = 0.0f;
  const int tid = threadIdx.x;
  const int* pos = planes;
  const int* path = planes + 2 * L;

  float da_old[PPT], rr[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const long long a = o + tid + k * THREADS;
    const long long b = a + D;
    const int di = pos[a] - pos[b];
    const int path_a = path[a];
    const bool valid = (path_a == path[b]) && (path_a >= 0) && (di != 0);
    const float da = drift[a];
    const float xa = base[a] + da;
    const float xb = base[b] + drift[b];

    const float term = (float)abs(di);
    const float w = 1.0f / fmaxf(term, 1e-30f);
    const float mu = fminf(lr * w, 1.0f);
    float dx = xa - xb;
    if (dx == 0.0f) dx = 1e-9f;
    const float mag = fabsf(dx);
    const float delta = mu * (mag - term) * 0.5f;
    da_old[k] = da;
    rr[k] = valid ? delta / mag * dx : 0.0f;
    if constexpr (TRACK) dm = fmaxf(dm, valid ? fabsf(delta) : 0.0f);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PPT; ++k)  // A adds
    drift[o + tid + k * THREADS] = da_old[k] - rr[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PPT; ++k) {  // B adds, after the A adds
    const long long b = o + D + tid + k * THREADS;
    drift[b] = drift[b] + rr[k];
  }
  return dm;
}

}  // namespace strata
