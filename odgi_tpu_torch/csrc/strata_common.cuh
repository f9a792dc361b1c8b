// Definitions shared by the strata PG-SGD kernels (strata_sgd.cu,
// strata_blocked.cu, strata_levels.cu): the coin hash and the bodies that
// run a chunk's pairs.
// - chunk_2d / chunk_1d: a whole chunk on one block, as the chain kernels
//   run them.
// - tile_2d / tile_1d and their _apart forms: the leveled kernels' tile of
//   a chunk, one block of a thread-block cluster, the same arithmetic split
//   at the point where it first reads drift (pair_*_ro, pair_*_rw), so that
//   a chunk can load its read-only words before it waits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace strata {

constexpr int LANE = 128;
constexpr int CHUNK = 4096;  // pairs per chunk (one shared jump distance)

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

// What one 2D pair reads that no chunk writes: the x-plane indices of its A
// and B slot (the y plane is 2 L further), the base words there, its term
// and rate, and whether it is valid.
struct Pair2DRo {
  long long ixa, ixb;
  float bxa, bya, bxb, byb, term, mu;
  bool valid;
};

// One 2D pair's drift reads and update: the drift read at its slots, and the
// moves rx, ry (A subtracts them, B adds them).  Drift is read from L2
// (ld.global.cg): another SM may have written it since this one last read
// it.
struct Pair2D {
  long long ixa, ixb;
  float dxa, dya, dxb, dyb, rx, ry;
};

// The read-only part of pair i of the 2D chunk with window start slot o,
// jump D, rate lr and coin key gch (the twin's _twin_chunks_2d body).
__device__ __forceinline__ Pair2DRo pair_2d_ro(const float* __restrict__ base,
                                               const int* __restrict__ planes, long long L,
                                               long long o, long long D, float lr,
                                               uint32_t gch, int i) {
  const int* pos0 = planes;          // pos
  const int* pos1 = planes + L;      // pos_end
  const int* path = planes + 3 * L;  // path id, -1 past the last step
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
  Pair2DRo r;
  r.valid = (path_a == path[b]) && (path_a >= 0);
  const long long iya = (qa + 2) * L + a, iyb = (qb + 2) * L + b;
  r.ixa = qa * L + a;
  r.ixb = qb * L + b;
  r.bxa = base[r.ixa];
  r.bya = base[iya];
  r.bxb = base[r.ixb];
  r.byb = base[iyb];
  r.term = fmaxf((float)abs(pa - pb), 1e-9f);
  r.mu = fminf(lr / r.term, 1.0f);
  return r;
}

// The rest of the pair: its drift reads and its moves.  With TRACK, dm takes
// the max of |delta| over valid pairs (the reference's Delta_max,
// odgi_tpu/ops/pallas_sgd.py:763-769).
template <bool TRACK>
__device__ __forceinline__ Pair2D pair_2d_rw(const float* drift, const Pair2DRo& r,
                                             long long L, float& dm) {
  Pair2D u;
  u.ixa = r.ixa;
  u.ixb = r.ixb;
  u.dxa = __ldcg(drift + r.ixa);
  u.dya = __ldcg(drift + r.ixa + 2 * L);
  u.dxb = __ldcg(drift + r.ixb);
  u.dyb = __ldcg(drift + r.ixb + 2 * L);
  const float xa = r.bxa + u.dxa;
  const float ya = r.bya + u.dya;
  const float xb = r.bxb + u.dxb;
  const float yb = r.byb + u.dyb;
  float dx = xa - xb;
  if (dx == 0.0f) dx = 1e-9f;
  const float dy = ya - yb;
  const float mag = sqrtf(dx * dx + dy * dy);
  const float delta = r.mu * (mag - r.term) * 0.5f;
  const float rr = r.valid ? delta / mag : 0.0f;
  if constexpr (TRACK) dm = fmaxf(dm, r.valid ? fabsf(delta) : 0.0f);
  u.rx = rr * dx;
  u.ry = rr * dy;
  return u;
}

// Pairs p0 .. p0 + NP - 1 of one 2D chunk (global index gl: its coins and
// eta row), THREADS threads each owning NP / THREADS of them: every pair
// loads its read-only words, then `wait()` (the leveled kernels wait there
// for the chunk's predecessors), then every pair reads drift at both slots;
// then all A adds; then all B adds, `bar` between the phases.  A slots are
// distinct within a chunk, and so are B slots; A and B windows overlap when
// D < CHUNK, and the barriers order them as the twin does: with NP < CHUNK,
// `bar` must hold every block that runs a tile of the chunk (a cluster
// barrier).  No atomics, deterministic.  The caller orders this chunk's B
// adds before any later chunk that shares a slot with it.  Returns the
// thread's Delta_max with TRACK, else 0.
template <int THREADS, int NP, bool TRACK, class Bar, class Wait>
__device__ __forceinline__ float tile_2d(float* drift, const float* __restrict__ base,
                                         const int* __restrict__ planes, long long L,
                                         long long o, long long D, float lr, int gl, int p0,
                                         Bar bar, Wait wait) {
  constexpr int PPT = NP / THREADS;
  float dm = 0.0f;
  const int tid = threadIdx.x;
  const uint32_t gch = (uint32_t)gl * 1000003u;
  Pair2DRo ro[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
    ro[k] = pair_2d_ro(base, planes, L, o, D, lr, gch, p0 + tid + k * THREADS);
  wait();
  long long xa_i[PPT], xb_i[PPT];
  float dxa_old[PPT], dya_old[PPT];
  float rx[PPT], ry[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const Pair2D u = pair_2d_rw<TRACK>(drift, ro[k], L, dm);
    xa_i[k] = u.ixa;
    xb_i[k] = u.ixb;
    dxa_old[k] = u.dxa;
    dya_old[k] = u.dya;
    rx[k] = u.rx;
    ry[k] = u.ry;
  }
  bar();
#pragma unroll
  for (int k = 0; k < PPT; ++k) {  // A adds
    drift[xa_i[k]] = dxa_old[k] + (-rx[k]);
    drift[xa_i[k] + 2 * L] = dya_old[k] + (-ry[k]);
  }
  bar();
#pragma unroll
  for (int k = 0; k < PPT; ++k) {  // B adds, after the A adds
    drift[xb_i[k]] = __ldcg(drift + xb_i[k]) + rx[k];
    drift[xb_i[k] + 2 * L] = __ldcg(drift + xb_i[k] + 2 * L) + ry[k];
  }
  return dm;
}

// `tile_2d` for a chunk with D >= CHUNK: its A and B windows are disjoint,
// so no slot is touched by two of its pairs and each pair reads, adds into
// its A slot and adds into its B slot on its own, with no barrier.  The B
// slot's drift is the one the pair read: the same sums as tile_2d.
template <int THREADS, int NP, bool TRACK, class Wait>
__device__ __forceinline__ float tile_2d_apart(float* drift, const float* __restrict__ base,
                                               const int* __restrict__ planes, long long L,
                                               long long o, long long D, float lr, int gl,
                                               int p0, Wait wait) {
  constexpr int PPT = NP / THREADS;
  float dm = 0.0f;
  const int tid = threadIdx.x;
  const uint32_t gch = (uint32_t)gl * 1000003u;
  Pair2DRo ro[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
    ro[k] = pair_2d_ro(base, planes, L, o, D, lr, gch, p0 + tid + k * THREADS);
  wait();
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const Pair2D u = pair_2d_rw<TRACK>(drift, ro[k], L, dm);
    drift[u.ixa] = u.dxa + (-u.rx);
    drift[u.ixa + 2 * L] = u.dya + (-u.ry);
    drift[u.ixb] = u.dxb + u.rx;
    drift[u.ixb + 2 * L] = u.dyb + u.ry;
  }
  return dm;
}

// What one 1D pair reads that no chunk writes (the twin's _twin_chunks_1d
// body): one X plane, no coins; a pair is valid only if also pos_a !=
// pos_b, and its weight is 1/d.
struct Pair1DRo {
  float ba, bb, term, mu;
  bool valid;
};

__device__ __forceinline__ Pair1DRo pair_1d_ro(const float* __restrict__ base,
                                               const int* __restrict__ planes, long long L,
                                               long long a, long long D, float lr) {
  const int* pos = planes;
  const int* path = planes + 2 * L;
  const long long b = a + D;
  const int di = pos[a] - pos[b];
  const int path_a = path[a];
  Pair1DRo r;
  r.valid = (path_a == path[b]) && (path_a >= 0) && (di != 0);
  r.ba = base[a];
  r.bb = base[b];
  r.term = (float)abs(di);
  const float w = 1.0f / fmaxf(r.term, 1e-30f);
  r.mu = fminf(lr * w, 1.0f);
  return r;
}

// The rest of the 1D pair at slot a: the A slot subtracts rr and the B slot
// adds it.  TRACK as pair_2d_rw (:820-823); valid includes di != 0.
struct Pair1D {
  float da, db, rr;
};

template <bool TRACK>
__device__ __forceinline__ Pair1D pair_1d_rw(const float* drift, const Pair1DRo& r,
                                             long long a, long long D, float& dm) {
  Pair1D u;
  u.da = __ldcg(drift + a);
  u.db = __ldcg(drift + a + D);
  const float xa = r.ba + u.da;
  const float xb = r.bb + u.db;
  float dx = xa - xb;
  if (dx == 0.0f) dx = 1e-9f;
  const float mag = fabsf(dx);
  const float delta = r.mu * (mag - r.term) * 0.5f;
  u.rr = r.valid ? delta / mag * dx : 0.0f;
  if constexpr (TRACK) dm = fmaxf(dm, r.valid ? fabsf(delta) : 0.0f);
  return u;
}

// Pairs p0 .. p0 + NP - 1 of one 1D chunk: read-only loads, `wait()`, drift
// reads, A adds, B adds, as tile_2d; a pair keeps two floats across the
// barriers (its B slot is recomputed).
template <int THREADS, int NP, bool TRACK, class Bar, class Wait>
__device__ __forceinline__ float tile_1d(float* drift, const float* __restrict__ base,
                                         const int* __restrict__ planes, long long L,
                                         long long o, long long D, float lr, int p0, Bar bar,
                                         Wait wait) {
  constexpr int PPT = NP / THREADS;
  float dm = 0.0f;
  const int tid = threadIdx.x;
  Pair1DRo ro[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
    ro[k] = pair_1d_ro(base, planes, L, o + p0 + tid + k * THREADS, D, lr);
  wait();
  float da_old[PPT], rr[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const Pair1D u = pair_1d_rw<TRACK>(drift, ro[k], o + p0 + tid + k * THREADS, D, dm);
    da_old[k] = u.da;
    rr[k] = u.rr;
  }
  bar();
#pragma unroll
  for (int k = 0; k < PPT; ++k)  // A adds
    drift[o + p0 + tid + k * THREADS] = da_old[k] - rr[k];
  bar();
#pragma unroll
  for (int k = 0; k < PPT; ++k) {  // B adds, after the A adds
    const long long b = o + D + p0 + tid + k * THREADS;
    drift[b] = __ldcg(drift + b) + rr[k];
  }
  return dm;
}

// `tile_1d` for a chunk with D >= CHUNK, as tile_2d_apart.
template <int THREADS, int NP, bool TRACK, class Wait>
__device__ __forceinline__ float tile_1d_apart(float* drift, const float* __restrict__ base,
                                               const int* __restrict__ planes, long long L,
                                               long long o, long long D, float lr, int p0,
                                               Wait wait) {
  constexpr int PPT = NP / THREADS;
  float dm = 0.0f;
  const int tid = threadIdx.x;
  Pair1DRo ro[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
    ro[k] = pair_1d_ro(base, planes, L, o + p0 + tid + k * THREADS, D, lr);
  wait();
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const long long a = o + p0 + tid + k * THREADS;
    const Pair1D u = pair_1d_rw<TRACK>(drift, ro[k], a, D, dm);
    drift[a] = u.da - u.rr;
    drift[a + D] = u.db + u.rr;
  }
  return dm;
}

}  // namespace strata
