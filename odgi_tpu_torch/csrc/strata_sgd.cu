// Strata PG-SGD kernels for Hopper (sm_90a), with a plain C interface that
// ops/kernels.py binds through ctypes.
//
// They replace the two resident Pallas kernels of the JAX package,
// odgi_tpu/ops/pallas_sgd.py:
//   _make_kernel_2d (layout): chunk phase _chunk_2d + merge _merge_tiles_2d
//   _make_kernel_1d (sort Y): chunk phase _chunk_1d + merge _merge_tiles_1d
// and compute the function of their twins path_sgd_2d_strata_xla /
// path_sgd_1d_strata_xla, not the TPU's tiling: no lane rolls, no (8,128)
// tiles, no bf16 one-hot matmuls, no TwoSum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
// -fmad=false and IEEE sqrt/division (no fast math) round every operation
// as the plain PyTorch versions in ops/strata_sgd.py do, so kernel and
// plain version agree bit for bit.
//
// Every entry launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "strata_common.cuh"

namespace {

using strata::CHUNK;
using strata::LANE;
using strata::coin_hash;

constexpr int CHUNK_THREADS = 1024;  // one block walks a merge group
constexpr int PAIRS_PER_THREAD = CHUNK / CHUNK_THREADS;
constexpr int MERGE_THREADS = 256;

// ---------------------------------------------------------------------------
// strata_chunks_2d: the chunk phase of _make_kernel_2d for one merge group.
//
// Bound on this card: latency.  The chunks of a group form a sequential
// chain (chunk c+1 reads the drift chunk c wrote), so one block of 1024
// threads walks them in order on one SM; each chunk costs a few dependent
// global-memory round trips and three barriers, while the bytes a group
// touches would take the card's bandwidth microseconds.  What the design
// does about it: one read phase issues every load of a chunk at once (the
// coins come from a hash, so no load waits on another), the A adds reuse
// the drift read in that phase instead of reading it again, and the next
// chunk's (o, D) is fetched while the current one runs.  Conflict levels of
// window-disjoint chunks, one block per chunk, are the next step.
//
// Semantics (the twin's _twin_chunks_2d): per chunk, every pair reads
// base+drift at both slots first; then all A adds; then all B adds.  A
// slots are distinct within a chunk, and so are B slots; A and B windows
// overlap when D < CHUNK, and the barriers order them as the twin does.  No
// atomics, deterministic.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(CHUNK_THREADS, 1)
strata_chunks_2d_kernel(float* drift, const float* __restrict__ base,
                        const int* __restrict__ planes, long long L,
                        const int* __restrict__ od, const float* __restrict__ eta,
                        int cpi, int g0, int cgs) {
  const int tid = threadIdx.x;
  const int* pos0 = planes;          // pos
  const int* pos1 = planes + L;      // pos_end
  const int* path = planes + 3 * L;  // path id, -1 past the last step
  int o_next = od[2 * g0];
  int d_next = od[2 * g0 + 1];
  for (int c = 0; c < cgs; ++c) {
    const int gl = g0 + c;
    const long long o = (long long)o_next * LANE;
    const long long D = d_next;
    if (c + 1 < cgs) {
      o_next = od[2 * (gl + 1)];
      d_next = od[2 * (gl + 1) + 1];
    }
    const float lr = eta[gl / cpi];
    const uint32_t gch = (uint32_t)gl * 1000003u;

    long long xa_i[PAIRS_PER_THREAD], xb_i[PAIRS_PER_THREAD];
    float dxa_old[PAIRS_PER_THREAD], dya_old[PAIRS_PER_THREAD];
    float rx[PAIRS_PER_THREAD], ry[PAIRS_PER_THREAD];
#pragma unroll
    for (int k = 0; k < PAIRS_PER_THREAD; ++k) {
      const int i = tid + k * CHUNK_THREADS;
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
      xa_i[k] = ixa;
      xb_i[k] = ixb;
      dxa_old[k] = dxa;
      dya_old[k] = dya;
      rx[k] = r * dx;
      ry[k] = r * dy;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PAIRS_PER_THREAD; ++k) {  // A adds
      drift[xa_i[k]] = dxa_old[k] + (-rx[k]);
      drift[xa_i[k] + 2 * L] = dya_old[k] + (-ry[k]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PAIRS_PER_THREAD; ++k) {  // B adds, after the A adds
      drift[xb_i[k]] = drift[xb_i[k]] + rx[k];
      drift[xb_i[k] + 2 * L] = drift[xb_i[k] + 2 * L] + ry[k];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// strata_chunks_1d: the chunk phase of _make_kernel_1d (twin: _twin_chunks_1d).
// One X plane, no coins; valid also needs pos_a != pos_b; w = 1/d; the A
// slot subtracts rr and the B slot adds it.  Bound and design as for 2D.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(CHUNK_THREADS, 1)
strata_chunks_1d_kernel(float* drift, const float* __restrict__ base,
                        const int* __restrict__ planes, long long L,
                        const int* __restrict__ od, const float* __restrict__ eta,
                        int cpi, int g0, int cgs) {
  const int tid = threadIdx.x;
  const int* pos = planes;
  const int* path = planes + 2 * L;
  int o_next = od[2 * g0];
  int d_next = od[2 * g0 + 1];
  for (int c = 0; c < cgs; ++c) {
    const int gl = g0 + c;
    const long long o = (long long)o_next * LANE;
    const long long D = d_next;
    if (c + 1 < cgs) {
      o_next = od[2 * (gl + 1)];
      d_next = od[2 * (gl + 1) + 1];
    }
    const float lr = eta[gl / cpi];

    long long b_i[PAIRS_PER_THREAD];
    float da_old[PAIRS_PER_THREAD], rr[PAIRS_PER_THREAD];
#pragma unroll
    for (int k = 0; k < PAIRS_PER_THREAD; ++k) {
      const long long a = o + tid + k * CHUNK_THREADS;
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
      b_i[k] = b;
      da_old[k] = da;
      rr[k] = valid ? delta / mag * dx : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PAIRS_PER_THREAD; ++k)  // A adds
      drift[o + tid + k * CHUNK_THREADS] = da_old[k] - rr[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PAIRS_PER_THREAD; ++k)  // B adds
      drift[b_i[k]] = drift[b_i[k]] + rr[k];
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// strata_merge_sum<NC>: the sum half of _merge_tiles_2d (NC = 2) and
// _merge_tiles_1d (NC = 1).
//
// One thread per endpoint e sums in f64, in ascending slot order (the order
// of the twin's np.bincount), the drift of the slots listed for e in a
// host-built CSR.  2D: channel c sums plane 2c over the slots whose forward
// endpoint is e, then plane 2c+1 over the slots whose forward endpoint is
// e^1 (their complement endpoint is e), and adds the two sums, as the twin's
// bincount(epf, dv[2c]) + bincount(epr, dv[2c+1]).  upd = acc * (1/R) is
// stored for the broadcast and added into the f64 node coordinates.
//
// Bound on this card: bytes (each slot's drift read once through a gathered
// index, the CSR, and the node coordinates), far under a millisecond at the
// main path's size; the gather is random, so the real cost is the latency
// of the longest list.  No atomics: the sum is deterministic and matches
// the twin bit for bit.
// ---------------------------------------------------------------------------
template <int NC>
__global__ void strata_merge_sum_kernel(const float* __restrict__ drift, long long L,
                                        const int* __restrict__ csr_off,
                                        const int* __restrict__ csr_slot,
                                        const double* __restrict__ recip,
                                        double* __restrict__ coords,
                                        double* __restrict__ upd, int E, int ecap) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int f0 = csr_off[e], f1 = csr_off[e + 1];
  if (NC == 1) {
    double acc = 0.0;
    for (int k = f0; k < f1; ++k) acc += (double)drift[csr_slot[k]];
    const double u = acc * recip[e];
    upd[e] = u;
    coords[e] = coords[e] + u;
  } else {
    const int r0 = csr_off[e ^ 1], r1 = csr_off[(e ^ 1) + 1];
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      const float* fwd = drift + (2 * ch) * L;
      const float* rev = drift + (2 * ch + 1) * L;
      double af = 0.0, ar = 0.0;
      for (int k = f0; k < f1; ++k) af += (double)fwd[csr_slot[k]];
      for (int k = r0; k < r1; ++k) ar += (double)rev[csr_slot[k]];
      const double u = (af + ar) * recip[e];
      upd[ch * ecap + e] = u;
      coords[ch * E + e] = coords[ch * E + e] + u;
    }
  }
}

// ---------------------------------------------------------------------------
// strata_merge_bcast<NC>: the broadcast half of _merge_tiles_2d/_1d.  One
// thread per slot: base[p][s] += (float)upd[endpoint of replica p of s],
// drift[p][s] = 0.  Pad slots hold the dummy endpoint, whose upd is 0.
// Bound on this card: bytes (a streaming pass over base and drift plus a
// gather from the small upd table); coalesced, one pass.
// ---------------------------------------------------------------------------
template <int NC>
__global__ void strata_merge_bcast_kernel(float* __restrict__ drift, float* __restrict__ base,
                                          long long L, const int* __restrict__ ep,
                                          const double* __restrict__ upd, int ecap) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= L) return;
  const int e = ep[s];
  if (NC == 1) {
    base[s] = base[s] + (float)upd[e];
    drift[s] = 0.0f;
  } else {
    const int er = e ^ 1;
    base[s] = base[s] + (float)upd[e];
    base[L + s] = base[L + s] + (float)upd[er];
    base[2 * L + s] = base[2 * L + s] + (float)upd[ecap + e];
    base[3 * L + s] = base[3 * L + s] + (float)upd[ecap + er];
    drift[s] = 0.0f;
    drift[L + s] = 0.0f;
    drift[2 * L + s] = 0.0f;
    drift[3 * L + s] = 0.0f;
  }
}

}  // namespace

extern "C" {

int strata_chunks_2d(void* drift, const void* base, const void* planes, long long L,
                     const void* od, const void* eta, int cpi, int g0, int cgs,
                     void* stream) {
  strata_chunks_2d_kernel<<<1, CHUNK_THREADS, 0, (cudaStream_t)stream>>>(
      (float*)drift, (const float*)base, (const int*)planes, L, (const int*)od,
      (const float*)eta, cpi, g0, cgs);
  return (int)cudaGetLastError();
}

int strata_chunks_1d(void* drift, const void* base, const void* planes, long long L,
                     const void* od, const void* eta, int cpi, int g0, int cgs,
                     void* stream) {
  strata_chunks_1d_kernel<<<1, CHUNK_THREADS, 0, (cudaStream_t)stream>>>(
      (float*)drift, (const float*)base, (const int*)planes, L, (const int*)od,
      (const float*)eta, cpi, g0, cgs);
  return (int)cudaGetLastError();
}

int strata_merge_sum(const void* drift, long long L, const void* csr_off,
                     const void* csr_slot, const void* recip, void* coords, void* upd,
                     int E, int ecap, int nc, void* stream) {
  const int blocks = (E + MERGE_THREADS - 1) / MERGE_THREADS;
  if (nc == 1)
    strata_merge_sum_kernel<1><<<blocks, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)drift, L, (const int*)csr_off, (const int*)csr_slot,
        (const double*)recip, (double*)coords, (double*)upd, E, ecap);
  else if (nc == 2)
    strata_merge_sum_kernel<2><<<blocks, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)drift, L, (const int*)csr_off, (const int*)csr_slot,
        (const double*)recip, (double*)coords, (double*)upd, E, ecap);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int strata_merge_bcast(void* drift, void* base, long long L, const void* ep,
                       const void* upd, int ecap, int nc, void* stream) {
  const long long blocks = (L + MERGE_THREADS - 1) / MERGE_THREADS;
  if (nc == 1)
    strata_merge_bcast_kernel<1><<<(unsigned)blocks, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)drift, (float*)base, L, (const int*)ep, (const double*)upd, ecap);
  else if (nc == 2)
    strata_merge_bcast_kernel<2><<<(unsigned)blocks, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)drift, (float*)base, L, (const int*)ep, (const double*)upd, ecap);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
