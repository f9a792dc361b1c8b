// Stream chunk kernels of the XL and XXL routes for Hopper (sm_90a), with a
// plain C interface that ops/kernels.py binds through ctypes.
//
// They replace the chunk phase of the JAX package's streaming kernels:
//   strata_chunks_2d_stream: odgi_tpu/ops/pallas_sgd_xl.py:228 _run_chunks_2d,
//     run by _make_kernel_xl (:363) and _make_kernel_xxl
//     (odgi_tpu/ops/pallas_sgd_xxl.py:212)
//   strata_chunks_1d_stream: odgi_tpu/ops/pallas_sgd_xl.py:672 _run_chunks_1d,
//     run by _make_kernel_xl_1d (:795) and _make_kernel_xxl_1d
//     (pallas_sgd_xxl.py:632)
// and give the same drift as strata_chunks_2d / strata_chunks_1d
// (strata_sgd.cu), bit for bit: the same pair arithmetic in the same
// order, built with -fmad=false.  The main path runs the leveled kernels of
// strata_levels.cu instead; these chains stay as their reference.
//
// What the TPU kernel does and what is kept.  The TPU kernel DMAs each
// chunk's windows from HBM into VMEM and double-buffers them: chunk c+1's
// reads are issued during chunk c unless a host-built sync flag says c+1's
// windows may intersect c's.  Kept: the software pipeline and the flag.
// One block walks the group's chunk chain, as the TPU's fori_loop does.
// During chunk c each thread loads chunk c+1's read-only operands for its
// pairs (the coin-selected pos and pos_end, the path ids and base; no chunk
// of a group writes them) into registers, and, when c+1's flag is 0, its
// drift too.  A chunk whose flag is 1 reads its drift after chunk c's B
// adds.  The barrier order of strata_chunks_2d stays: read phase, A adds,
// B adds.  Not kept: the TPU's union window / far window split
// (near = D < 2*CHUNK).  It exists because a DMA'd window is written back
// whole, so the A and B windows of a near chunk must share one buffer;
// here each pair reads and writes only its own slots.  Staging whole
// windows in shared memory would not fit either: 2D moves 44 B a slot, so
// one 4096-slot window is about 180 KB.
//
// Bound on this card: the bytes of the slots a group's windows touch, over
// the HBM rate (0.09-0.17 ms a 2D launch on the XL and 1M-node graphs);
// the real limit is the dependent chain of chunks on one SM.  What the
// design does about it: the next chunk's loads are in flight while this
// chunk's adds run.  On the card that gains nothing over strata_chunks_2d
// (7.5 us a 2D chunk either way, PERF.md): the loads and stores one SM
// issues per chunk, not their latency, pace the chain.
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

constexpr int STREAM_THREADS = 1024;
constexpr int PPT = CHUNK / STREAM_THREADS;  // pairs per thread

// Operands of one 2D chunk for a thread's PPT pairs, loaded ahead.
struct Staged2d {
  long long o, D;
  uint32_t coin;   // bit k: side a takes the forward replica; bit k+PPT: side b
  uint32_t valid;  // bit k: pair k joins two slots of one path
  bool has_drift;  // x*, y* hold base + drift (else base alone)
  float term[PPT];
  float xa[PPT], ya[PPT], xb[PPT], yb[PPT];
  float dxa[PPT], dya[PPT];  // side a's drift, kept for the A adds
};

__device__ __forceinline__ void stage_2d(Staged2d& st, const float* drift,
                                         const float* __restrict__ base,
                                         const int* __restrict__ planes, long long L,
                                         const int* __restrict__ od, int gl,
                                         bool with_drift) {
  const int tid = threadIdx.x;
  const int* pos0 = planes;
  const int* pos1 = planes + L;
  const int* path = planes + 3 * L;
  st.o = (long long)od[2 * gl] * LANE;
  st.D = od[2 * gl + 1];
  st.has_drift = with_drift;
  st.coin = 0u;
  st.valid = 0u;
  const uint32_t gch = (uint32_t)gl * 1000003u;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tid + k * STREAM_THREADS;
    const long long a = st.o + i;
    const long long b = a + st.D;
    const bool caf = (coin_hash((uint32_t)i, 0u, gch) & 1u) == 0u;
    const bool cbf = (coin_hash((uint32_t)i, 1u, gch) & 1u) == 0u;
    st.coin |= ((uint32_t)caf << k) | ((uint32_t)cbf << (k + PPT));
    const int pa = caf ? pos0[a] : pos1[a];
    const int pb = cbf ? pos0[b] : pos1[b];
    const int path_a = path[a];
    st.valid |= (uint32_t)((path_a == path[b]) && (path_a >= 0)) << k;
    st.term[k] = fmaxf((float)abs(pa - pb), 1e-9f);
    const long long ixa = (caf ? 0 : 1) * L + a;
    const long long ixb = (cbf ? 0 : 1) * L + b;
    st.xa[k] = base[ixa];
    st.ya[k] = base[ixa + 2 * L];
    st.xb[k] = base[ixb];
    st.yb[k] = base[ixb + 2 * L];
    if (with_drift) {
      st.dxa[k] = drift[ixa];
      st.dya[k] = drift[ixa + 2 * L];
      st.xa[k] = st.xa[k] + st.dxa[k];
      st.ya[k] = st.ya[k] + st.dya[k];
      st.xb[k] = st.xb[k] + drift[ixb];
      st.yb[k] = st.yb[k] + drift[ixb + 2 * L];
    }
  }
}

__device__ __forceinline__ void stage_drift_2d(Staged2d& st, const float* drift,
                                               long long L) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const long long a = st.o + tid + k * STREAM_THREADS;
    const long long ixa = ((st.coin >> k) & 1u ? 0 : 1) * L + a;
    const long long ixb = ((st.coin >> (k + PPT)) & 1u ? 0 : 1) * L + a + st.D;
    st.dxa[k] = drift[ixa];
    st.dya[k] = drift[ixa + 2 * L];
    st.xa[k] = st.xa[k] + st.dxa[k];
    st.ya[k] = st.ya[k] + st.dya[k];
    st.xb[k] = st.xb[k] + drift[ixb];
    st.yb[k] = st.yb[k] + drift[ixb + 2 * L];
  }
  st.has_drift = true;
}

// ---------------------------------------------------------------------------
// strata_chunks_2d_stream: one merge group of the 2D chunk phase, in place
// on drift.  sync[gl] = 1 marks a chunk whose drift must be read after
// chunk gl-1's adds.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(STREAM_THREADS, 1)
strata_chunks_2d_stream_kernel(float* drift, const float* __restrict__ base,
                               const int* __restrict__ planes, long long L,
                               const int* __restrict__ od, const int* __restrict__ sync,
                               const float* __restrict__ eta, int cpi, int g0, int cgs) {
  const int tid = threadIdx.x;
  Staged2d st;
  stage_2d(st, drift, base, planes, L, od, g0, true);
  for (int c = 0; c < cgs; ++c) {
    const int gl = g0 + c;
    if (!st.has_drift) stage_drift_2d(st, drift, L);
    const float lr = eta[gl / cpi];
    const long long o = st.o, D = st.D;
    const uint32_t coin = st.coin;
    float rx[PPT], ry[PPT], dxa[PPT], dya[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float term = st.term[k];
      const float mu = fminf(lr / term, 1.0f);
      float dx = st.xa[k] - st.xb[k];
      if (dx == 0.0f) dx = 1e-9f;
      const float dy = st.ya[k] - st.yb[k];
      const float mag = sqrtf(dx * dx + dy * dy);
      const float delta = mu * (mag - term) * 0.5f;
      const float r = (st.valid >> k) & 1u ? delta / mag : 0.0f;
      rx[k] = r * dx;
      ry[k] = r * dy;
      dxa[k] = st.dxa[k];
      dya[k] = st.dya[k];
    }
    // chunk gl+1's loads: in flight during this chunk's adds
    if (c + 1 < cgs) stage_2d(st, drift, base, planes, L, od, gl + 1, sync[gl + 1] == 0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PPT; ++k) {  // A adds
      const long long ixa = ((coin >> k) & 1u ? 0 : 1) * L + o + tid + k * STREAM_THREADS;
      drift[ixa] = dxa[k] + (-rx[k]);
      drift[ixa + 2 * L] = dya[k] + (-ry[k]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PPT; ++k) {  // B adds, after the A adds
      const long long ixb =
          ((coin >> (k + PPT)) & 1u ? 0 : 1) * L + o + D + tid + k * STREAM_THREADS;
      drift[ixb] = drift[ixb] + rx[k];
      drift[ixb + 2 * L] = drift[ixb + 2 * L] + ry[k];
    }
    __syncthreads();
  }
}

// Operands of one 1D chunk for a thread's PPT pairs, loaded ahead.
struct Staged1d {
  long long o, D;
  uint32_t valid;  // bit k: same path, and pos_a != pos_b
  bool has_drift;
  float term[PPT];
  float xa[PPT], xb[PPT];
  float da[PPT];
};

__device__ __forceinline__ void stage_1d(Staged1d& st, const float* drift,
                                         const float* __restrict__ base,
                                         const int* __restrict__ planes, long long L,
                                         const int* __restrict__ od, int gl,
                                         bool with_drift) {
  const int tid = threadIdx.x;
  const int* pos = planes;
  const int* path = planes + 2 * L;
  st.o = (long long)od[2 * gl] * LANE;
  st.D = od[2 * gl + 1];
  st.has_drift = with_drift;
  st.valid = 0u;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const long long a = st.o + tid + k * STREAM_THREADS;
    const long long b = a + st.D;
    const int di = pos[a] - pos[b];
    const int path_a = path[a];
    st.valid |= (uint32_t)((path_a == path[b]) && (path_a >= 0) && (di != 0)) << k;
    st.term[k] = (float)abs(di);
    st.xa[k] = base[a];
    st.xb[k] = base[b];
    if (with_drift) {
      st.da[k] = drift[a];
      st.xa[k] = st.xa[k] + st.da[k];
      st.xb[k] = st.xb[k] + drift[b];
    }
  }
}

__device__ __forceinline__ void stage_drift_1d(Staged1d& st, const float* drift) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const long long a = st.o + tid + k * STREAM_THREADS;
    st.da[k] = drift[a];
    st.xa[k] = st.xa[k] + st.da[k];
    st.xb[k] = st.xb[k] + drift[a + st.D];
  }
  st.has_drift = true;
}

// ---------------------------------------------------------------------------
// strata_chunks_1d_stream: the 1D chunk phase (one X plane, no coins, weight
// 1/d), pipelined as the 2D kernel.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(STREAM_THREADS, 1)
strata_chunks_1d_stream_kernel(float* drift, const float* __restrict__ base,
                               const int* __restrict__ planes, long long L,
                               const int* __restrict__ od, const int* __restrict__ sync,
                               const float* __restrict__ eta, int cpi, int g0, int cgs) {
  const int tid = threadIdx.x;
  Staged1d st;
  stage_1d(st, drift, base, planes, L, od, g0, true);
  for (int c = 0; c < cgs; ++c) {
    const int gl = g0 + c;
    if (!st.has_drift) stage_drift_1d(st, drift);
    const float lr = eta[gl / cpi];
    const long long o = st.o, D = st.D;
    float rr[PPT], da[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float term = st.term[k];
      const float w = 1.0f / fmaxf(term, 1e-30f);
      const float mu = fminf(lr * w, 1.0f);
      float dx = st.xa[k] - st.xb[k];
      if (dx == 0.0f) dx = 1e-9f;
      const float mag = fabsf(dx);
      const float delta = mu * (mag - term) * 0.5f;
      rr[k] = (st.valid >> k) & 1u ? delta / mag * dx : 0.0f;
      da[k] = st.da[k];
    }
    if (c + 1 < cgs) stage_1d(st, drift, base, planes, L, od, gl + 1, sync[gl + 1] == 0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PPT; ++k)  // A adds
      drift[o + tid + k * STREAM_THREADS] = da[k] - rr[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PPT; ++k) {  // B adds
      const long long b = o + D + tid + k * STREAM_THREADS;
      drift[b] = drift[b] + rr[k];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int strata_chunks_2d_stream(void* drift, const void* base, const void* planes, long long L,
                            const void* od, const void* sync, const void* eta, int cpi,
                            int g0, int cgs, void* stream) {
  strata_chunks_2d_stream_kernel<<<1, STREAM_THREADS, 0, (cudaStream_t)stream>>>(
      (float*)drift, (const float*)base, (const int*)planes, L, (const int*)od,
      (const int*)sync, (const float*)eta, cpi, g0, cgs);
  return (int)cudaGetLastError();
}

int strata_chunks_1d_stream(void* drift, const void* base, const void* planes, long long L,
                            const void* od, const void* sync, const void* eta, int cpi,
                            int g0, int cgs, void* stream) {
  strata_chunks_1d_stream_kernel<<<1, STREAM_THREADS, 0, (cudaStream_t)stream>>>(
      (float*)drift, (const float*)base, (const int*)planes, L, (const int*)od,
      (const int*)sync, (const float*)eta, cpi, g0, cgs);
  return (int)cudaGetLastError();
}

}  // extern "C"
