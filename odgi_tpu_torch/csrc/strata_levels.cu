// The 2D chunk phase by conflict levels for Hopper (sm_90a), with a plain C
// interface that ops/kernels.py binds through ctypes.
//
// strata_chunks_2d_levels replaces the 2D chunk phase of the JAX package's
// three 2D kernel families: _chunk_2d (odgi_tpu/ops/pallas_sgd.py:704)
// inside _make_kernel_2d (:1105), and the chunk phases of _make_kernel_xl
// (pallas_sgd_xl.py:363) and _make_kernel_xxl (pallas_sgd_xxl.py:212).  It
// gives the drift of strata_chunks_2d / strata_chunks_2d_stream bit for bit.
//
// Why it is bit-exact.  The chunks of a merge group compound in order, but
// two chunks whose slot footprints are disjoint commute exactly: neither
// reads or writes a slot of the other.  The host (ops/strata_levels.py)
// gives each chunk a level, 1 + the highest level of any earlier chunk of
// its group whose footprint (the 128-slot blocks of its A and B windows)
// shares a block with it, and sorts the group's chunks by (level, index)
// into perm.  Chunks of one level are pairwise slot-disjoint, and every
// chunk runs after every earlier chunk it conflicts with, so running the
// levels in order, each level's chunks in any order or at once, gives the
// chain's result.  Each chunk runs strata::chunk_2d, the chain kernel's
// body, with its global index (coins, eta row) taken from perm; built with
// -fmad=false.
//
// The grid is persistent: as many 1024-thread blocks as fit on the card at
// once (one an SM, sized by the occupancy calculator), launched
// cooperatively so that the runtime refuses the launch rather than leave a
// block unscheduled.  Within level l, block b takes chunks perm[off[l] + b],
// perm[off[l] + b + gridDim.x], ...; a grid-wide barrier separates levels.
// The barrier is the cooperative-groups scheme written out (one counter;
// block 0 adds 2^31 - (blocks - 1), the others 1, so its top bit flips when
// the last block arrives; a fence before and after), which needs no
// relocatable device code; the counter is a scratch word the wrapper keeps.
//
// Bound on this card: levels x the time of one chunk (a few microseconds of
// dependent loads and three block barriers) x the waves a level needs,
// plus a grid barrier a level.  The bytes bound (each touched slot's planes
// once) is 0.027 / 0.089 / 0.167 ms a launch on the smoke, XL and 1M-node
// graphs; the chain kernel it replaces runs a group's 2,300-3,800 chunks on
// one SM (16-28 ms a launch).  A 2D group holds 15-60 levels of about
// 50-190 chunks each, so a level takes one or two waves of 132 blocks.
//
// Every entry launches on the given stream, allocates nothing and returns
// the CUDA error of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "strata_common.cuh"

namespace {

using strata::LANE;

constexpr int LEVEL_THREADS = 1024;  // 4 pairs a thread, as the chain kernel
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ void grid_barrier(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();  // this block's writes before the arrival
    const unsigned int old = atomicAdd(counter, add);
    volatile unsigned int* vc = counter;
    while (((old ^ *vc) & 0x80000000u) == 0u) {
    }
    __threadfence();  // the other blocks' writes before this block reads on
  }
  __syncthreads();
}

__global__ void __launch_bounds__(LEVEL_THREADS, 1)
strata_chunks_2d_levels_kernel(float* drift, const float* __restrict__ base,
                               const int* __restrict__ planes, long long L,
                               const int* __restrict__ od, const float* __restrict__ eta,
                               int cpi, const int* __restrict__ perm,
                               const int* __restrict__ lvl_off, int nlev,
                               unsigned int* counter) {
  for (int lv = 0; lv < nlev; ++lv) {
    const int k1 = lvl_off[lv + 1];
    for (int k = lvl_off[lv] + blockIdx.x; k < k1; k += gridDim.x) {
      const int gl = perm[k];
      const long long o = (long long)od[2 * gl] * LANE;
      const long long D = od[2 * gl + 1];
      // chunks of one level share no slot: no barrier between them
      strata::chunk_2d<LEVEL_THREADS>(drift, base, planes, L, o, D, eta[gl / cpi], gl);
    }
    if (lv + 1 < nlev) grid_barrier(counter);
  }
}

int grid_blocks(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static int cached[MAX_DEVICES] = {0};
  if (dev < MAX_DEVICES && cached[dev] > 0) {
    *out = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0, coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, strata_chunks_2d_levels_kernel,
                                                      LEVEL_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  if (dev < MAX_DEVICES) cached[dev] = *out;
  return 0;
}

}  // namespace

extern "C" {

// Blocks of the persistent grid on the current device (0 on error).
int strata_chunks_2d_levels_blocks() {
  int blocks = 0;
  return grid_blocks(&blocks) == 0 ? blocks : 0;
}

// perm: the run's chunks sorted by (group, level, index); lvl_off: nlev + 1
// offsets into perm, the group's levels; counter: one scratch word.
int strata_chunks_2d_levels(void* drift, const void* base, const void* planes, long long L,
                            const void* od, const void* eta, int cpi, const void* perm,
                            const void* lvl_off, int nlev, void* counter, void* stream) {
  int blocks = 0;
  const int err = grid_blocks(&blocks);
  if (err != 0) return err;
  float* drift_p = (float*)drift;
  const float* base_p = (const float*)base;
  const int* planes_p = (const int*)planes;
  const int* od_p = (const int*)od;
  const float* eta_p = (const float*)eta;
  const int* perm_p = (const int*)perm;
  const int* off_p = (const int*)lvl_off;
  unsigned int* counter_p = (unsigned int*)counter;
  void* args[] = {&drift_p, &base_p, &planes_p, &L,     &od_p,      &eta_p,
                  &cpi,     &perm_p, &off_p,    &nlev,  &counter_p};
  const cudaError_t lerr =
      cudaLaunchCooperativeKernel((const void*)strata_chunks_2d_levels_kernel, dim3(blocks),
                                  dim3(LEVEL_THREADS), args, 0, (cudaStream_t)stream);
  if (lerr != cudaSuccess) return (int)lerr;
  return (int)cudaGetLastError();
}

}  // extern "C"
