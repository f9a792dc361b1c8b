// The chunk phases by conflict levels for Hopper (sm_90a), with a plain C
// interface that ops/kernels.py binds through ctypes.
//
// strata_chunks_2d_levels replaces the 2D chunk phase of the JAX package's
// three 2D kernel families: _chunk_2d (odgi_tpu/ops/pallas_sgd.py:704)
// inside _make_kernel_2d (:1105), and the chunk phases of _make_kernel_xl
// (pallas_sgd_xl.py:363) and _make_kernel_xxl (pallas_sgd_xxl.py:212).  It
// gives the drift of strata_chunks_2d / strata_chunks_2d_stream bit for bit.
// strata_chunks_1d_levels replaces the 1D chunk phase the same way:
// _chunk_1d (pallas_sgd.py:786) inside _make_kernel_1d (:1158), and
// _run_chunks_1d (pallas_sgd_xl.py:672) inside _make_kernel_xl_1d (:795) and
// _make_kernel_xxl_1d (pallas_sgd_xxl.py:632); it gives the drift of
// strata_chunks_1d / strata_chunks_1d_stream bit for bit.
//
// Why it is bit-exact.  The chunks of a merge group compound in order, but
// two chunks whose slot footprints are disjoint commute exactly: neither
// reads or writes a slot of the other.  The host (ops/strata_levels.py)
// gives each chunk a level, 1 + the highest level of any earlier chunk of
// its group whose footprint (the 128-slot blocks of its A and B windows)
// shares a block with it, and sorts the group's chunks by (level, index)
// into perm.  A footprint depends only on the chunk's (o, D), so 1D and 2D
// plans level alike.  Chunks of one level are pairwise slot-disjoint, and
// every chunk runs after every earlier chunk it conflicts with, so running
// the levels in order, each level's chunks in any order or at once, gives
// the chain's result.  Each chunk runs strata::chunk_2d / chunk_1d, the
// chain kernels' bodies, with its global index (coins, eta row) taken from
// perm; built with -fmad=false.
//
// The grid is persistent: as many blocks as fit on the card at once (sized
// by the occupancy calculator, one figure per kernel and device), launched
// cooperatively so that the runtime refuses the launch rather than leave a
// block unscheduled.  Within level l, block b takes chunks perm[off[l] + b],
// perm[off[l] + b + gridDim.x], ...; a grid-wide barrier separates levels.
// The barrier is the cooperative-groups scheme written out (one counter;
// block 0 adds 2^31 - (blocks - 1), the others 1, so its top bit flips when
// the last block arrives; a fence before and after), which needs no
// relocatable device code; the counter is a scratch word the wrapper keeps.
//
// Block shape.  Both kernels run 1024 threads of 4 pairs, one block an SM
// (2D: a pair keeps ten words across the chunk's barriers, 56 registers a
// thread).  A 1D pair keeps two floats, so blocks of 256 or 512 threads
// could put four or two chunks on an SM; on the card they were slower
// (PERF.md): more chunks an SM at once do not pay for each chunk's longer
// serial part behind its barriers.
//
// Bound on this card: levels x the time of one chunk (a few microseconds of
// dependent loads and three block barriers) x the waves a level needs,
// plus a grid barrier a level.  The bytes bound (each touched slot's planes
// once) is 0.027 / 0.089 / 0.167 ms a 2D launch and 0.008 / 0.025 / 0.052 ms
// a 1D launch on the smoke, XL and 1M-node graphs; the chain kernels run a
// group's chunks on one SM (1D: 1.2-9.6 ms a launch).  A 2D group holds
// 15-60 levels of about 50-190 chunks, a 1D group 9-22 levels of about
// 36-180.
//
// Delta early stop (-j).  Each kernel has a second instance, TRACK, which
// also writes the group's Delta_max, the max of |delta| over the group's
// valid pairs: the `dmax` output the reference's kernels give with `track`
// (odgi_tpu/ops/pallas_sgd.py:763-769, :820-823, out-spec :1241-1244).
// Each thread keeps the max over its pairs, each block reduces it and
// raises the group's word by one atomicMax; the drift is the untracked
// instance's, bit for bit.  A run without delta never launches it.
//
// Every entry launches on the given stream, allocates nothing and returns
// the CUDA error of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "strata_common.cuh"

namespace {

using strata::LANE;

constexpr int LEVEL_THREADS = 1024;  // 4 pairs a thread, as the chain kernels
constexpr int MAX_DEVICES = 64;
// Occupancy cache slots, one a kernel instance.
enum { SLOT_2D = 0, SLOT_1D, SLOT_2D_TRACK, SLOT_1D_TRACK, NSLOTS };

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

// The tracking instances' Delta_max: the block's max of its threads' `dm`
// (a warp fmaxf shuffle, then one warp over the warps' maxima), written by
// one atomicMax on the float's bit pattern into *dmax.  Every value is a
// non-negative float, whose bit patterns order as the floats do, so the
// result is exact and does not depend on the order the blocks arrive in.
__device__ __forceinline__ void block_max_into(float dm, float* dmax) {
  __shared__ float warp_max[LEVEL_THREADS / 32];
  for (int off = 16; off > 0; off >>= 1) dm = fmaxf(dm, __shfl_xor_sync(0xffffffffu, dm, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = dm;
  __syncthreads();
  if (warp == 0) {
    dm = warp_max[lane];
    for (int off = 16; off > 0; off >>= 1) dm = fmaxf(dm, __shfl_xor_sync(0xffffffffu, dm, off));
    if (lane == 0 && dm > 0.0f) atomicMax(reinterpret_cast<int*>(dmax), __float_as_int(dm));
  }
}

// TRACK: also reduce the group's Delta_max into *dmax (the reference's
// `track` output of _make_kernel_2d / _1d); without it the instance is the
// untracked kernel.
template <bool TRACK>
__global__ void __launch_bounds__(LEVEL_THREADS, 1)
strata_chunks_2d_levels_kernel(float* drift, const float* __restrict__ base,
                               const int* __restrict__ planes, long long L,
                               const int* __restrict__ od, const float* __restrict__ eta,
                               int cpi, const int* __restrict__ perm,
                               const int* __restrict__ lvl_off, int nlev,
                               unsigned int* counter, float* dmax) {
  float dm = 0.0f;
  for (int lv = 0; lv < nlev; ++lv) {
    const int k1 = lvl_off[lv + 1];
    for (int k = lvl_off[lv] + blockIdx.x; k < k1; k += gridDim.x) {
      const int gl = perm[k];
      const long long o = (long long)od[2 * gl] * LANE;
      const long long D = od[2 * gl + 1];
      // chunks of one level share no slot: no barrier between them
      const float m = strata::chunk_2d<LEVEL_THREADS, TRACK>(drift, base, planes, L, o, D,
                                                             eta[gl / cpi], gl);
      if constexpr (TRACK) dm = fmaxf(dm, m);
    }
    if (lv + 1 < nlev) grid_barrier(counter);
  }
  if constexpr (TRACK) block_max_into(dm, dmax);
}

template <bool TRACK>
__global__ void __launch_bounds__(LEVEL_THREADS, 1)
strata_chunks_1d_levels_kernel(float* drift, const float* __restrict__ base,
                               const int* __restrict__ planes, long long L,
                               const int* __restrict__ od, const float* __restrict__ eta,
                               int cpi, const int* __restrict__ perm,
                               const int* __restrict__ lvl_off, int nlev,
                               unsigned int* counter, float* dmax) {
  float dm = 0.0f;
  for (int lv = 0; lv < nlev; ++lv) {
    const int k1 = lvl_off[lv + 1];
    for (int k = lvl_off[lv] + blockIdx.x; k < k1; k += gridDim.x) {
      const int gl = perm[k];
      const long long o = (long long)od[2 * gl] * LANE;
      const long long D = od[2 * gl + 1];
      const float m = strata::chunk_1d<LEVEL_THREADS, TRACK>(drift, base, planes, L, o, D,
                                                             eta[gl / cpi]);
      if constexpr (TRACK) dm = fmaxf(dm, m);
    }
    if (lv + 1 < nlev) grid_barrier(counter);
  }
  if constexpr (TRACK) block_max_into(dm, dmax);
}

// The leveled kernel of a cache slot.
const void* level_kernel(int slot) {
  switch (slot) {
    case SLOT_2D: return (const void*)strata_chunks_2d_levels_kernel<false>;
    case SLOT_1D: return (const void*)strata_chunks_1d_levels_kernel<false>;
    case SLOT_2D_TRACK: return (const void*)strata_chunks_2d_levels_kernel<true>;
    default: return (const void*)strata_chunks_1d_levels_kernel<true>;
  }
}

// Blocks of the persistent grid of the slot's kernel on the current device,
// cached per (slot, device).
int grid_blocks(int slot, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static int cached[NSLOTS][MAX_DEVICES] = {{0}};
  if (dev < MAX_DEVICES && cached[slot][dev] > 0) {
    *out = cached[slot][dev];
    return 0;
  }
  int sms = 0, per_sm = 0, coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, level_kernel(slot),
                                                      LEVEL_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  if (dev < MAX_DEVICES) cached[slot][dev] = *out;
  return 0;
}

// dmax null: the untracked instance; else the tracking one, reducing into
// *dmax.
int launch_levels(int slot, void* drift, const void* base, const void* planes, long long L,
                  const void* od, const void* eta, int cpi, const void* perm,
                  const void* lvl_off, int nlev, void* counter, void* dmax, void* stream) {
  if (dmax != nullptr) slot = slot == SLOT_2D ? SLOT_2D_TRACK : SLOT_1D_TRACK;
  int blocks = 0;
  const int err = grid_blocks(slot, &blocks);
  if (err != 0) return err;
  void* args[] = {&drift, &base,    &planes, &L,       &od,   &eta,
                  &cpi,   &perm,    &lvl_off, &nlev,  &counter, &dmax};
  const cudaError_t lerr = cudaLaunchCooperativeKernel(level_kernel(slot), dim3(blocks),
                                                       dim3(LEVEL_THREADS), args, 0,
                                                       (cudaStream_t)stream);
  if (lerr != cudaSuccess) return (int)lerr;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the persistent grid of the untracked 2D (one_d 0) or 1D kernel
// on the current device (0 on error).
int strata_chunks_levels_blocks(int one_d) {
  int blocks = 0;
  return grid_blocks(one_d ? SLOT_1D : SLOT_2D, &blocks) == 0 ? blocks : 0;
}

// perm: the run's chunks sorted by (group, level, index); lvl_off: nlev + 1
// offsets into perm, the group's levels; counter: one scratch word; dmax:
// null, or the group's f32 Delta_max word (the tracking instance raises it
// to the group's max |delta|; the caller zeroes it once).
int strata_chunks_2d_levels(void* drift, const void* base, const void* planes, long long L,
                            const void* od, const void* eta, int cpi, const void* perm,
                            const void* lvl_off, int nlev, void* counter, void* dmax,
                            void* stream) {
  return launch_levels(SLOT_2D, drift, base, planes, L, od, eta, cpi, perm, lvl_off, nlev,
                       counter, dmax, stream);
}

// As strata_chunks_2d_levels.
int strata_chunks_1d_levels(void* drift, const void* base, const void* planes, long long L,
                            const void* od, const void* eta, int cpi, const void* perm,
                            const void* lvl_off, int nlev, void* counter, void* dmax,
                            void* stream) {
  return launch_levels(SLOT_1D, drift, base, planes, L, od, eta, cpi, perm, lvl_off, nlev,
                       counter, dmax, stream);
}

}  // extern "C"
