// The chunk phases by conflict levels for Hopper (sm_90a), with a plain C
// interface that ops/kernels.py binds through ctypes.
//
// strata_chunks_2d_levels replaces the 2D chunk phase of the JAX package's
// three 2D kernel families: _chunk_2d (odgi_tpu/ops/pallas_sgd.py:704)
// inside _make_kernel_2d (:1105), and the chunk phases of _make_kernel_xl
// (pallas_sgd_xl.py:363) and _make_kernel_xxl (pallas_sgd_xxl.py:212).  It
// gives the drift of the chain kernel strata_chunks_2d bit for bit.
// strata_chunks_1d_levels replaces the 1D chunk phase the same way:
// _chunk_1d (pallas_sgd.py:786) inside _make_kernel_1d (:1158), and
// _run_chunks_1d (pallas_sgd_xl.py:672) inside _make_kernel_xl_1d (:795) and
// _make_kernel_xxl_1d (pallas_sgd_xxl.py:632); it gives the drift of
// strata_chunks_1d bit for bit.
//
// Why it is bit-exact.  The chunks of a merge group compound in order, but
// two chunks whose slot footprints (the 128-slot blocks of their A and B
// windows) are disjoint commute exactly.  The host (ops/strata_levels.py)
// gives each chunk its predecessors, the last earlier chunk on each block
// of its footprint, and a level (1 + the highest level of its
// predecessors), and sorts the group's chunks by (level, index) into perm.
// Every chunk that runs after its predecessors runs after every earlier
// chunk it conflicts with, so any such order gives the chain's result.  Each
// pair's arithmetic and order within its chunk are the chain kernels'
// (strata_common.cuh: pair_2d_ro / _rw and pair_1d_ro / _rw, the read
// phase, the A adds, the B adds), built with -fmad=false.
//
// Bound on this card.  A group of the main path holds 20-60 conflict
// levels (smoke, XL and 1M-node graphs) of 37-190 chunks, and a 2D chunk
// pulls about 360 KB of 32-byte sectors (eleven words at each of its 8,192
// slots: the coin picks one of two planes a pair, so a warp pulls both
// planes' sectors) where its pairs use 196 KB; a 1D chunk 131 KB.  The
// bytes bound counts each slot a group touches once (0.027 / 0.089 / 0.167
// ms a 2D launch), but a group's chunks touch its slots about six times
// over, mostly past the 50 MB L2.  The design before this one ran one chunk
// on one 1024-thread block, a persistent cooperative grid of one block an
// SM, and a grid barrier after each level: a level's time was its slowest
// chunk, a second wave when it held more than 132 chunks, and the barrier
// (12% of a smoke 2D launch, 30% of a 1D one).  It lost to the clusters
// below on the card and was retired (PERF.md section 6).
//
// What this design does about it:
// - No grid barrier: clusters take chunks by an atomic ticket in perm
//   order, and a chunk waits (one warp, acquire loads, a lane a
//   predecessor) only until each of its predecessors' done word holds this
//   launch's epoch; its cluster then raises its own (a release store after
//   a fence and a cluster barrier).  Levels overlap: a chunk starts when
//   the chunks it needs are done, not when its level's slowest chunk and
//   the barrier are.  A cluster takes its next ticket while it runs its
//   chunk.  This cannot deadlock, even without co-residency: a chunk waits
//   only on chunks of earlier tickets, each already taken by a running
//   cluster, and the earliest unfinished chunk never waits.  The cluster
//   that takes the launch's last ticket (each cluster takes one past the
//   end) puts the ticket back to 0.
// - A chunk loads its read-only words (coins, pos, path, base; rate and
//   term) before it waits, so only its drift reads follow the wait.
// - A 2D chunk runs on a thread-block cluster of 4 blocks on 4 SMs, a
//   tile of 1024 pairs each, one pair a thread: its loads spread over four
//   SMs' load paths.  A 1D chunk, a third of the bytes, runs on one
//   1024-thread block (clusters of 2 and 4 were slower there).  A chunk
//   with D >= CHUNK has disjoint A and B windows: each pair reads and adds
//   on its own, with no barrier.  A chunk with D < CHUNK runs the read
//   phase, the A adds and the B adds with a cluster barrier
//   (barrier.cluster, release / acquire) between them in place of the chain kernels'
//   __syncthreads.  Drift is read from L2 (ld.cg): another SM may have
//   written it since.
// - The ticket and the done words (one a chunk of the run) are scratch the
//   wrapper keeps, zero at first; the epoch is the wrapper's launch count
//   on the device, so no word is reset between launches.  Nothing is
//   allocated, and a refused launch returns its error.
// With the barriers and waves gone, a launch on the XL and 1M-node graphs
// pulls its chunks' sectors at about 2 TB/s: what is left is their bytes.

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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "strata_common.cuh"

namespace cg = cooperative_groups;

namespace {

using strata::CHUNK;
using strata::LANE;

constexpr int MAX_DEVICES = 64;
constexpr int CACHE_SLOTS = 16;  // occupancy figures: a slot a kernel instance

// ---------------------------------------------------------------------------
// The leveled kernels: a cluster a chunk, tickets and predecessor waits.
// ---------------------------------------------------------------------------

// Blocks (SMs) a chunk and threads a block, 2D and 1D: a 2D chunk on four
// SMs, one pair a thread; a 1D chunk on one SM, four pairs a thread (the
// shapes tools/levels_variants.py timed fastest on the card, PERF.md).
constexpr int CLUSTER_2D = 4, THREADS_2D = 1024;
constexpr int CLUSTER_1D = 1, THREADS_1D = 1024;
constexpr unsigned MAX_SPINS = 1u << 24;  // polls of one done word, about 10 s

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The barrier of a chunk's blocks: the cluster's, or the block's alone.
template <int C>
struct ChunkBar {
  __device__ __forceinline__ void operator()() const {
    if constexpr (C > 1) cg::this_cluster().sync(); else __syncthreads();
  }
};

// The tracking instances' Delta_max: the block's max of its threads' `dm`
// (a warp fmaxf shuffle, then one warp over the warps' maxima), written by
// one atomicMax on the float's bit pattern into *dmax.  Every value is a
// non-negative float, whose bit patterns order as the floats do, so the
// result is exact and does not depend on the order the blocks arrive in.
template <int THREADS>
__device__ __forceinline__ void block_max_into(float dm, float* dmax) {
  __shared__ float warp_max[32];
  for (int off = 16; off > 0; off >>= 1) dm = fmaxf(dm, __shfl_xor_sync(0xffffffffu, dm, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = dm;
  __syncthreads();
  if (warp == 0) {
    dm = lane < THREADS / 32 ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) dm = fmaxf(dm, __shfl_xor_sync(0xffffffffu, dm, off));
    if (lane == 0 && dm > 0.0f) atomicMax(reinterpret_cast<int*>(dmax), __float_as_int(dm));
  }
}

// One merge group's chunks perm[lvl_off[0] .. lvl_off[nlev]) (n of them):
// clusters of C blocks of T threads take them in perm order by the ticket
// `flow[0]`; chunk j waits until done[p] == epoch for each p in
// pred[pred_off[j] .. pred_off[j+1]), with done = flow + 1 (a word a chunk
// of the run), and then sets done[j] = epoch.  TRACK: also reduce the
// group's Delta_max into *dmax.
#define LEVELS_PARAMS                                                                     \
  float *drift, const float *__restrict__ base, const int *__restrict__ planes, long long L, \
      const int *__restrict__ od, const float *__restrict__ eta, int cpi,                    \
      const int *__restrict__ perm, const int *__restrict__ lvl_off, int nlev,               \
      const int *__restrict__ pred_off, const int *__restrict__ pred, unsigned *flow,        \
      unsigned epoch, float *dmax
#define LEVELS_ARGS \
  drift, base, planes, L, od, eta, cpi, perm, lvl_off, nlev, pred_off, pred, flow, epoch, dmax

template <int C, int T, bool ONE_D, bool TRACK>
__device__ __forceinline__ void levels_body(LEVELS_PARAMS) {
  constexpr int NP = CHUNK / C;  // pairs a block
  __shared__ int next[2];        // rank 0's tickets, read by the cluster
  __shared__ int item;
  unsigned* ticket = flow;
  unsigned* done = flow + 1;
  const unsigned rank = C > 1 ? cg::this_cluster().block_rank() : 0u;
  const bool lead = rank == 0 && threadIdx.x == 0;
  const int g0 = lvl_off[0];
  const int n = lvl_off[nlev] - g0;
  const int clusters = gridDim.x / C;
  const ChunkBar<C> bar;
  float dm = 0.0f;
  if (lead) next[0] = (int)atomicAdd(ticket, 1u);
  bar();
  for (int it = 0;; ++it) {
    if (threadIdx.x == 0) {
      if constexpr (C > 1) item = *cg::this_cluster().map_shared_rank(&next[it & 1], 0);
      else item = next[it & 1];
    }
    __syncthreads();
    const int t = item;
    if (t >= n) {  // the same for every block of the cluster
      if (lead && t == n + clusters - 1) *ticket = 0u;  // the launch's last ticket
      break;
    }
    const int gl = perm[g0 + t];
    const long long o = (long long)od[2 * gl] * LANE;
    const long long D = od[2 * gl + 1];
    const float lr = eta[gl / cpi];
    const int p0 = (int)rank * NP;
    // Between the pairs' read-only loads and their drift reads: wait for
    // the chunk's predecessors (one warp, a lane a predecessor) and take
    // the next ticket.
    const auto wait = [&]() {
      if (threadIdx.x < 32) {
        const int j1 = pred_off[gl + 1];
        for (int j = pred_off[gl] + (int)threadIdx.x; j < j1; j += 32) {
          // a chunk waits microseconds; seconds mean a broken schedule:
          // fail the launch rather than hang the card
          for (unsigned spins = 0; ld_acquire(done + pred[j]) != epoch; ++spins)
            if (spins == MAX_SPINS) __trap();
        }
      }
      if (lead) next[(it + 1) & 1] = (int)atomicAdd(ticket, 1u);
      __syncthreads();
    };
    float m;
    if constexpr (ONE_D) {
      m = D >= CHUNK
              ? strata::tile_1d_apart<T, NP, TRACK>(drift, base, planes, L, o, D, lr, p0, wait)
              : strata::tile_1d<T, NP, TRACK>(drift, base, planes, L, o, D, lr, p0, bar, wait);
    } else {
      m = D >= CHUNK ? strata::tile_2d_apart<T, NP, TRACK>(drift, base, planes, L, o, D, lr,
                                                          gl, p0, wait)
                     : strata::tile_2d<T, NP, TRACK>(drift, base, planes, L, o, D, lr, gl, p0,
                                                     bar, wait);
    }
    if constexpr (TRACK) dm = fmaxf(dm, m);
    __threadfence();  // this thread's adds, before the chunk is done
    bar();
    if (lead) st_release(done + gl, epoch);
  }
  bar();  // no block leaves while another may read its `next`
  if constexpr (TRACK) block_max_into<T>(dm, dmax);
}

template <int C, int T, bool TRACK>
__global__ void __launch_bounds__(T) strata_chunks_2d_levels_kernel(LEVELS_PARAMS) {
  levels_body<C, T, false, TRACK>(LEVELS_ARGS);
}

template <int C, int T, bool TRACK>
__global__ void __launch_bounds__(T) strata_chunks_1d_levels_kernel(LEVELS_PARAMS) {
  levels_body<C, T, true, TRACK>(LEVELS_ARGS);
}

template <bool ONE_D, bool TRACK>
const void* levels_kernel() {
  if constexpr (ONE_D)
    return (const void*)strata_chunks_1d_levels_kernel<CLUSTER_1D, THREADS_1D, TRACK>;
  else
    return (const void*)strata_chunks_2d_levels_kernel<CLUSTER_2D, THREADS_2D, TRACK>;
}

// The launch configuration of C-block clusters of T threads.
struct ClusterConfig {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  ClusterConfig(int C, int T, int blocks, cudaStream_t stream) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(T);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of the kernel `fn` that fit on the current device at once,
// cached per (kernel slot, device): the grid, C blocks each.
int max_clusters(const void* fn, int C, int T, int slot, int* out) {
  static int cached[CACHE_SLOTS][MAX_DEVICES] = {{0}};
  if (slot < 0 || slot >= CACHE_SLOTS) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEVICES && cached[slot][dev] > 0) {
    *out = cached[slot][dev];
    return 0;
  }
  ClusterConfig c(C, T, C, 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fn, &c.cfg);
  if (err != cudaSuccess) return (int)err;
  if (n < 1) return (int)cudaErrorInvalidConfiguration;
  *out = n;
  if (dev < MAX_DEVICES) cached[slot][dev] = n;
  return 0;
}

// Launch the leveled kernel `fn` (C-block clusters of T threads), one
// cluster for every cluster that fits; `slot` keys its grid in the cache.
int launch_clusters(const void* fn, int C, int T, int slot, void* drift, const void* base,
                    const void* planes, long long L, const void* od, const void* eta, int cpi,
                    const void* perm, const void* lvl_off, int nlev, const void* pred_off,
                    const void* pred, void* flow, unsigned epoch, void* dmax, void* stream) {
  int clusters = 0;
  const int err = max_clusters(fn, C, T, slot, &clusters);
  if (err != 0) return err;
  ClusterConfig c(C, T, clusters * C, (cudaStream_t)stream);
  void* args[] = {&drift, &base, &planes, &L,        &od,   &eta,  &cpi,   &perm,
                  &lvl_off, &nlev, &pred_off, &pred, &flow, &epoch, &dmax};
  const cudaError_t lerr = cudaLaunchKernelExC(&c.cfg, fn, args);
  if (lerr != cudaSuccess) return (int)lerr;
  return (int)cudaGetLastError();
}

int launch_levels(bool one_d, void* drift, const void* base, const void* planes, long long L,
                  const void* od, const void* eta, int cpi, const void* perm,
                  const void* lvl_off, int nlev, const void* pred_off, const void* pred,
                  void* flow, unsigned epoch, void* dmax, void* stream) {
  const bool track = dmax != nullptr;
  const void* fn = one_d ? (track ? levels_kernel<true, true>() : levels_kernel<true, false>())
                         : (track ? levels_kernel<false, true>() : levels_kernel<false, false>());
  const int slot = (one_d ? 1 : 0) + (track ? 2 : 0);
  return launch_clusters(fn, one_d ? CLUSTER_1D : CLUSTER_2D, one_d ? THREADS_1D : THREADS_2D,
                         slot, drift, base, planes, L, od, eta, cpi, perm, lvl_off, nlev,
                         pred_off, pred, flow, epoch, dmax, stream);
}

}  // namespace

extern "C" {

// Clusters of the untracked 2D (one_d 0) or 1D leveled kernel that fit on
// the current device at once (0 on error), and its blocks a cluster.
int strata_chunks_levels_clusters(int one_d) {
  int n = 0;
  const void* fn = one_d ? levels_kernel<true, false>() : levels_kernel<false, false>();
  return max_clusters(fn, one_d ? CLUSTER_1D : CLUSTER_2D, one_d ? THREADS_1D : THREADS_2D,
                      one_d ? 1 : 0, &n) == 0 ? n : 0;
}

int strata_chunks_levels_cluster_blocks(int one_d) { return one_d ? CLUSTER_1D : CLUSTER_2D; }

// perm: the run's chunks sorted by (group, level, index); lvl_off: nlev + 1
// offsets into perm, the group's levels (the kernel reads the first and the
// last); pred_off, pred: the run's predecessor lists (chunks + 1 offsets;
// global chunk indices); flow: chunks + 1 scratch words, zero before the
// first launch; epoch: nonzero, new for every launch on the device; dmax:
// null, or the group's f32 Delta_max word (the tracking instance raises it
// to the group's max |delta|; the caller zeroes it once).
int strata_chunks_2d_levels(void* drift, const void* base, const void* planes, long long L,
                            const void* od, const void* eta, int cpi, const void* perm,
                            const void* lvl_off, int nlev, const void* pred_off,
                            const void* pred, void* flow, unsigned epoch, void* dmax,
                            void* stream) {
  return launch_levels(false, drift, base, planes, L, od, eta, cpi, perm, lvl_off, nlev,
                       pred_off, pred, flow, epoch, dmax, stream);
}

// As strata_chunks_2d_levels.
int strata_chunks_1d_levels(void* drift, const void* base, const void* planes, long long L,
                            const void* od, const void* eta, int cpi, const void* perm,
                            const void* lvl_off, int nlev, const void* pred_off,
                            const void* pred, void* flow, unsigned epoch, void* dmax,
                            void* stream) {
  return launch_levels(true, drift, base, planes, L, od, eta, cpi, perm, lvl_off, nlev,
                       pred_off, pred, flow, epoch, dmax, stream);
}

}  // extern "C"
