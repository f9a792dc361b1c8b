// Blocked consensus merges of the XXL route for Hopper (sm_90a), with a
// plain C interface that ops/kernels.py binds through ctypes.
//
// They replace the block-scheduled merge of the JAX package's big-N
// kernels (odgi_tpu/ops/pallas_sgd_xxl.py):
//   strata_merge_sum_blocked<NC>: the scatter pass (:363-418) of
//     _make_kernel_xxl (NC = 2, :212) and of _make_kernel_xxl_1d (NC = 1,
//     :632, scatter at :754-782)
//   strata_merge_bcast_blocked<NC>: the broadcast pass (:422-447,
//     :784-796) and the drift-zeroing pass (:449-457, :798-804)
// and give the same sums, updates, coordinates and base as
// strata_merge_sum / strata_merge_bcast (strata_sgd.cu), bit for bit.
//
// The schedule (ops/strata_xxl.py) lists the (node block, step tile) pairs
// that hold a real step, sorted by (block, tile); a block's entries are
// contiguous (blk_off).  Nodes are relabeled by first visit, so a block's
// slots lie in few tiles.
//
// strata_merge_sum_blocked: one thread block per node block of bs
// endpoints.  Its f64 accumulators, its slice of 1/R and of the
// coordinates, and one cursor per endpoint into the endpoint's CSR list
// (ascending slots: the cursor, the list's end and the slot under the
// cursor) live in shared memory.  It walks its entries in ascending tile
// order; per entry it loads the tile's drift planes into shared memory
// with coalesced loads, then each thread advances the cursors of its
// endpoints through the slots that lie in the tile, adding each into the
// endpoint's sum.  An endpoint with no slot in the tile costs one shared
// read; device memory is read only for the slots consumed.  So every sum runs over its slots in
// ascending order, as np.bincount and strata_merge_sum do.  The cursors
// read the CSR, so the tile's handles are not loaded.  2D: a thread owns a
// node (endpoints 2n, 2n+1); the list of endpoint e feeds e's forward sums
// (planes 0, 2) and e^1's reverse sums (planes 1, 3).  No float atomics.
// Shared memory a block, bs = 2048: 2D 200 KB (4 f64 sums, 1/R, 2 f64
// coordinates and a 3-int cursor per endpoint, one 4-plane f32 tile),
// 1D 88 KB.
//
// strata_merge_bcast_blocked: one thread block per schedule entry.  It
// stages the block's update (rounded to f32) in shared memory and walks the
// tile's slots; a real slot whose endpoint lies in the block takes the
// update into base and has its drift zeroed.  Every real slot belongs to
// exactly one entry, so no two thread blocks write one slot.  Thread
// blocks past the last entry zero the drift of the pad slots [S, L).
//
// Bound on this card: bytes.  By the function: the drift of every real
// slot, the CSR, 1/R and the coordinates once (sum); every slot's endpoint,
// base and drift once (broadcast).  By the schedule: every scheduled
// (block, tile) pair's tile read once, plus the node arrays once; the
// ratio of tile reads to tiles is what relabeling keeps small
// (chip_smoke.py reports it).  What the design does about it: each tile
// read is one coalesced pass into shared memory, all of a thread's loads
// in flight at once, and each slot's accumulation reads shared memory, not
// a gather from device memory.  On the 1M-node graph the 2D schedule
// still reads 6.6 tiles a tile (1.06 GB a merge), more than the CSR
// merge's gather moves, so strata_merge_sum stays the faster merge on this
// card (PERF.md).
//
// Every entry launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "strata_common.cuh"

namespace {

using strata::TILE;

constexpr int SUM_THREADS = 1024;
constexpr int BCAST_THREADS = 512;

template <int NC>
__host__ __device__ constexpr int drift_planes() { return NC == 1 ? 1 : 4; }

// Shared-memory bytes of the sum kernel for a block of bs endpoints.
template <int NC>
size_t sum_smem_bytes(int bs) {
  const int nacc = drift_planes<NC>();  // 2D: forward and reverse sums per channel
  return (size_t)bs * sizeof(double) * (nacc + 1 + NC) +
         (size_t)drift_planes<NC>() * TILE * sizeof(float) + (size_t)bs * 3 * sizeof(int);
}

template <int NC>
__global__ void __launch_bounds__(SUM_THREADS, 1)
strata_merge_sum_blocked_kernel(const float* __restrict__ drift, long long L,
                                const int* __restrict__ csr_off,
                                const int* __restrict__ csr_slot,
                                const double* __restrict__ recip,
                                double* __restrict__ coords, double* __restrict__ upd,
                                int E, int ecap, const int* __restrict__ sched_tile,
                                const int* __restrict__ blk_off, int bs) {
  constexpr int NP = drift_planes<NC>();
  extern __shared__ __align__(16) unsigned char smem[];
  double* acc = reinterpret_cast<double*>(smem);  // [NP][bs]: 2D x_fwd, x_rev, y_fwd, y_rev
  double* rcp = acc + NP * bs;                    // [bs]
  double* crd = rcp + bs;                         // [NC][bs]
  float* tile = reinterpret_cast<float*>(crd + NC * bs);  // [NP][TILE]
  int* cur = reinterpret_cast<int*>(tile + NP * TILE);    // [bs] cursor into csr_slot
  int* end = cur + bs;                                    // [bs] end of the list
  int* nxt = end + bs;                                    // [bs] csr_slot[cur], or INT_MAX

  const int tid = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * bs;
  if (e0 >= E) return;
  const int ne = (int)min((long long)bs, (long long)E - e0);
  for (int j = tid; j < ne; j += SUM_THREADS) {
    rcp[j] = recip[e0 + j];
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) crd[ch * bs + j] = coords[ch * (long long)E + e0 + j];
#pragma unroll
    for (int q = 0; q < NP; ++q) acc[q * bs + j] = 0.0;
    const int c0 = csr_off[e0 + j], c1 = csr_off[e0 + j + 1];
    cur[j] = c0;
    end[j] = c1;
    nxt[j] = c0 < c1 ? csr_slot[c0] : INT_MAX;
  }

  const int k1 = blk_off[blockIdx.x + 1];
  for (int k = blk_off[blockIdx.x]; k < k1; ++k) {
    const long long t0 = (long long)sched_tile[k] * TILE;
    const long long t1 = t0 + TILE;
    // the tile's loads, all issued before the first is used
    float v[NP * TILE / SUM_THREADS];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int r = 0; r < TILE / SUM_THREADS; ++r)
        v[p * (TILE / SUM_THREADS) + r] = drift[p * L + t0 + tid + r * SUM_THREADS];
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int r = 0; r < TILE / SUM_THREADS; ++r)
        tile[p * TILE + tid + r * SUM_THREADS] = v[p * (TILE / SUM_THREADS) + r];
    __syncthreads();
    if constexpr (NC == 1) {
      for (int j = tid; j < ne; j += SUM_THREADS) {
        int s = nxt[j];
        if (s >= t1) continue;
        int c = cur[j];
        const int e = end[j];
        double a = acc[j];
        do {
          a += (double)tile[s - t0];
          ++c;
          s = c < e ? csr_slot[c] : INT_MAX;
        } while (s < t1);
        acc[j] = a;
        cur[j] = c;
        nxt[j] = s;
      }
    } else {
      for (int n = tid; 2 * n < ne; n += SUM_THREADS) {
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const int j = 2 * n + side, jr = j ^ 1;
          int s = nxt[j];
          if (s >= t1) continue;
          int c = cur[j];
          const int e = end[j];
          double fx = acc[j], rx = acc[bs + jr], fy = acc[2 * bs + j], ry = acc[3 * bs + jr];
          do {
            const int i = (int)(s - t0);
            fx += (double)tile[i];
            rx += (double)tile[TILE + i];
            fy += (double)tile[2 * TILE + i];
            ry += (double)tile[3 * TILE + i];
            ++c;
            s = c < e ? csr_slot[c] : INT_MAX;
          } while (s < t1);
          acc[j] = fx;
          acc[bs + jr] = rx;
          acc[2 * bs + j] = fy;
          acc[3 * bs + jr] = ry;
          cur[j] = c;
          nxt[j] = s;
        }
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < ne; j += SUM_THREADS) {
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      double s;
      if constexpr (NC == 1) s = acc[j];
      else s = acc[(2 * ch) * bs + j] + acc[(2 * ch + 1) * bs + j];
      const double u = s * rcp[j];
      upd[ch * (long long)ecap + e0 + j] = u;
      coords[ch * (long long)E + e0 + j] = crd[ch * bs + j] + u;
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(BCAST_THREADS)
strata_merge_bcast_blocked_kernel(float* __restrict__ drift, float* __restrict__ base,
                                  long long L, const int* __restrict__ ep,
                                  const double* __restrict__ upd, int E, int ecap,
                                  const int* __restrict__ sched_tile,
                                  const int* __restrict__ sched_block, int K, int bs,
                                  long long S) {
  constexpr int NP = drift_planes<NC>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* us = reinterpret_cast<float*>(smem);  // [NC][bs] the block's update, f32
  const int tid = threadIdx.x;
  const int k = blockIdx.x;
  if (k >= K) {  // pad slots: zero their drift
    const long long s0 = S + (long long)(k - K) * TILE;
    const long long s1 = min(s0 + TILE, L);
    for (long long s = s0 + tid; s < s1; s += BCAST_THREADS)
#pragma unroll
      for (int p = 0; p < NP; ++p) drift[p * L + s] = 0.0f;
    return;
  }
  const long long t0 = (long long)sched_tile[k] * TILE;
  const long long t1 = min(t0 + TILE, S);
  int eps[TILE / BCAST_THREADS];  // the tile's endpoints, loaded together
#pragma unroll
  for (int r = 0; r < TILE / BCAST_THREADS; ++r) {
    const long long s = t0 + tid + r * BCAST_THREADS;
    eps[r] = s < t1 ? ep[s] : -1;
  }
  const long long e0 = (long long)sched_block[k] * bs;
  for (int j = tid; j < bs; j += BCAST_THREADS) {
    const long long e = e0 + j;
#pragma unroll
    for (int ch = 0; ch < NC; ++ch)
      us[ch * bs + j] = e < E ? (float)upd[ch * (long long)ecap + e] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < TILE / BCAST_THREADS; ++r) {
    const long long s = t0 + tid + r * BCAST_THREADS;
    const long long loc = (long long)eps[r] - e0;
    if (eps[r] < 0 || loc >= bs || loc < 0) continue;
    const int j = (int)loc;
    if constexpr (NC == 1) {
      base[s] = base[s] + us[j];
      drift[s] = 0.0f;
    } else {
      const int jr = j ^ 1;
      base[s] = base[s] + us[j];
      base[L + s] = base[L + s] + us[jr];
      base[2 * L + s] = base[2 * L + s] + us[bs + j];
      base[3 * L + s] = base[3 * L + s] + us[bs + jr];
      drift[s] = 0.0f;
      drift[L + s] = 0.0f;
      drift[2 * L + s] = 0.0f;
      drift[3 * L + s] = 0.0f;
    }
  }
}

template <int NC>
int launch_sum(const void* drift, long long L, const void* csr_off, const void* csr_slot,
               const void* recip, void* coords, void* upd, int E, int ecap,
               const void* sched_tile, const void* blk_off, int nb, int bs,
               cudaStream_t stream) {
  const size_t smem = sum_smem_bytes<NC>(bs);
  cudaError_t err = cudaFuncSetAttribute(strata_merge_sum_blocked_kernel<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  strata_merge_sum_blocked_kernel<NC><<<nb, SUM_THREADS, smem, stream>>>(
      (const float*)drift, L, (const int*)csr_off, (const int*)csr_slot,
      (const double*)recip, (double*)coords, (double*)upd, E, ecap,
      (const int*)sched_tile, (const int*)blk_off, bs);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_bcast(void* drift, void* base, long long L, const void* ep, const void* upd,
                 int E, int ecap, const void* sched_tile, const void* sched_block, int K,
                 int bs, long long S, cudaStream_t stream) {
  const size_t smem = (size_t)NC * bs * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(strata_merge_bcast_blocked_kernel<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long pad_blocks = (L - S + TILE - 1) / TILE;
  strata_merge_bcast_blocked_kernel<NC><<<(unsigned)(K + pad_blocks), BCAST_THREADS, smem,
                                          stream>>>(
      (float*)drift, (float*)base, L, (const int*)ep, (const double*)upd, E, ecap,
      (const int*)sched_tile, (const int*)sched_block, K, bs, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the sum kernel needs for a block of bs endpoints.
long long strata_merge_sum_blocked_smem(int nc, int bs) {
  return nc == 1 ? (long long)sum_smem_bytes<1>(bs) : (long long)sum_smem_bytes<2>(bs);
}

int strata_merge_sum_blocked(const void* drift, long long L, const void* csr_off,
                             const void* csr_slot, const void* recip, void* coords,
                             void* upd, int E, int ecap, int nc, const void* sched_tile,
                             const void* blk_off, int nb, int bs, void* stream) {
  if (nc == 1)
    return launch_sum<1>(drift, L, csr_off, csr_slot, recip, coords, upd, E, ecap,
                         sched_tile, blk_off, nb, bs, (cudaStream_t)stream);
  if (nc == 2)
    return launch_sum<2>(drift, L, csr_off, csr_slot, recip, coords, upd, E, ecap,
                         sched_tile, blk_off, nb, bs, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

int strata_merge_bcast_blocked(void* drift, void* base, long long L, const void* ep,
                               const void* upd, int E, int ecap, int nc,
                               const void* sched_tile, const void* sched_block, int K,
                               int bs, long long S, void* stream) {
  if (nc == 1)
    return launch_bcast<1>(drift, base, L, ep, upd, E, ecap, sched_tile, sched_block, K,
                           bs, S, (cudaStream_t)stream);
  if (nc == 2)
    return launch_bcast<2>(drift, base, L, ep, upd, E, ecap, sched_tile, sched_block, K,
                           bs, S, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
