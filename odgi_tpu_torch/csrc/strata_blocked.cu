// The blocked consensus sum of the XXL route for Hopper (sm_90a), with a
// plain C interface that ops/kernels.py binds through ctypes.
//
// strata_merge_sum_blocked<NC> replaces the scatter pass (:363-418) of the
// JAX package's big-N kernels (odgi_tpu/ops/pallas_sgd_xxl.py)
// _make_kernel_xxl (NC = 2, :212) and _make_kernel_xxl_1d (NC = 1, :632,
// scatter at :754-782), and gives the same sums, updates and coordinates
// as strata_merge_sum (strata_sgd.cu), bit for bit.  Their broadcast and
// drift-zeroing passes are strata_merge_bcast (strata_sgd.cu), which every
// route runs.
//
// The node blocks are those of the (node block, step tile) schedule
// (ops/strata_xxl.py); nodes are relabeled by first visit.
//
// strata_merge_sum_blocked: node block b (bs endpoints) is split over
// thread blocks of 256 endpoints, a thread an endpoint.  Piece by piece of
// its span of the merge CSR (its endpoints' lists are contiguous there;
// 2D 1,536 entries, 1D 3,072), a thread block gathers the drift of the
// piece's slots into shared memory in CSR order, 16 independent loads in
// flight a thread, then each thread folds its endpoint's part of the piece
// into its f64 sums in ascending slot order, one add after the other, as
// np.bincount and strata_merge_sum do.  No float atomics, no tree
// reduction.  2D: the list of endpoint e feeds e's forward sums (planes 0,
// 2) and e^1's reverse sums (planes 1, 3), which meet their endpoint (the
// neighbouring thread) in shared memory.  It reads the drift by slots, not
// by the schedule's tiles: the function needs each real slot once, and the
// schedule's tiles hold 6.6 reads a tile on the 1M-node graph (1.06 GB a
// 2D merge).  A fold in CSR order reads each slot directly, so walking the
// block's (block, tile) entries adds nothing to it and the kernel does
// not read them; reading whole tiles through a cp.async ring, as the TPU
// kernel does, was 4-5x slower on the card (PERF.md).
//
// The bound (the least time, chip_smoke.py's bound_ms) is by bytes: the
// drift of every real slot, the CSR, 1/R and the coordinates once.
//
// Every entry launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "strata_common.cuh"

namespace {

constexpr int SUB_EPS = 256;  // endpoints (= threads) a thread block, of a node block

template <int NC>
__host__ __device__ constexpr int drift_planes() { return NC == 1 ? 1 : 4; }

// CSR entries a thread block stages at once (2D 24 KB, 1D 12 KB of shared
// memory), about its endpoints' mean span.
template <int NC>
__host__ __device__ constexpr int piece_len() { return NC == 1 ? 3072 : 1536; }

// Node block b is split over nsub thread blocks of sub endpoints.
template <int NC>
__global__ void __launch_bounds__(SUB_EPS)
strata_merge_sum_blocked_kernel(const float* __restrict__ drift, long long L,
                                const int* __restrict__ csr_off,
                                const int* __restrict__ csr_slot,
                                const double* __restrict__ recip, double* __restrict__ coords,
                                double* __restrict__ upd, int E, int ecap, int bs, int sub,
                                int nsub) {
  constexpr int NP = drift_planes<NC>();
  constexpr int PIECE = piece_len<NC>();
  constexpr int R = 16 / NP;  // CSR entries a thread gathers at once
  __shared__ float vals[NP * PIECE];
  __shared__ double xch[NC == 2 ? 2 * SUB_EPS : 1];

  const int b = blockIdx.x / nsub, part = blockIdx.x - b * nsub;
  const long long e0 = (long long)b * bs + (long long)part * sub;
  if (e0 >= E) return;
  const int ne = (int)min((long long)min(sub, bs - part * sub), (long long)E - e0);
  const int T = blockDim.x, tid = threadIdx.x;
  const int k0 = csr_off[e0], k1 = csr_off[e0 + ne];
  // this thread's endpoint e0 + tid: its CSR list [f0, f1), its sums by plane
  const int f0 = tid < ne ? csr_off[e0 + tid] : 0;
  const int f1 = tid < ne ? csr_off[e0 + tid + 1] : 0;
  double acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = 0.0;
  for (int q0 = k0; q0 < k1; q0 += PIECE) {
    const int q1 = min(q0 + PIECE, k1);
    for (int i0 = q0 + tid; i0 < q1; i0 += R * T) {
      int sl[R];
#pragma unroll
      for (int r = 0; r < R; ++r) sl[r] = i0 + r * T < q1 ? csr_slot[i0 + r * T] : -1;
      float v[R][NP];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int p = 0; p < NP; ++p) v[r][p] = sl[r] >= 0 ? drift[p * L + sl[r]] : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (sl[r] < 0) continue;
#pragma unroll
        for (int p = 0; p < NP; ++p) vals[p * PIECE + i0 + r * T - q0] = v[r][p];
      }
    }
    __syncthreads();  // the piece is staged
    const int hi = min(f1, q1);
    for (int c = max(f0, q0); c < hi; ++c)  // ascending order, one add after the other
#pragma unroll
      for (int p = 0; p < NP; ++p) acc[p] += (double)vals[p * PIECE + c - q0];
    __syncthreads();  // the next piece overwrites this one
  }
  if constexpr (NC == 2) {  // the reverse sums run over the neighbour's list
    xch[tid] = acc[1];
    xch[T + tid] = acc[3];
    __syncthreads();
    acc[1] = xch[tid ^ 1];
    acc[3] = xch[T + (tid ^ 1)];
  }
  if (tid >= ne) return;
  const long long e = e0 + tid;
  const double rc = recip[e];
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
    const double s = NC == 1 ? acc[0] : acc[2 * ch] + acc[2 * ch + 1];
    const double u = s * rc;
    upd[ch * (long long)ecap + e] = u;
    coords[ch * (long long)E + e] = coords[ch * (long long)E + e] + u;
  }
}

template <int NC>
int launch_sum(const void* drift, long long L, const void* csr_off, const void* csr_slot,
               const void* recip, void* coords, void* upd, int E, int ecap, int nb, int bs,
               cudaStream_t stream) {
  const int sub = std::min(bs, SUB_EPS), nsub = (bs + sub - 1) / sub;
  strata_merge_sum_blocked_kernel<NC><<<(unsigned)((long long)nb * nsub), sub, 0, stream>>>(
      (const float*)drift, L, (const int*)csr_off, (const int*)csr_slot, (const double*)recip,
      (double*)coords, (double*)upd, E, ecap, bs, sub, nsub);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// nb node blocks of bs endpoints (even), which cover the E endpoints.
int strata_merge_sum_blocked(const void* drift, long long L, const void* csr_off,
                             const void* csr_slot, const void* recip, void* coords,
                             void* upd, int E, int ecap, int nc, int nb, int bs,
                             void* stream) {
  if (bs < 2 || bs % 2 != 0 || nb < 1 || (long long)nb * bs < E)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (nc == 1)
    return launch_sum<1>(drift, L, csr_off, csr_slot, recip, coords, upd, E, ecap, nb, bs, st);
  if (nc == 2)
    return launch_sum<2>(drift, L, csr_off, csr_slot, recip, coords, upd, E, ecap, nb, bs, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
