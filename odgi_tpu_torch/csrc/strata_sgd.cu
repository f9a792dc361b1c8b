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

using strata::LANE;

constexpr int CHUNK_THREADS = 1024;  // one block walks a merge group
constexpr int BCAST_THREADS = 256;
constexpr int BCAST_BLOCKS_PER_SM = 16;
constexpr int SUM_THREADS = 256;
constexpr int SUM_TILE = 4096;  // CSR entries a block stages at once
constexpr int SUM_PER = SUM_TILE / SUM_THREADS;
constexpr int SUM_CHAINS = 4;  // chains a thread at most: 2D, 256 endpoints a block

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
// chunk's (o, D) is fetched while the current one runs.  The main path runs
// strata_chunks_2d_levels (strata_levels.cu) instead, which spreads the
// same chunks over every SM by conflict levels; this kernel stays as the
// chain it is held against.
//
// Semantics: strata::chunk_2d (strata_common.cuh), chunk after chunk.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(CHUNK_THREADS, 1)
strata_chunks_2d_kernel(float* drift, const float* __restrict__ base,
                        const int* __restrict__ planes, long long L,
                        const int* __restrict__ od, const float* __restrict__ eta,
                        int cpi, int g0, int cgs) {
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
    strata::chunk_2d<CHUNK_THREADS>(drift, base, planes, L, o, D, eta[gl / cpi], gl);
    __syncthreads();  // the next chunk reads what this one wrote
  }
}

// ---------------------------------------------------------------------------
// strata_chunks_1d: the chunk phase of _make_kernel_1d (twin: _twin_chunks_1d).
// Bound and design as for 2D; the main path runs strata_chunks_1d_levels
// (strata_levels.cu) instead, and this chain stays as its reference.
//
// Semantics: strata::chunk_1d (strata_common.cuh), chunk after chunk.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(CHUNK_THREADS, 1)
strata_chunks_1d_kernel(float* drift, const float* __restrict__ base,
                        const int* __restrict__ planes, long long L,
                        const int* __restrict__ od, const float* __restrict__ eta,
                        int cpi, int g0, int cgs) {
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
    strata::chunk_1d<CHUNK_THREADS>(drift, base, planes, L, o, D, eta[gl / cpi]);
    __syncthreads();  // the next chunk reads what this one wrote
  }
}

// ---------------------------------------------------------------------------
// strata_merge_sum<NC>: the sum half of _merge_tiles_2d (NC = 2,
// odgi_tpu/ops/pallas_sgd.py:922) and _merge_tiles_1d (NC = 1, :1029).
//
// Per endpoint e, an f64 sum in ascending slot order (the order of the
// twin's np.bincount) of the drift of the slots listed for e in a host-built
// CSR.  2D: channel c sums plane 2c over the slots whose forward endpoint is
// e, then plane 2c+1 over the slots whose forward endpoint is e^1 (their
// complement endpoint is e), and adds the two sums, as the twin's
// bincount(epf, dv[2c]) + bincount(epr, dv[2c+1]).  upd = acc * (1/R) is
// stored for the broadcast and added into the f64 node coordinates.
//
// Bound on this card: the random gathers and the ordered folds.  The bytes
// bound is 0.004-0.030 ms a launch on the main path's graphs (each slot's
// drift, the CSR and the node arrays once); every element is a
// csr_slot[k] -> drift[...] dependent pair, and each sum is one chain of
// dependent f64 adds as long as its list (75-500 on the smoke and XL
// graphs).  A thread an endpoint walking its list one gather after the
// other left 10,000-20,000 threads waiting on memory.  What the design does
// about it: a thread block owns B consecutive endpoints (B a power of two
// up to 256, chosen on the host from the mean list length,
// MergeIndex.block_eps, so that their lists fill at most one tile).  Their lists are contiguous in the
// CSR, so the block loads the CSR span with coalesced loads, issues every
// gather of a tile at once (16 a thread, independent), and stages the
// drift of every plane in shared memory in CSR order.  Then one thread a
// (endpoint, plane) chain folds its slice of the tile in ascending order
// into its f64 sum: 2D runs four chains an endpoint (planes 0 and 2 over
// the endpoint's own list, 1 and 3 over the list of e^1, inside the block
// since B is even), spread over the threads (up to four a thread when B is
// 256), and the sums meet in shared memory as (fwd + rev) * (1/R).  A list longer than a tile continues in the next
// tile on the same thread.  No tree reduction and no atomics: the sums are
// bit-equal to np.bincount's.
// ---------------------------------------------------------------------------
template <int NC>
__host__ __device__ constexpr int sum_planes() { return NC == 1 ? 1 : 4; }

template <int NC>
size_t sum_smem_bytes(int block_eps) {
  return (size_t)sum_planes<NC>() * SUM_TILE * sizeof(float) +
         (NC == 2 ? (size_t)4 * block_eps * sizeof(double) : 0);
}

template <int NC>
__global__ void __launch_bounds__(SUM_THREADS)
strata_merge_sum_kernel(const float* __restrict__ drift, long long L,
                        const int* __restrict__ csr_off, const int* __restrict__ csr_slot,
                        const double* __restrict__ recip, double* __restrict__ coords,
                        double* __restrict__ upd, int E, int ecap, int B) {
  constexpr int NP = sum_planes<NC>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);                   // [NP][SUM_TILE]
  double* part = reinterpret_cast<double*>(tile + NP * SUM_TILE);  // 2D: [4][B]
  const long long e0 = (long long)blockIdx.x * B;
  const int ne = (int)min((long long)B, (long long)E - e0);
  const int k0 = csr_off[e0], k1 = csr_off[e0 + ne];
  const int tid = threadIdx.x;
  // chain c = tid + r * SUM_THREADS: plane c / B of endpoint e0 + c % B; 2D
  // planes 1 and 3 run over the list of (e0 + c % B) ^ 1
  int f0[SUM_CHAINS], f1[SUM_CHAINS];
  double acc[SUM_CHAINS];
#pragma unroll
  for (int r = 0; r < SUM_CHAINS; ++r) {
    const int c = tid + r * SUM_THREADS, q = c / B, i = c - q * B;
    f0[r] = f1[r] = 0;
    acc[r] = 0.0;
    if (q < NP && i < ne) {
      const long long owner = (NC == 2 && (q & 1)) ? ((e0 + i) ^ 1) : e0 + i;
      f0[r] = csr_off[owner];
      f1[r] = csr_off[owner + 1];
    }
  }
  for (int t0 = k0; t0 < k1; t0 += SUM_TILE) {
    const int t1 = min(t0 + SUM_TILE, k1);
    int sl[SUM_PER];  // the tile's slots, coalesced
#pragma unroll
    for (int r = 0; r < SUM_PER; ++r) {
      const int k = t0 + tid + r * SUM_THREADS;
      sl[r] = k < t1 ? csr_slot[k] : -1;
    }
    float v[NP][SUM_PER];  // every gather of the tile in flight at once
#pragma unroll
    for (int r = 0; r < SUM_PER; ++r)
#pragma unroll
      for (int p = 0; p < NP; ++p) v[p][r] = sl[r] >= 0 ? drift[p * L + sl[r]] : 0.0f;
    __syncthreads();  // the previous tile is folded
#pragma unroll
    for (int r = 0; r < SUM_PER; ++r)
#pragma unroll
      for (int p = 0; p < NP; ++p) tile[p * SUM_TILE + tid + r * SUM_THREADS] = v[p][r];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < SUM_CHAINS; ++r) {  // ascending order, one add after the other
      const float* x = tile + ((tid + r * SUM_THREADS) / B) * SUM_TILE;
      const int hi = min(f1[r], t1) - t0;
      for (int s = max(f0[r], t0) - t0; s < hi; ++s) acc[r] += (double)x[s];
    }
  }
  if (NC == 1) {  // B <= SUM_THREADS: one chain a thread
    if (tid >= ne) return;
    const long long e = e0 + tid;
    const double u = acc[0] * recip[e];
    upd[e] = u;
    coords[e] = coords[e] + u;
  } else {
#pragma unroll
    for (int r = 0; r < SUM_CHAINS; ++r) {
      const int c = tid + r * SUM_THREADS;
      if (c < NP * B && c % B < ne) part[c] = acc[r];
    }
    __syncthreads();
    if (tid >= ne) return;
    const long long e = e0 + tid;
    const double rc = recip[e];
    const double ux = (part[tid] + part[B + tid]) * rc;          // x: fwd + rev
    const double uy = (part[2 * B + tid] + part[3 * B + tid]) * rc;  // y: fwd + rev
    upd[e] = ux;
    upd[ecap + e] = uy;
    coords[e] = coords[e] + ux;
    coords[E + e] = coords[E + e] + uy;
  }
}

// ---------------------------------------------------------------------------
// strata_merge_bcast<NC>: the broadcast half of _merge_tiles_2d/_1d, and the
// broadcast and drift-zeroing passes of the XXL kernels
// (odgi_tpu/ops/pallas_sgd_xxl.py _make_kernel_xxl :422-457,
// _make_kernel_xxl_1d :784-804), on every route.  Per slot s:
// base[p][s] = base[p][s] + (float)upd[endpoint of replica p of s] and
// drift[p][s] = 0.  Pad slots hold the dummy endpoint (1D E, 2D E and E+1),
// whose update no sum writes, so their base keeps its value.
//
// Bound on this card: bytes.  Per slot, the endpoint, each base plane read
// and written and each drift plane written stream past once (2D 52 B, 1D
// 16 B); the update table (2D 2 x (E+2) f64, 32 MB on the 1M-node graph)
// is gathered, and neighbouring slots gather neighbouring endpoints once
// the nodes are relabeled by first visit.  What the design does about it,
// instead of the TPU's per-tile one-hot products:
// - one pass over the slots: a thread takes 4 consecutive slots, with one
//   16-byte load of their endpoints and, per plane, one 16-byte load and
//   store of base and one 16-byte store of zeros to drift (L is a multiple
//   of 4096, the planes are (planes, L) row-major);
// - 2D: the forward and reverse update of endpoint e are upd[ch][e] and
//   upd[ch][e ^ 1], one aligned 16-byte pair at e & ~1 (ecap is even, so
//   row 1 starts aligned): two gathers a slot;
// - the streaming accesses are marked evict-first (__ldcs / __stcs) and the
//   table is read through the read-only path (__ldg);
// - a grid-stride loop over BCAST_BLOCKS_PER_SM blocks of 256 an SM, more
//   than an SM holds at once (2D 6, 1D 8).
// No shared memory, no schedule.  The same adds as merge_bcast_plain, bit
// for bit.  tools/bcast_variants.py times the alternatives (PERF.md): on
// the 1M-node merges the streaming part alone runs at about 95% of the
// bound in 2D, and the 2D gathers add 0.07-0.1 ms, about the time of
// reading the 32 MB table from HBM once a path; an L2 access-policy window
// on the table, an evict-last hint on it, no hints, one-shot grids and
// grids of 6 or 8 blocks an SM were slower or no faster.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float4 add4(float4 b, const float (&u)[4]) {
  return make_float4(b.x + u[0], b.y + u[1], b.z + u[2], b.w + u[3]);
}

template <int NC>
__global__ void __launch_bounds__(BCAST_THREADS)
strata_merge_bcast_kernel(float* __restrict__ drift, float* __restrict__ base, long long L,
                          const int* __restrict__ ep, const double* __restrict__ upd,
                          int ecap) {
  const long long n4 = L >> 2;  // 4-slot groups a plane
  const int4* ep4 = reinterpret_cast<const int4*>(ep);
  float4* b4 = reinterpret_cast<float4*>(base);
  float4* d4 = reinterpret_cast<float4*>(drift);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long q = (long long)blockIdx.x * BCAST_THREADS + threadIdx.x; q < n4;
       q += (long long)gridDim.x * BCAST_THREADS) {
    const int4 e4 = __ldcs(ep4 + q);
    const int e[4] = {e4.x, e4.y, e4.z, e4.w};
    if constexpr (NC == 1) {
      float u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = (float)__ldg(upd + e[i]);
      __stcs(b4 + q, add4(__ldcs(b4 + q), u));
      __stcs(d4 + q, zero);
    } else {
      const double2* ux = reinterpret_cast<const double2*>(upd);
      const double2* uy = reinterpret_cast<const double2*>(upd + ecap);
      float u[4][4];  // [plane][slot]: x fwd, x rev, y fwd, y rev
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double2 x = __ldg(ux + (e[i] >> 1)), y = __ldg(uy + (e[i] >> 1));
        const bool odd = e[i] & 1;  // e = (e & ~1) + odd: fwd at .x when even
        u[0][i] = (float)(odd ? x.y : x.x);
        u[1][i] = (float)(odd ? x.x : x.y);
        u[2][i] = (float)(odd ? y.y : y.x);
        u[3][i] = (float)(odd ? y.x : y.y);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        __stcs(b4 + p * n4 + q, add4(__ldcs(b4 + p * n4 + q), u[p]));
        __stcs(d4 + p * n4 + q, zero);
      }
    }
  }
}

template <int NC>
int launch_sum(const void* drift, long long L, const void* csr_off, const void* csr_slot,
               const void* recip, void* coords, void* upd, int E, int ecap, int block_eps,
               cudaStream_t stream) {
  const size_t smem = sum_smem_bytes<NC>(block_eps);
  const cudaError_t err = cudaFuncSetAttribute(
      strata_merge_sum_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)E + block_eps - 1) / block_eps;
  strata_merge_sum_kernel<NC><<<(unsigned)blocks, SUM_THREADS, smem, stream>>>(
      (const float*)drift, L, (const int*)csr_off, (const int*)csr_slot, (const double*)recip,
      (double*)coords, (double*)upd, E, ecap, block_eps);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_bcast(void* drift, void* base, long long L, const void* ep, const void* upd,
                 int ecap, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long groups = (L / 4 + BCAST_THREADS - 1) / BCAST_THREADS;
  const long long grid = (long long)sms * BCAST_BLOCKS_PER_SM;
  const unsigned blocks = (unsigned)(groups < grid ? groups : grid);
  if (blocks == 0) return (int)cudaSuccess;
  strata_merge_bcast_kernel<NC><<<blocks, BCAST_THREADS, 0, stream>>>(
      (float*)drift, (float*)base, L, (const int*)ep, (const double*)upd, ecap);
  return (int)cudaGetLastError();
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

// block_eps: endpoints a thread block sums, a power of two in [1, 256]
// (2D: even).
int strata_merge_sum(const void* drift, long long L, const void* csr_off,
                     const void* csr_slot, const void* recip, void* coords, void* upd,
                     int E, int ecap, int nc, int block_eps, void* stream) {
  const int B = block_eps;
  if (B < 1 || B > SUM_THREADS || (B & (B - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (nc == 1)
    return launch_sum<1>(drift, L, csr_off, csr_slot, recip, coords, upd, E, ecap, B,
                         (cudaStream_t)stream);
  if (nc == 2 && B >= 2)
    return launch_sum<2>(drift, L, csr_off, csr_slot, recip, coords, upd, E, ecap, B,
                         (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// L a multiple of 4; every pointer 16-byte aligned; 2D: ecap even.
int strata_merge_bcast(void* drift, void* base, long long L, const void* ep,
                       const void* upd, int ecap, int nc, void* stream) {
  const uintptr_t ptrs = (uintptr_t)drift | (uintptr_t)base | (uintptr_t)ep | (uintptr_t)upd;
  if (L % 4 != 0 || (ptrs & 15) != 0 || (nc == 2 && ecap % 2 != 0))
    return (int)cudaErrorInvalidValue;
  if (nc == 1)
    return launch_bcast<1>(drift, base, L, ep, upd, ecap, (cudaStream_t)stream);
  if (nc == 2)
    return launch_bcast<2>(drift, base, L, ep, upd, ecap, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
