// The step-table indexes of a strata run in C++, each a counting pass in
// place of a comparison sort: the first-visit order of ops/strata_xxl.py's
// locality_order, the merge CSR of ops/strata_sgd.py's merge_csr and the
// (block, tile) entries of ops/strata_xxl.py's schedule_entries.  Each key is
// a bounded integer (a node, an endpoint, a block), so a count and a scan
// place every entry; the outputs equal the numpy forms (np.unique,
// np.argsort(kind="stable")) array for array, and those forms stand in
// where g++ is missing.
//
// Steps are packed handles 2 * node + orient.  An endpoint is the node (1D)
// or the handle (2D).  Every function returns -1, having written nothing
// that counts, when a step's node is not below the node count.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 (odgi_tpu_torch/native builds it
// at first use into odgi_tpu_torch/_build/).

#include <cstdint>
#include <memory>
#include <vector>

namespace {

constexpr int64_t TILE = 4096;    // slots a merge tile (TR * LANE)
constexpr int64_t BUCKET = 1024;  // endpoints a bucket of the merge CSR's first pass

bool nodes_below(int64_t S, const int64_t* handle, int64_t N) {
  for (int64_t s = 0; s < S; ++s)
    if (handle[s] < 0 || (handle[s] >> 1) >= N) return false;
  return true;
}

}  // namespace

extern "C" {

// order (N): the nodes in order of first visit along the step table, then
// the nodes no step visits, ascending.  Returns N.
int64_t odgi_first_visit(int64_t S, const int64_t* handle, int64_t N, int64_t* order) {
  if (!nodes_below(S, handle, N)) return -1;
  std::vector<uint8_t> seen(N, 0);
  int64_t k = 0;
  for (int64_t s = 0; s < S; ++s) {
    const int64_t n = handle[s] >> 1;
    if (!seen[n]) {
      seen[n] = 1;
      order[k++] = n;
    }
  }
  for (int64_t n = 0; n < N; ++n)
    if (!seen[n]) order[k++] = n;
  return k;
}

// The merge CSR of L slots over E endpoints (E = N in 1D, 2N in 2D):
// ep (L) each real slot's endpoint and E on the pad slots past S; off (E+1)
// the exclusive scan of the endpoints' step counts; slot (S) each
// endpoint's slots in ascending order (a stable counting sort).  Returns 0.
//
// The slots are placed in two stable passes: first into buckets of BUCKET
// endpoints, then each bucket's into its endpoints' lists.  Placed in one
// pass, every step of a path writes to another endpoint's list, and the
// lists' open cache lines (one an endpoint: 32 MB at 500,000 endpoints)
// outgrow the host's cache; a bucket's stay within it.  (22.5M steps over
// 500,000 endpoints on an H100 machine's host: one pass 1.11 s, two passes
// 0.38 s with buckets of 1,024 endpoints, 0.41-0.65 s with 4,096-65,536.)
int64_t odgi_merge_csr(int64_t S, const int64_t* handle, int64_t N, int64_t one_d, int64_t L,
                       int32_t* ep, int32_t* off, int32_t* slot) {
  if (!nodes_below(S, handle, N)) return -1;
  const int64_t E = one_d ? N : 2 * N;
  const int shift = one_d ? 1 : 0;
  std::vector<int32_t> next(E + 1, 0);
  for (int64_t s = 0; s < S; ++s) {
    const int32_t e = (int32_t)(handle[s] >> shift);
    ep[s] = e;
    ++next[e + 1];
  }
  for (int64_t s = S; s < L; ++s) ep[s] = (int32_t)E;
  for (int64_t e = 0; e < E; ++e) next[e + 1] += next[e];
  for (int64_t e = 0; e <= E; ++e) off[e] = next[e];
  std::vector<int64_t> bucket((E + BUCKET - 1) / BUCKET);
  for (int64_t b = 0; b < (int64_t)bucket.size(); ++b) bucket[b] = next[b * BUCKET];
  std::unique_ptr<uint64_t[]> by_bucket(new uint64_t[S]);  // endpoint << 32 | slot
  for (int64_t s = 0; s < S; ++s)
    by_bucket[bucket[ep[s] / BUCKET]++] = (uint64_t)ep[s] << 32 | (uint64_t)s;
  for (int64_t i = 0; i < S; ++i) slot[next[by_bucket[i] >> 32]++] = (int32_t)by_bucket[i];
  return 0;
}

// The distinct (block, tile) pairs of the steps, block = endpoint / bs (of
// nb blocks), tile = s / TILE, sorted by (block, tile): tile and block
// written while fewer than cap are; returns how many there are (call again
// with larger arrays when that exceeds cap).  A stamp per block (the last
// tile that marked it) keeps one entry a pair while the tiles go by in
// order; a count per block then places the entries block by block, each
// block's in tile order.
int64_t odgi_block_schedule(int64_t S, const int64_t* handle, int64_t N, int64_t one_d, int64_t bs,
                            int64_t nb, int32_t* tile, int32_t* block, int64_t cap) {
  if (!nodes_below(S, handle, N)) return -1;
  const int shift = one_d ? 1 : 0;
  std::vector<int64_t> stamp(nb, -1);
  std::vector<int64_t> next(nb + 1, 0);
  std::vector<int32_t> pb, pt;  // the pairs in (tile, first step) order
  for (int64_t s = 0; s < S; ++s) {
    const int64_t b = (handle[s] >> shift) / bs, t = s / TILE;
    if (b >= nb) return -1;
    if (stamp[b] != t) {
      stamp[b] = t;
      ++next[b + 1];
      pb.push_back((int32_t)b);
      pt.push_back((int32_t)t);
    }
  }
  const int64_t K = (int64_t)pb.size();
  if (K > cap) return K;
  for (int64_t b = 0; b < nb; ++b) next[b + 1] += next[b];
  for (int64_t i = 0; i < K; ++i) {
    const int64_t j = next[pb[i]]++;
    tile[j] = pt[i];
    block[j] = pb[i];
  }
  return K;
}

}  // extern "C"
