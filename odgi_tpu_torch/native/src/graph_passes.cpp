// The host graph passes of `odgi sort`'s g and s steps in C++: the groom
// walk of algorithms/groom.py and the modified Kahn order of
// algorithms/topological.py.  Both walk core/graph.py's SideAdjacency: a
// CSR over packed handles (2 * node + orient), off (2N+1) and tgt (E), each
// handle's targets ascending, an edge a -> b listed as the entry a -> b and
// its mirror flip(b) -> flip(a) (one entry when the two are the same, a
// self-inverse edge).  The outputs equal the Python loops' array for array,
// and those loops stand in where g++ is missing.
//
// Every function returns -1, having written nothing that counts, when the
// CSR is malformed or a handle or node is out of range; it never reads out
// of bounds.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 (odgi_tpu_torch/native builds it
// at first use into odgi_tpu_torch/_build/).

#include <algorithm>
#include <cstdint>
#include <functional>
#include <queue>
#include <vector>

namespace {

// off[0] == 0, off nondecreasing up to off[n2] == E, every target below n2.
bool csr_ok(int64_t n2, const int64_t* off, int64_t E, const int64_t* tgt) {
  if (n2 < 0 || n2 % 2 || E < 0 || off[0] != 0 || off[n2] != E) return false;
  for (int64_t h = 0; h < n2; ++h)
    if (off[h + 1] < off[h]) return false;
  for (int64_t j = 0; j < E; ++j)
    if (tgt[j] < 0 || tgt[j] >= n2) return false;
  return true;
}

using MinHeap = std::priority_queue<int64_t, std::vector<int64_t>, std::greater<int64_t>>;

}  // namespace

extern "C" {

// The groom walk.  The stack starts with the seeds (handles) reversed, so
// the first is on top; a popped handle's node, if unvisited, is visited,
// flipped as the handle is reverse (or, for a node with is_ref set, as
// needs_flip says; both null, or neither), and its unvisited targets are
// pushed in CSR order.  When the stack runs dry the walk restarts from the
// forward handle of the lowest unvisited node.  flipped (N) gets 0 / 1;
// returns the restarts.
int64_t odgi_groom(int64_t n2, const int64_t* off, int64_t E, const int64_t* tgt,
                   int64_t n_seeds, const int64_t* seeds, const uint8_t* is_ref,
                   const uint8_t* needs_flip, uint8_t* flipped) {
  if (!csr_ok(n2, off, E, tgt) || n_seeds < 0) return -1;
  for (int64_t i = 0; i < n_seeds; ++i)
    if (seeds[i] < 0 || seeds[i] >= n2) return -1;
  const int64_t N = n2 / 2;
  std::vector<uint8_t> unvisited(N, 1);
  std::vector<int64_t> stack(seeds, seeds + n_seeds);
  std::reverse(stack.begin(), stack.end());
  int64_t restarts = 0, lowest = 0;
  while (true) {
    while (!stack.empty()) {
      const int64_t h = stack.back();
      stack.pop_back();
      const int64_t r = h >> 1;
      if (!unvisited[r]) continue;
      unvisited[r] = 0;
      flipped[r] = (is_ref && is_ref[r]) ? (needs_flip[r] != 0) : (uint8_t)(h & 1);
      for (int64_t j = off[h]; j < off[h + 1]; ++j)
        if (unvisited[tgt[j] >> 1]) stack.push_back(tgt[j]);
    }
    while (lowest < N && !unvisited[lowest]) ++lowest;
    if (lowest == N) break;
    stack.push_back(lowest << 1);
    ++restarts;
  }
  return restarts;
}

// The topological order: ready nodes (the start ranks at first) are emitted
// lowest rank first; emitting node i masks the edges into its forward
// handle's left side from visited nodes, then follows each unmasked edge out
// of its right side, masking it: a target node left with no unmasked
// incoming edge becomes ready, else it joins the seed set.  With nothing
// ready the lowest unvisited seed is taken (counts[0] += 1), else the lowest
// unvisited node (counts[1] += 1).  An edge's two entries are masked
// together, so either reads its state.  order (N) gets the ranks; returns N.
int64_t odgi_topological_order(int64_t n2, const int64_t* off, int64_t E, const int64_t* tgt,
                               int64_t n_start, const int64_t* start, int64_t* order,
                               int64_t* counts) {
  if (!csr_ok(n2, off, E, tgt) || n_start < 0) return -1;
  const int64_t N = n2 / 2;
  for (int64_t i = 0; i < n_start; ++i)
    if (start[i] < 0 || start[i] >= N) return -1;
  // mirror[j]: the entry flip(b) -> flip(a) of entry j, a -> b
  std::vector<int64_t> mirror(E);
  for (int64_t a = 0; a < n2; ++a)
    for (int64_t j = off[a]; j < off[a + 1]; ++j) {
      const int64_t fb = tgt[j] ^ 1;
      const int64_t* lo = tgt + off[fb];
      const int64_t* hi = tgt + off[fb + 1];
      const int64_t* at = std::lower_bound(lo, hi, a ^ 1);
      if (at == hi || *at != (a ^ 1)) return -1;
      mirror[j] = at - tgt;
    }
  std::vector<uint8_t> masked(E, 0), seeded_set(N, 0), unvisited(N, 1);
  MinHeap s, seeds;
  for (int64_t i = 0; i < n_start; ++i)
    if (unvisited[start[i]]) {
      unvisited[start[i]] = 0;
      s.push(start[i]);
    }
  int64_t n_unvisited = N - (int64_t)s.size();
  int64_t k = 0, seeded = 0, restarts = 0, lowest = 0;
  auto mask = [&](int64_t j) { masked[j] = masked[mirror[j]] = 1; };
  auto make_ready = [&](int64_t r) {
    unvisited[r] = 0;
    --n_unvisited;
    s.push(r);
  };
  while (n_unvisited > 0 || !s.empty()) {
    while (s.empty() && !seeds.empty()) {
      const int64_t r = seeds.top();
      seeds.pop();
      seeded_set[r] = 0;
      if (unvisited[r]) {
        make_ready(r);
        ++seeded;
      }
    }
    if (s.empty()) {
      while (!unvisited[lowest]) ++lowest;
      make_ready(lowest);
      ++restarts;
    }
    while (!s.empty()) {
      const int64_t i = s.top();
      s.pop();
      order[k++] = i;
      const int64_t h = i << 1;
      // the left side of h is the right side of flip(h): entry flip(h) -> b
      // mirrors the edge flip(b) -> h
      for (int64_t j = off[h ^ 1]; j < off[(h ^ 1) + 1]; ++j)
        if (!unvisited[tgt[j] >> 1]) mask(j);
      for (int64_t j = off[h]; j < off[h + 1]; ++j) {
        if (masked[j]) continue;
        mask(j);
        const int64_t nxt = tgt[j], nr = nxt >> 1;
        if (!unvisited[nr]) continue;
        bool unmasked_incoming = false;
        for (int64_t q = off[nxt ^ 1]; q < off[(nxt ^ 1) + 1]; ++q)
          if (!masked[q]) {
            unmasked_incoming = true;
            break;
          }
        if (!unmasked_incoming) {
          make_ready(nr);
        } else if (!seeded_set[nr]) {
          seeded_set[nr] = 1;
          seeds.push(nr);
        }
      }
    }
  }
  counts[0] = seeded;
  counts[1] = restarts;
  return k;
}

}  // extern "C"
