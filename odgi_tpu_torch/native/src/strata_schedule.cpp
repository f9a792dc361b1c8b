// The chunk schedule of the strata PG-SGD plans in C++: the conflict levels
// and the predecessor lists of ops/strata_levels.py's chunk_schedule, one
// pass over each merge group's chunks in order, with the same rules and the
// same output (chunk_schedule_numpy is its reference and stands in where
// g++ is missing).
//
// A chunk's footprint is the 128-slot blocks of its A window (o .. o + 31)
// and of its B window (o + D / 128 .. o + (D + 4095) / 128, visited as 33
// entries min(b0 + k, b1)).  Walking a group's chunks in order with the last
// chunk of each block: a chunk's level is 1 + the highest level of the last
// chunks on its footprint (0 where a block has none), and its predecessors
// are those last chunks, one entry for each run of equal entries within a
// window (a chunk can appear once a window).
//
// Build: g++ -O3 -fPIC -shared -std=c++17 (odgi_tpu_torch/native builds it
// at first use into odgi_tpu_torch/_build/).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr int64_t LANE = 128;
constexpr int64_t CHUNK = 4096;
constexpr int64_t RC = 32;  // A-window blocks

}  // namespace

extern "C" {

// groups x cgs chunks, o_blk / d_arr by global index g * cgs + c.  Writes
// lvl (chunks) and counts (chunks: predecessors a chunk), and the
// predecessors (global indices, chunk by chunk) into pred while fewer than
// cap are written; returns how many there are (call again with a larger
// pred when that exceeds cap).
int64_t odgi_strata_schedule(int64_t groups, int64_t cgs, const int32_t* o_blk,
                             const int32_t* d_arr, int32_t* lvl, int32_t* counts, int32_t* pred,
                             int64_t cap) {
  const int64_t chunks = groups * cgs;
  int64_t n_blocks = 0;
  for (int64_t j = 0; j < chunks; ++j)
    n_blocks = std::max(n_blocks, (int64_t)o_blk[j] + ((int64_t)d_arr[j] + CHUNK - 1) / LANE + 1);
  std::vector<int32_t> last(n_blocks);
  std::vector<int64_t> fp(2 * RC + 1);
  int64_t total = 0;
  for (int64_t g = 0; g < groups; ++g) {
    std::fill(last.begin(), last.end(), -1);
    const int64_t j0 = g * cgs;
    for (int64_t c = 0; c < cgs; ++c) {
      const int64_t o = o_blk[j0 + c], d = d_arr[j0 + c];
      const int64_t b0 = o + d / LANE, b1 = o + (d + CHUNK - 1) / LANE;
      for (int64_t k = 0; k < RC; ++k) fp[k] = o + k;
      for (int64_t k = 0; k <= RC; ++k) fp[RC + k] = std::min(b0 + k, b1);
      int32_t level = 0, n = 0;
      for (int64_t k = 0; k < 2 * RC + 1; ++k) {
        const int32_t q = last[fp[k]];
        if (q < 0) continue;
        level = std::max(level, lvl[j0 + q]);
        if (k == 0 || k == RC || q != last[fp[k - 1]]) {
          if (total < cap) pred[total] = (int32_t)(j0 + q);
          ++total;
          ++n;
        }
      }
      lvl[j0 + c] = level + 1;
      counts[j0 + c] = n;
      for (int64_t k = 0; k < 2 * RC + 1; ++k) last[fp[k]] = (int32_t)c;
    }
  }
  return total;
}

}  // extern "C"
