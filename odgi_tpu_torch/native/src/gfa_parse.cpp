// Native GFAv1/W-line parser for the GraphTensors of odgi_tpu_torch (a copy of
// odgi_tpu/native/src/gfa_parse.cpp, built at first use by native/__init__.py).
//
// Plays the role of the reference's C++ ingest (reference:
// src/gfa_to_handle.cpp:5-120, two-pass mmap'd gfakluge parse) for our
// flat-tensor graph model: one mmap pass classifies and parses S/L/P/W
// lines directly into malloc'd flat arrays (ids, sequence blob, canonical
// deduplicated edge handle pairs, CSR step tensor with per-path nucleotide
// prefix positions).  Semantics mirror io/gfa.py exactly (integer segment
// names pass through as ids; non-integer names get dense synthetic ids
// above the max in S-line order; nodes are ranked in id order).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this
// toolchain).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

struct GfaResult {
  int64_t num_nodes, num_edges, num_paths, num_steps, seq_total, names_total;
  int64_t* node_id;      // [N]
  int64_t* node_len;     // [N]
  int64_t* seq_offset;   // [N+1]
  uint8_t* seq;          // [seq_total]
  int64_t* edge_from;    // [E] packed handles (rank<<1|rev)
  int64_t* edge_to;      // [E]
  int64_t* path_offset;  // [P+1]
  int64_t* step_handle;  // [S]
  int64_t* step_pos;     // [S]
  uint8_t* path_names;   // concatenated utf-8 names
  int64_t* path_name_offset;  // [P+1]
  char* error;  // non-null on failure (malloc'd message)
};

static char* err_dup(const std::string& m) {
  char* e = (char*)malloc(m.size() + 1);
  memcpy(e, m.c_str(), m.size() + 1);
  return e;
}

struct SV {
  const char* p;
  size_t n;
  bool operator==(const SV& o) const {
    return n == o.n && memcmp(p, o.p, n) == 0;
  }
};
struct SVHash {
  size_t operator()(const SV& s) const {
    // FNV-1a
    size_t h = 1469598103934665603ull;
    for (size_t i = 0; i < s.n; ++i) {
      h ^= (unsigned char)s.p[i];
      h *= 1099511628211ull;
    }
    return h;
  }
};

static bool parse_int(const char* p, size_t n, int64_t* out) {
  if (n == 0) return false;
  size_t i = 0;
  bool neg = false;
  if (p[0] == '+' || p[0] == '-') {
    neg = p[0] == '-';
    if (n == 1) return false;
    i = 1;
  }
  int64_t v = 0;
  for (; i < n; ++i) {
    if (p[i] < '0' || p[i] > '9') return false;
    v = v * 10 + (p[i] - '0');
  }
  *out = neg ? -v : v;
  return true;
}

GfaResult* odgi_gfa_parse(const char* path) {
  GfaResult* r = (GfaResult*)calloc(1, sizeof(GfaResult));
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    r->error = err_dup(std::string("cannot open ") + path);
    return r;
  }
  struct stat st;
  fstat(fd, &st);
  size_t len = st.st_size;
  const char* data =
      len ? (const char*)mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0)
          : nullptr;
  close(fd);
  if (len && data == MAP_FAILED) {
    r->error = err_dup("mmap failed");
    return r;
  }

  struct Seg {
    SV name;
    SV seq;
    int64_t id;  // parsed integer name or -1
  };
  std::vector<Seg> segs;
  struct Edge {
    SV a, b;
    bool ra, rb;
  };
  std::vector<Edge> ls;
  struct Path {
    SV name;
    SV body;
    bool walk;  // W-line walk syntax
  };
  std::vector<Path> ps;
  std::vector<std::string> wnames;  // owned storage for W-line path names

  // ---- single pass: classify + split lines ----
  const char* p = data;
  const char* end = data + len;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    const char* eol = nl ? nl : end;
    size_t ll = eol - p;
    if (ll > 2 && p[1] == '\t') {
      // split on tabs (max 8 fields needed)
      const char* f[10];
      size_t fn[10];
      int nf = 0;
      const char* q = p;
      while (q <= eol && nf < 10) {
        const char* t = (const char*)memchr(q, '\t', eol - q);
        const char* fe = t ? t : eol;
        f[nf] = q;
        fn[nf] = fe - q;
        ++nf;
        if (!t) break;
        q = t + 1;
      }
      switch (p[0]) {
        case 'S':
          if (nf >= 3) {
            Seg s;
            s.name = {f[1], fn[1]};
            s.seq = {f[2], fn[2]};
            if (!parse_int(f[1], fn[1], &s.id)) s.id = INT64_MIN;
            segs.push_back(s);
          }
          break;
        case 'L':
          if (nf >= 5)
            ls.push_back({{f[1], fn[1]},
                          {f[3], fn[3]},
                          fn[2] == 1 && f[2][0] == '-',
                          fn[4] == 1 && f[4][0] == '-'});
          break;
        case 'P':
          if (nf >= 3) ps.push_back({{f[1], fn[1]}, {f[2], fn[2]}, false});
          break;
        case 'W':
          if (nf >= 7) {
            // name = sample#hap#seq[:start-end] (io/gfa.py W handling)
            std::string nm;
            nm.assign(f[1], fn[1]);
            nm += '#';
            nm.append(f[2], fn[2]);
            nm += '#';
            nm.append(f[3], fn[3]);
            if (!(fn[4] == 1 && (f[4][0] == '*' || f[4][0] == '0'))) {
              nm += ':';
              nm.append(f[4], fn[4]);
              nm += '-';
              nm.append(f[5], fn[5]);
            }
            wnames.push_back(std::move(nm));
            ps.push_back({{nullptr, wnames.size() - 1}, {f[6], fn[6]}, true});
          }
          break;
        default:
          break;
      }
    }
    if (!nl) break;
    p = nl + 1;
  }

  // ---- id assignment (integer names pass through; synthetic above max) ----
  int64_t max_id = 0;
  for (auto& s : segs)
    if (s.id != INT64_MIN && s.id > max_id) max_id = s.id;
  int64_t next_id = max_id + 1;
  for (auto& s : segs)
    if (s.id == INT64_MIN) s.id = next_id++;

  int64_t N = (int64_t)segs.size();
  std::vector<int32_t> order(N);
  for (int64_t i = 0; i < N; ++i) order[i] = (int32_t)i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return segs[a].id < segs[b].id;
  });
  for (int64_t i = 1; i < N; ++i) {
    if (segs[order[i]].id == segs[order[i - 1]].id) {
      r->error = err_dup("duplicate node id " +
                         std::to_string(segs[order[i]].id));
      if (data) munmap((void*)data, len);
      return r;
    }
  }
  // name -> rank
  std::unordered_map<SV, int32_t, SVHash> name_rank;
  std::unordered_map<int64_t, int32_t> id_rank;
  name_rank.reserve(N * 2);
  id_rank.reserve(N * 2);
  for (int64_t rk = 0; rk < N; ++rk) {
    const Seg& s = segs[order[rk]];
    name_rank.emplace(s.name, (int32_t)rk);
    id_rank.emplace(s.id, (int32_t)rk);
  }
  auto lookup = [&](const SV& nm, int32_t* rk) -> bool {
    auto it = name_rank.find(nm);
    if (it != name_rank.end()) {
      *rk = it->second;
      return true;
    }
    int64_t v;
    if (parse_int(nm.p, nm.n, &v)) {
      auto i2 = id_rank.find(v);
      if (i2 != id_rank.end()) {
        *rk = i2->second;
        return true;
      }
    }
    return false;
  };

  // ---- nodes ----
  r->num_nodes = N;
  r->node_id = (int64_t*)malloc(N * 8);
  r->node_len = (int64_t*)malloc(N * 8);
  r->seq_offset = (int64_t*)malloc((N + 1) * 8);
  int64_t total = 0;
  r->seq_offset[0] = 0;
  for (int64_t rk = 0; rk < N; ++rk) {
    const Seg& s = segs[order[rk]];
    r->node_id[rk] = s.id;
    r->node_len[rk] = (int64_t)s.seq.n;
    total += (int64_t)s.seq.n;
    r->seq_offset[rk + 1] = total;
  }
  r->seq_total = total;
  r->seq = (uint8_t*)malloc(total ? total : 1);
  for (int64_t rk = 0; rk < N; ++rk) {
    const Seg& s = segs[order[rk]];
    memcpy(r->seq + r->seq_offset[rk], s.seq.p, s.seq.n);
  }

  // ---- edges (canonical dedup, insertion order) ----
  std::vector<int64_t> ef, et;
  ef.reserve(ls.size());
  et.reserve(ls.size());
  std::unordered_set<uint64_t> seen;
  seen.reserve(ls.size() * 2);
  for (auto& e : ls) {
    int32_t ra, rb;
    if (!lookup(e.a, &ra) || !lookup(e.b, &rb)) {
      r->error = err_dup("L line references unknown segment");
      if (data) munmap((void*)data, len);
      return r;
    }
    int64_t a = ((int64_t)ra << 1) | (e.ra ? 1 : 0);
    int64_t b = ((int64_t)rb << 1) | (e.rb ? 1 : 0);
    // canonicalize: (b^1, a^1) < (a, b) -> flip (core/graph.py add_edge)
    int64_t fa = b ^ 1, fb = a ^ 1;
    if (fa < a || (fa == a && fb < b)) {
      a = fa;
      b = fb;
    }
    uint64_t key = ((uint64_t)a << 32) | (uint64_t)(uint32_t)b;
    if (seen.insert(key).second) {
      ef.push_back(a);
      et.push_back(b);
    }
  }
  r->num_edges = (int64_t)ef.size();
  r->edge_from = (int64_t*)malloc(ef.size() * 8 + 8);
  r->edge_to = (int64_t*)malloc(et.size() * 8 + 8);
  memcpy(r->edge_from, ef.data(), ef.size() * 8);
  memcpy(r->edge_to, et.data(), et.size() * 8);

  // ---- paths ----
  int64_t P = (int64_t)ps.size();
  r->num_paths = P;
  r->path_offset = (int64_t*)malloc((P + 1) * 8);
  r->path_name_offset = (int64_t*)malloc((P + 1) * 8);
  std::vector<int64_t> steps;
  std::string names;
  r->path_offset[0] = 0;
  r->path_name_offset[0] = 0;
  for (int64_t j = 0; j < P; ++j) {
    const Path& pa = ps[j];
    if (pa.walk) {
      names += wnames[pa.name.n];
    } else {
      names.append(pa.name.p, pa.name.n);
    }
    r->path_name_offset[j + 1] = (int64_t)names.size();
    const char* q = pa.body.p;
    const char* qe = q + pa.body.n;
    if (pa.walk) {
      // >seg<seg... tokens
      bool rev = false;
      const char* tok = nullptr;
      for (const char* c = q;; ++c) {
        if (c == qe || *c == '>' || *c == '<') {
          if (tok && c > tok) {
            int32_t rk;
            if (!lookup({tok, (size_t)(c - tok)}, &rk)) {
              r->error = err_dup("W line references unknown segment");
              if (data) munmap((void*)data, len);
              return r;
            }
            steps.push_back(((int64_t)rk << 1) | (rev ? 1 : 0));
          }
          if (c == qe) break;
          rev = (*c == '<');
          tok = c + 1;
        }
      }
    } else {
      // comma-separated "name+|-" tokens
      while (q < qe) {
        const char* c = (const char*)memchr(q, ',', qe - q);
        const char* te = c ? c : qe;
        if (te > q) {
          bool rev = te[-1] == '-';
          int32_t rk;
          if (!lookup({q, (size_t)(te - q - 1)}, &rk)) {
            r->error = err_dup("P line references unknown segment");
            if (data) munmap((void*)data, len);
            return r;
          }
          steps.push_back(((int64_t)rk << 1) | (rev ? 1 : 0));
        }
        if (!c) break;
        q = c + 1;
      }
    }
    r->path_offset[j + 1] = (int64_t)steps.size();
  }
  int64_t S = (int64_t)steps.size();
  r->num_steps = S;
  r->step_handle = (int64_t*)malloc(S * 8 + 8);
  memcpy(r->step_handle, steps.data(), S * 8);
  r->step_pos = (int64_t*)malloc(S * 8 + 8);
  for (int64_t j = 0; j < P; ++j) {
    int64_t pos = 0;
    for (int64_t s = r->path_offset[j]; s < r->path_offset[j + 1]; ++s) {
      r->step_pos[s] = pos;
      pos += r->node_len[steps[s] >> 1];
    }
  }
  r->names_total = (int64_t)names.size();
  r->path_names = (uint8_t*)malloc(names.size() + 1);
  memcpy(r->path_names, names.data(), names.size());

  if (data) munmap((void*)data, len);
  return r;
}

void odgi_gfa_free(GfaResult* r) {
  if (!r) return;
  free(r->node_id);
  free(r->node_len);
  free(r->seq_offset);
  free(r->seq);
  free(r->edge_from);
  free(r->edge_to);
  free(r->path_offset);
  free(r->step_handle);
  free(r->step_pos);
  free(r->path_names);
  free(r->path_name_offset);
  free(r->error);
  free(r);
}

}  // extern "C"
