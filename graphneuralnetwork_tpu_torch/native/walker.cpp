// Native random-walk engine (host-side data pipeline).
//
// The reference parallelises walk generation with joblib worker processes
// (GraphEmbedding/DeepWalk/data_utils.py:48-50, GATNE/utils/
// sample_utils.py:23-31). Here: an OpenMP-threaded C++ kernel over CSR
// arrays, built with g++ at first use and loaded via ctypes
// (sampling/native.py); the vectorised numpy walkers are the reference the
// tests hold it against, and the path of use_native=False.
//
// All functions are extern "C", operate on caller-owned buffers, and use
// a counter-based splitmix64/xorshift RNG so results are reproducible for
// a given seed regardless of thread count.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed) {}
  // splitmix64
  inline uint64_t next_u64() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // uniform in [0, n)
  inline uint64_t next_below(uint64_t n) { return next_u64() % n; }
  // uniform float in [0, 1)
  inline double next_double() {
    return (next_u64() >> 11) * (1.0 / 9007199254740992.0);
  }
};

}  // namespace

extern "C" {

// Uniform random walks: walks[w, t]; dead ends self-absorb.
void uniform_walks(const int64_t* indptr, const int32_t* indices,
                   const int64_t* starts, int64_t n_walks, int64_t length,
                   uint64_t seed, int32_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t w = 0; w < n_walks; ++w) {
    Rng rng(seed * 0x2545F4914F6CDD1DULL + (uint64_t)w * 0x9E3779B9ULL + 1);
    int64_t cur = starts[w];
    out[w * length] = (int32_t)cur;
    for (int64_t t = 1; t < length; ++t) {
      int64_t lo = indptr[cur], hi = indptr[cur + 1];
      if (hi > lo) cur = indices[lo + (int64_t)rng.next_below(hi - lo)];
      out[w * length + t] = (int32_t)cur;
    }
  }
}

// Weighted walks via per-node alias tables laid out on the CSR edge
// positions: accept[e] / alias[e] are local within each node's segment.
void alias_walks(const int64_t* indptr, const int32_t* indices,
                 const float* accept, const int32_t* alias,
                 const int64_t* starts, int64_t n_walks, int64_t length,
                 uint64_t seed, int32_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t w = 0; w < n_walks; ++w) {
    Rng rng(seed * 0x2545F4914F6CDD1DULL + (uint64_t)w * 0x9E3779B9ULL + 1);
    int64_t cur = starts[w];
    out[w * length] = (int32_t)cur;
    for (int64_t t = 1; t < length; ++t) {
      int64_t lo = indptr[cur], hi = indptr[cur + 1];
      int64_t deg = hi - lo;
      if (deg > 0) {
        int64_t k = (int64_t)rng.next_below(deg);
        if (rng.next_double() >= accept[lo + k]) k = alias[lo + k];
        cur = indices[lo + k];
      }
      out[w * length + t] = (int32_t)cur;
    }
  }
}

// Second-order node2vec walks with per-EDGE alias tables: for the edge at
// CSR position e (u -> v), edge_accept/edge_alias index v's neighbor list
// locally. First hop uses the node tables.
void node2vec_walks(const int64_t* indptr, const int32_t* indices,
                    const float* node_accept, const int32_t* node_alias,
                    const float* edge_accept, const int32_t* edge_alias,
                    const int64_t* edge_tab_off,  // per-edge offset into
                                                  // edge tables (= indptr of
                                                  // the DESTINATION node)
                    const int64_t* starts, int64_t n_walks, int64_t length,
                    uint64_t seed, int32_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t w = 0; w < n_walks; ++w) {
    Rng rng(seed * 0x2545F4914F6CDD1DULL + (uint64_t)w * 0x9E3779B9ULL + 1);
    int64_t cur = starts[w];
    out[w * length] = (int32_t)cur;
    if (length == 1) continue;
    int64_t lo = indptr[cur], hi = indptr[cur + 1];
    int64_t edge_pos = -1;
    if (hi > lo) {
      int64_t k = (int64_t)rng.next_below(hi - lo);
      if (rng.next_double() >= node_accept[lo + k]) k = node_alias[lo + k];
      edge_pos = lo + k;
      cur = indices[edge_pos];
    }
    out[w * length + 1] = (int32_t)cur;
    for (int64_t t = 2; t < length; ++t) {
      int64_t clo = indptr[cur], chi = indptr[cur + 1];
      int64_t deg = chi - clo;
      if (deg > 0 && edge_pos >= 0) {
        int64_t base = edge_tab_off[edge_pos];
        int64_t k = (int64_t)rng.next_below(deg);
        if (rng.next_double() >= edge_accept[base + k])
          k = edge_alias[base + k];
        edge_pos = clo + k;
        cur = indices[edge_pos];
      }
      out[w * length + t] = (int32_t)cur;
    }
  }
}

// Fanout neighbor sampling with replacement (GraphSAGE): out[i*fanout+j].
void sample_neighbors(const int64_t* indptr, const int32_t* indices,
                      const int64_t* nodes, int64_t n_nodes_in,
                      int64_t fanout, uint64_t seed, int32_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_nodes_in; ++i) {
    Rng rng(seed * 0x2545F4914F6CDD1DULL + (uint64_t)i * 0x9E3779B9ULL + 1);
    int64_t v = nodes[i];
    int64_t lo = indptr[v], hi = indptr[v + 1];
    int64_t deg = hi - lo;
    for (int64_t j = 0; j < fanout; ++j) {
      out[i * fanout + j] =
          deg > 0 ? indices[lo + (int64_t)rng.next_below(deg)] : (int32_t)v;
    }
  }
}

int num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Struc2vec structural distances (the O(n log n · DTW) host hot loop).
//
// The reference computes these with joblib worker processes and a
// pure-python fastdtw (GraphEmbedding/Struc2Vec/utils/graph_utils.py:103-121,
// 161-162; utils/fastdtw.py:5-104). Here: OpenMP over candidate pairs with a
// full O(la*lb) DTW using the struc2vec cost max(a,b)/min(a,b) - 1.
// ---------------------------------------------------------------------------

#include <algorithm>
#include <cmath>
#include <vector>

namespace {

// Sorted degree sequence of nodes at each hop distance <= k_max from v.
void bfs_rings(const int64_t* indptr, const int32_t* indices,
               int64_t n_nodes, int64_t v, int64_t k_max,
               std::vector<std::vector<int64_t>>* rings,
               std::vector<int32_t>* visit_mark, int32_t stamp) {
  rings->clear();
  std::vector<int64_t> frontier{v};
  (*visit_mark)[v] = stamp;
  {
    std::vector<int64_t> r0{indptr[v + 1] - indptr[v]};
    rings->push_back(std::move(r0));
  }
  for (int64_t k = 0; k < k_max; ++k) {
    std::vector<int64_t> next;
    for (int64_t u : frontier) {
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        int64_t w = indices[e];
        if ((*visit_mark)[w] != stamp) {
          (*visit_mark)[w] = stamp;
          next.push_back(w);
        }
      }
    }
    if (next.empty()) break;
    std::vector<int64_t> degs;
    degs.reserve(next.size());
    for (int64_t w : next) degs.push_back(indptr[w + 1] - indptr[w]);
    std::sort(degs.begin(), degs.end());
    rings->push_back(std::move(degs));
    frontier = std::move(next);
  }
}

// Full DTW with cost max/min - 1 (matches sampling/struc2vec.py
// dtw_distance and the reference fastdtw dist semantics).
double dtw(const std::vector<int64_t>& a, const std::vector<int64_t>& b,
           std::vector<double>* prev_row, std::vector<double>* cur_row) {
  const size_t la = a.size(), lb = b.size();
  if (la == 0 || lb == 0)
    return la == lb ? 0.0 : (double)std::max(la, lb);
  const double inf = 1e300;
  prev_row->assign(lb + 1, inf);
  (*prev_row)[0] = 0.0;
  cur_row->assign(lb + 1, inf);
  for (size_t i = 1; i <= la; ++i) {
    (*cur_row)[0] = inf;
    const double av = (double)a[i - 1];
    for (size_t j = 1; j <= lb; ++j) {
      const double bv = (double)b[j - 1];
      const double big = av > bv ? av : bv;
      double small = av < bv ? av : bv;
      if (small < 1e-12) small = 1e-12;
      const double c = big / small - 1.0;
      const double m = std::min({(*prev_row)[j], (*cur_row)[j - 1],
                                 (*prev_row)[j - 1]});
      (*cur_row)[j] = c + m;
    }
    std::swap(*prev_row, *cur_row);
  }
  return (*prev_row)[lb];
}

}  // namespace

extern "C" {

// Fast path for the edgelist data loader (data/edgelist.py): parse a
// whitespace "src dst [weight]" text buffer. Tokens must be CANONICAL
// integers (optional '-', no leading zeros) so that the Python-side string
// vocab reconstructed via str(int) matches the slow path byte-for-byte;
// any other token returns -1 and the caller takes the Python path.
// Lines with fewer than two tokens are skipped (same as the Python path).
// Returns the number of edges parsed.
int64_t parse_numeric_edgelist(const char* buf, int64_t len, int weighted,
                               int64_t* src, int64_t* dst, float* w) {
  int64_t n = 0;
  int64_t i = 0;
  auto skip_ws = [&](bool stop_at_nl) {
    while (i < len && (buf[i] == ' ' || buf[i] == '\t' || buf[i] == '\r' ||
                       (!stop_at_nl && buf[i] == '\n')))
      ++i;
  };
  auto parse_int = [&](int64_t* out) -> int {
    // returns 1 ok, 0 bad token, -1 end-of-line/buffer
    skip_ws(true);
    if (i >= len || buf[i] == '\n') return -1;
    int64_t start = i;
    bool neg = false;
    if (buf[i] == '-') { neg = true; ++i; }
    int64_t digits_start = i;
    int64_t v = 0;
    while (i < len && buf[i] >= '0' && buf[i] <= '9') {
      v = v * 10 + (buf[i] - '0');
      ++i;
    }
    int64_t ndig = i - digits_start;
    if (ndig == 0) { i = start; return 0; }
    // canonical: no leading zero unless the token is exactly "0"
    if (ndig > 1 && buf[digits_start] == '0') { i = start; return 0; }
    if (neg && v == 0) { i = start; return 0; }  // "-0" not canonical
    // token must end at whitespace/newline/EOF
    if (i < len && buf[i] != ' ' && buf[i] != '\t' && buf[i] != '\r' &&
        buf[i] != '\n')
      { i = start; return 0; }
    *out = neg ? -v : v;
    return 1;
  };
  while (i < len) {
    skip_ws(false);
    if (i >= len) break;
    int64_t a, b;
    int ra = parse_int(&a);
    if (ra == 0) return -1;
    if (ra == -1) { if (i < len) ++i; continue; }
    int rb = parse_int(&b);
    if (rb == 0) return -1;
    if (rb == -1) {  // single-token line: skip (Python path: len<2 skip)
      if (i < len) ++i;
      continue;
    }
    float wv = 1.0f;
    if (weighted) {
      skip_ws(true);
      if (i < len && buf[i] != '\n') {
        char* endp = nullptr;
        wv = strtof(buf + i, &endp);
        if (endp == buf + i) return -1;
        i = endp - buf;
      }
    }
    // discard the rest of the line
    while (i < len && buf[i] != '\n') {
      if (buf[i] != ' ' && buf[i] != '\t' && buf[i] != '\r' && !weighted) {
        // extra tokens are allowed (Python ignores them) — but they must
        // not contain anything? Python ignores regardless; just skip.
      }
      ++i;
    }
    src[n] = a;
    dst[n] = b;
    w[n] = wv;
    ++n;
  }
  return n;
}

// For each pair p = (pu[p], pv[p]): out_f[p*(k_max+1)+k] = cumulative DTW
// distance through ring layer k; out_layers[p] = number of valid layers
// (= min ring count of the two endpoints, capped at k_max+1).
void struc2vec_pair_distances(const int64_t* indptr, const int32_t* indices,
                              int64_t n_nodes, int64_t k_max,
                              const int32_t* pu, const int32_t* pv,
                              int64_t n_pairs, double* out_f,
                              int32_t* out_layers) {
  // Precompute rings for every node once (parallel).
  std::vector<std::vector<std::vector<int64_t>>> all_rings(n_nodes);
#pragma omp parallel
  {
    std::vector<int32_t> mark(n_nodes, -1);
#pragma omp for schedule(dynamic, 64)
    for (int64_t v = 0; v < n_nodes; ++v) {
      bfs_rings(indptr, indices, n_nodes, v, k_max, &all_rings[v], &mark,
                (int32_t)v);
    }
  }
  const int64_t stride = k_max + 1;
#pragma omp parallel
  {
    std::vector<double> row_a, row_b;
#pragma omp for schedule(dynamic, 32)
    for (int64_t p = 0; p < n_pairs; ++p) {
      const auto& ra = all_rings[pu[p]];
      const auto& rb = all_rings[pv[p]];
      int64_t kk = (int64_t)std::min(ra.size(), rb.size());
      if (kk > stride) kk = stride;
      double acc = 0.0;
      for (int64_t k = 0; k < kk; ++k) {
        acc += dtw(ra[k], rb[k], &row_a, &row_b);
        out_f[p * stride + k] = acc;
      }
      for (int64_t k = kk; k < stride; ++k) out_f[p * stride + k] = -1.0;
      out_layers[p] = (int32_t)kk;
    }
  }
}

}  // extern "C"
