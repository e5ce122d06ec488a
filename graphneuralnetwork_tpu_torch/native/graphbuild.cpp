// Native graph "compiler": the host-side edge preprocessing of every Graph
// build of 16,384 edges or more, before anything touches the card.
//
// The reference does this work with scipy/torch on one thread
// (GCN/data_utils.py:27-70 builds+normalises the COO adjacency;
// MetaPath2Vec/utils/graph_utils.py:66-139 builds per-relation CSR).
// Here it is a parallel stable counting sort by receiver plus the padded
// static-shape layout and the SpMM chunk spans
// (core/graph.py:compute_chunk_spans) in one pass — byte-exact with the
// numpy path (tests/test_torch_native.py).
//
// All functions are extern "C" over caller-owned buffers (ctypes, no
// pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
static int omp_get_thread_num() { return 0; }
#endif

extern "C" {

// Stable sort edges by receiver, pad to e_pad, emit per-row-block chunk
// spans. Outputs: out_s/out_r int32[e_pad], out_w float[e_pad],
// out_off/out_cnt int32[ceil(n_nodes/row_block)].
// Returns max_chunks (>= 1) or -1 on invalid arguments.
int64_t build_graph_csr(const int32_t* senders, const int32_t* receivers,
                        const float* weights, int64_t n_edges,
                        int64_t n_nodes, int64_t e_pad, int64_t row_block,
                        int64_t edge_chunk, int32_t* out_s, int32_t* out_r,
                        float* out_w, int32_t* out_off, int32_t* out_cnt) {
  if (n_nodes <= 0 || e_pad < n_edges || n_edges < 0 || row_block <= 0 ||
      edge_chunk <= 0 || e_pad % edge_chunk != 0) {
    return -1;
  }
  const int n_threads = std::max(1, omp_get_max_threads());
  const int64_t slice = (n_edges + n_threads - 1) / n_threads;

  // Per-(thread, receiver) histogram -> exclusive scan in (key, thread)
  // order gives each thread its stable scatter cursor per key.
  // `parallel for` over slice ids (not a bare parallel region keyed on
  // omp_get_thread_num) so every slice is processed exactly once even if
  // the runtime delivers a smaller team than requested.
  std::vector<std::vector<int64_t>> local(n_threads);
  for (int t = 0; t < n_threads; ++t)
    local[t].assign(static_cast<size_t>(n_nodes), 0);
#pragma omp parallel for schedule(static, 1)
  for (int t = 0; t < n_threads; ++t) {
    auto& h = local[t];
    const int64_t lo = t * slice;
    const int64_t hi = std::min(n_edges, lo + slice);
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t r = receivers[i];
      if (r >= 0 && r < n_nodes) ++h[static_cast<size_t>(r)];
    }
  }
  // row_ptr over keys; cursors per (key, thread).
  std::vector<int64_t> row_ptr(static_cast<size_t>(n_nodes) + 1, 0);
  int64_t running = 0;
  for (int64_t k = 0; k < n_nodes; ++k) {
    row_ptr[static_cast<size_t>(k)] = running;
    for (int t = 0; t < n_threads; ++t) {
      const int64_t c = local[t][static_cast<size_t>(k)];
      local[t][static_cast<size_t>(k)] = running;  // becomes the cursor
      running += c;
    }
  }
  row_ptr[static_cast<size_t>(n_nodes)] = running;
  if (running != n_edges) return -1;  // out-of-range receiver

#pragma omp parallel for schedule(static, 1)
  for (int t = 0; t < n_threads; ++t) {
    auto& cur = local[t];
    const int64_t lo = t * slice;
    const int64_t hi = std::min(n_edges, lo + slice);
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t pos = cur[static_cast<size_t>(receivers[i])]++;
      out_s[pos] = senders[i];
      out_r[pos] = receivers[i];
      out_w[pos] = weights ? weights[i] : 1.0f;
    }
  }
  // Padding edges: zero-weight self-loops on the last real node (keeps the
  // array sorted; they vanish in every weighted aggregation).
  const int32_t pad_node = static_cast<int32_t>(n_nodes - 1);
#pragma omp parallel for
  for (int64_t i = n_edges; i < e_pad; ++i) {
    out_s[i] = pad_node;
    out_r[i] = pad_node;
    out_w[i] = 0.0f;
  }

  // Chunk spans (semantics of compute_chunk_spans): per row block, the index
  // of its first edge chunk and the chunk count; padding edges fold into the
  // last block's span.
  const int64_t n_row_blocks = (n_nodes + row_block - 1) / row_block;
  std::vector<int64_t> row_start(static_cast<size_t>(n_row_blocks) + 1);
  for (int64_t b = 0; b <= n_row_blocks; ++b) {
    const int64_t bound = b * row_block;
    row_start[static_cast<size_t>(b)] =
        bound < n_nodes ? row_ptr[static_cast<size_t>(bound)] : e_pad;
  }
  row_start[static_cast<size_t>(n_row_blocks)] = e_pad;
  int64_t max_chunks = 1;
  for (int64_t b = 0; b < n_row_blocks; ++b) {
    const int64_t lo_c = row_start[static_cast<size_t>(b)] / edge_chunk;
    const int64_t hi_c =
        (row_start[static_cast<size_t>(b) + 1] + edge_chunk - 1) / edge_chunk;
    const int64_t cnt = std::max<int64_t>(hi_c - lo_c, 0);
    out_off[b] = static_cast<int32_t>(lo_c);
    out_cnt[b] = static_cast<int32_t>(cnt);
    max_chunks = std::max(max_chunks, cnt);
  }
  return max_chunks;
}

// Degree-weighted normalisations fused over the edge list (replaces two
// np.add.at passes + two gathers). mode 0: w_ij *= d_s^-1/2 d_r^-1/2
// (GCN/data_utils.py:54-60); mode 1: w_ij *= d_r^-1 (GTN/models/GTN.py:7-19).
// Degrees are accumulated over receivers with the incoming weights.
int64_t normalize_edge_weights(const int32_t* senders,
                               const int32_t* receivers, float* weights,
                               int64_t n_edges, int64_t n_nodes, int mode) {
  if (n_nodes <= 0 || n_edges < 0) return -1;
  // Validate every index up front: an out-of-range sender/receiver must
  // fail loudly (-1 -> the Python wrapper raises IndexError, as the numpy
  // path does) rather than read out of bounds below.
  int64_t bad = 0;
#pragma omp parallel for reduction(+ : bad)
  for (int64_t i = 0; i < n_edges; ++i) {
    if (senders[i] < 0 || senders[i] >= n_nodes || receivers[i] < 0 ||
        receivers[i] >= n_nodes)
      ++bad;
  }
  if (bad != 0) return -1;
  std::vector<double> deg(static_cast<size_t>(n_nodes), 0.0);
  const int n_threads = std::max(1, omp_get_max_threads());
  std::vector<std::vector<double>> local(n_threads);
  for (int t = 0; t < n_threads; ++t)
    local[t].assign(static_cast<size_t>(n_nodes), 0.0);
  const int64_t slice = (n_edges + n_threads - 1) / n_threads;
#pragma omp parallel for schedule(static, 1)
  for (int t = 0; t < n_threads; ++t) {
    auto& h = local[t];
    const int64_t lo = t * slice;
    const int64_t hi = std::min(n_edges, lo + slice);
    for (int64_t i = lo; i < hi; ++i)
      h[static_cast<size_t>(receivers[i])] += weights[i];
  }
#pragma omp parallel for
  for (int64_t k = 0; k < n_nodes; ++k) {
    double d = 0.0;
    for (int t = 0; t < n_threads; ++t) d += local[t][static_cast<size_t>(k)];
    deg[static_cast<size_t>(k)] = d;
  }
  // Double-precision reciprocal table then one float cast at the end —
  // the same per-element arithmetic as the numpy path (core/graph.py);
  // degree summation order differs per thread count, so results are
  // allclose (not bitwise) vs np.add.at unless OMP_NUM_THREADS=1.
  std::vector<double> dinv(static_cast<size_t>(n_nodes));
#pragma omp parallel for
  for (int64_t k = 0; k < n_nodes; ++k) {
    const double d = std::max(deg[static_cast<size_t>(k)], 1e-12);
    dinv[static_cast<size_t>(k)] =
        deg[static_cast<size_t>(k)] > 0.0
            ? (mode == 0 ? 1.0 / std::sqrt(d) : 1.0 / d)
            : 0.0;
  }
#pragma omp parallel for
  for (int64_t i = 0; i < n_edges; ++i) {
    const double w = static_cast<double>(weights[i]);
    weights[i] = static_cast<float>(
        mode == 0 ? w * dinv[static_cast<size_t>(senders[i])] *
                        dinv[static_cast<size_t>(receivers[i])]
                  : w * dinv[static_cast<size_t>(receivers[i])]);
  }
  return 0;
}

}  // extern "C"
