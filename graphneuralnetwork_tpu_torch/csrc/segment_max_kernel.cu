// K2: receiver-sorted CSR segment max, with an optional sender gather, for
// Hopper (sm_90a).
//
//   out[r, c] = max(empty, max over e in [row_ptr[r], row_ptr[r+1]) of
//                          src[idx(e), c])
//
// idx(e) = e when src holds per-edge scores [E_pad, C] (edge_softmax), and
// idx(e) = senders[e] when src is a node table [N, C] (the remainder's
// neighbour max of the three-pass shift and of SAGE's max-pool), so that no
// gathered [E, C] copy is built first. row_ptr int32 [N+1]; out float32
// [N, C]. A row with no edges gets the sentinel `empty` (-3e38 from the
// caller). Edges past row_ptr[N] (a graph's padding) are not read. A NaN
// propagates, as jnp.maximum does. Forward only.
//
// Replaces the TPU kernel _segmax_kernel of
// graphneuralnetwork_tpu/ops/pallas/segment_max_kernel.py (:28, pallas_call
// at :77, segment_max_pallas), which masked every 1024-edge chunk against
// every row of its 128-row block.
//
// Bound: bytes, each edge's scores (or each table row the edges name) read
// once, the spans and senders, out written once; one compare per (edge,
// column). What held the first design (one thread per (row, column), the
// row's edges walked one 4-byte load at a time) back, and what this one
// does about it:
//   * with one column, the 32 lanes of a warp were 32 rows, each load up to
//     32 sectors for 128 useful bytes, the warp as long as its longest row;
//     with eight, four rows shared a warp and a thread had one load in
//     flight: here a row takes a group of lanes, lpe lanes an edge (one
//     16-byte vector, or one scalar, of the edge's C values each: a slab
//     of up to 32 vectors, wider rows in slabs on the grid's second
//     dimension), the group's other lanes the next edges, kUnroll edges in
//     flight a lane; a row's scores are one contiguous run, read by
//     neighbouring lanes; the group folds its lanes by shuffles. The host
//     sizes the group (ops/cuda/segment_max_kernel.py:segmax_layout) from
//     the graph's mean row length and how many rows fill the card; the
//     rows take at most one resident wave of CTAs, whose warps loop over
//     the row sets, the next set's spans loading beside this one's edges;
//   * a hub row serialised on its thread: a row with more than the graph's
//     threshold of edges (Graph.long_rows) takes a CTA of its own, whose 8
//     warps each walk a contiguous share, kSplitUnroll edges in flight a
//     lane, and fold in shared memory;
//   * two of its callers gathered src[senders] into an [E, C] copy first
//     (a PyTorch indexing kernel): here the kernel reads the sender and
//     then the table row itself.
// A max is exact in any order, so the output equals the plain version's bit
// for bit (a NaN stays a NaN). No atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // warps of a CTA (a long row's CTA)
constexpr int kSlabVecs = 32;      // vectors of a slab: one a lane
constexpr int kUnroll = 4;         // edges in flight a lane, on a row
constexpr int kSplitUnroll = 8;    // the same, on a long row's CTA
// CTAs an SM holds at once, which the register budget must allow (64 a
// lane): the rows' loads in flight set the kernel's speed.
constexpr int kMinBlocks = 4;
constexpr unsigned kFull = 0xffffffffu;

struct SegArgs {
  const float* src;       // [E_pad, C] scores, or [N_table, C] (kGather)
  const int* senders;     // [E_pad] (kGather)
  const int* row_ptr;     // [n_rows + 1]
  const int* long_rows;   // [n_long] rows a CTA of their own takes
  float* out;             // [n_rows, C]
  int n_rows, c, lpe, group, per, n_long, long_edges;
  float empty;
};

// max.NaN: a NaN in either operand gives NaN, as jnp.maximum does
__device__ __forceinline__ float max_nan(float m, float s) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(s));
  return r;
}

template <int V>
struct Vec;

template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    p[0] = v[0];
  }
};

template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// One lane's walk of the edges lo + eg, lo + eg + epg, ... below hi, U at a
// time (the senders of all U first, then their rows), folded into m.
template <int V, bool kGather, int U>
__device__ __forceinline__ void walk(const SegArgs& a, int lo, int hi,
                                     int eg, int epg, int col, bool on,
                                     float (&m)[V]) {
  if (!on) return;
  for (int e = lo + eg; e < hi; e += epg * U) {
    int idx[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ee = e + u * epg;
      idx[u] = ee < hi ? (kGather ? __ldg(a.senders + ee) : ee) : -1;
    }
    float v[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (idx[u] >= 0)
        Vec<V>::load(a.src + static_cast<long long>(idx[u]) * a.c + col,
                     v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (idx[u] >= 0)
#pragma unroll
        for (int i = 0; i < V; ++i) m[i] = max_nan(m[i], v[u][i]);
  }
}

// This lane's span of a row: [lo, hi); mine is false for a row past the
// end and for a long row, which a CTA of its own takes (its lanes walk
// nothing but still take part in the shuffles).
__device__ __forceinline__ void row_span(const SegArgs& a, int row, int& lo,
                                         int& hi, bool& mine) {
  lo = hi = 0;
  mine = row < a.n_rows;
  if (!mine) return;
  lo = __ldg(a.row_ptr + row);
  hi = __ldg(a.row_ptr + row + 1);
  if (hi - lo > a.long_edges) {
    hi = lo;
    mine = false;
  }
}

// fold the group's edge lanes (lanes lpe apart) into its first lpe lanes
template <int V>
__device__ __forceinline__ void group_fold(float (&m)[V], int lpe,
                                           int group) {
  for (int off = lpe; off < group; off <<= 1)
#pragma unroll
    for (int i = 0; i < V; ++i)
      m[i] = max_nan(m[i], __shfl_xor_sync(kFull, m[i], off));
}

// The work: blockIdx.x < n_long takes a long row on all 8 warps, each a
// contiguous share; the other CTAs' warps walk row sets (32 / group rows
// a warp, a group of lanes a row) in a loop over the grid, the next set's
// spans loading beside this set's edges. blockIdx.y is the slab: vectors
// [y * per, y * per + per) of the row's c / V. Lane `sub` of an edge's lpe
// lanes holds the slab's vector sub; the group's epg = group / lpe edges
// at a time go to its lanes in turn.
template <int V, bool kGather>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    segment_max_kernel(SegArgs a) {
  __shared__ float part[kWarps][kSlabVecs * V];   // a long row's partials
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool split = blockIdx.x < a.n_long;
  const int group = split ? 32 : a.group;
  const int gl = lane & (group - 1);
  const int sub = gl & (a.lpe - 1), eg = gl / a.lpe, epg = group / a.lpe;
  const int vi = blockIdx.y * a.per + sub;
  const bool on = sub < a.per && vi < a.c / V;
  const int col = vi * V;
  float m[V];

  if (split) {
    const int row = a.long_rows[blockIdx.x];
    int lo = __ldg(a.row_ptr + row), hi = __ldg(a.row_ptr + row + 1);
    const int len = hi - lo, share = (len + kWarps - 1) / kWarps;
    lo += min(warp * share, len);
    hi = min(lo + share, hi);
#pragma unroll
    for (int i = 0; i < V; ++i) m[i] = a.empty;
    walk<V, kGather, kSplitUnroll>(a, lo, hi, eg, epg, col, on, m);
    group_fold(m, a.lpe, 32);
    if (eg == 0 && on)   // the warps' partials, folded in warp order
#pragma unroll
      for (int i = 0; i < V; ++i) part[warp][sub * V + i] = m[i];
    __syncthreads();
    if (warp != 0 || !on) return;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float t = a.empty;
      for (int q = 0; q < kWarps; ++q) t = max_nan(t, part[q][sub * V + i]);
      m[i] = t;
    }
    if (eg == 0)
      Vec<V>::store(a.out + static_cast<long long>(row) * a.c + col, m);
    return;
  }

  const int rpw = 32 / group;
  const int n_sets = (a.n_rows + rpw - 1) / rpw;
  const int stride = (gridDim.x - a.n_long) * kWarps;
  int set = (blockIdx.x - a.n_long) * kWarps + warp;
  int row = set * rpw + lane / group, lo, hi;
  bool mine;
  row_span(a, row, lo, hi, mine);
  while (set < n_sets) {   // uniform per warp
    const int nrow = row + stride * rpw;
    int nlo, nhi;
    bool nmine;
    row_span(a, nrow, nlo, nhi, nmine);
#pragma unroll
    for (int i = 0; i < V; ++i) m[i] = a.empty;
    walk<V, kGather, kUnroll>(a, lo, hi, eg, epg, col, on, m);
    group_fold(m, a.lpe, group);
    if (eg == 0 && mine && on)
      Vec<V>::store(a.out + static_cast<long long>(row) * a.c + col, m);
    set += stride;
    row = nrow;
    lo = nlo;
    hi = nhi;
    mine = nmine;
  }
}

template <int V>
cudaError_t launch(const SegArgs& a, bool gather, dim3 grid,
                   cudaStream_t stream) {
  if (gather)
    segment_max_kernel<V, true><<<grid, kWarps * 32, 0, stream>>>(a);
  else
    segment_max_kernel<V, false><<<grid, kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

__global__ void noop_kernel() {}

}  // namespace

// senders: null for per-edge scores, else the gather index. The layout
// (ops/cuda/segment_max_kernel.py:segmax_layout): vectors of `vec` floats
// (1, or 4 where c and the addresses allow), `lpe` lanes an edge, `group`
// lanes a row (powers of two, lpe <= group <= 32), slabs of `per` vectors
// (per <= lpe) on the grid's second dimension, `n_slabs` of them; at most
// row_ctas CTAs for the rows (0: one row set a warp), whose warps loop
// over the rest; long_rows: the n_long rows with more than long_edges
// edges (Graph.long_rows), each over a CTA. Returns the launch's
// cudaError_t.
extern "C" int gnn_segment_max(const void* src, const void* senders,
                               const void* row_ptr, const void* long_rows,
                               void* out, int n_rows, int c, int vec,
                               int lpe, int group, int per, int n_slabs,
                               int row_ctas, int n_long, int long_edges,
                               float empty, void* stream) {
  if (n_rows <= 0 || c <= 0) return 0;
  if ((vec != 1 && vec != 4) || c % vec || !pow2(lpe) || !pow2(group) ||
      lpe > group || group > 32 || per < 1 || per > lpe ||
      static_cast<long long>(per) * n_slabs < c / vec ||
      (n_long > 0 && long_rows == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  SegArgs a{static_cast<const float*>(src), static_cast<const int*>(senders),
            static_cast<const int*>(row_ptr),
            static_cast<const int*>(long_rows), static_cast<float*>(out),
            n_rows, c, lpe, group, per, n_long, long_edges, empty};
  const int rows_per_cta = kWarps * (32 / group);
  const int needed = (n_rows + rows_per_cta - 1) / rows_per_cta;
  const dim3 grid(n_long + (row_ctas > 0 ? min(row_ctas, needed) : needed),
                  n_slabs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec == 4 ? launch<4>(a, senders, grid, s)
                                   : launch<1>(a, senders, grid, s));
}

// An empty kernel on one warp: the launch floor of the ctypes path, timed
// beside the kernels. Returns the launch's cudaError_t.
extern "C" int gnn_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
