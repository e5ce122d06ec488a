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
//
// GAT's edge softmax (ops/segment.py:gat_edge_softmax) rides the same walk
// as two further modes, always with the gather, from the per-node logits
// f_src [N_table, C] (src, read at the senders) and f_dst [n_rows, C]:
//
//   kSoftmax:    s_e = LeakyReLU(f_src[senders_e] + f_dst[r]),
//                m = max_e s_e, d = max(sum_e exp(s_e - m), 1e-16),
//                alpha_e = exp(s_e - m) / d              (edge_out [E_pad, C])
//   kSoftmaxBwd: c = sum_e alpha_e * dalpha_e,
//                ds_e = alpha_e (dalpha_e - c) * (z_e > 0 ? 1 : slope) with
//                z_e = f_src[senders_e] + f_dst[r]       (edge_out [E_pad, C]),
//                d f_dst[r] = sum_e ds_e                 (out [n_rows, C])
//
// each over the row's edges, per column (a head). A lane reads its row's
// f_dst once and walks the row's edges once a pass (three passes forward,
// two backward), each pass re-reading the senders and the f_src rows they
// name: at GAT's widths (C = 8 or 1) the table is a few MB, held in the
// 50 MB L2, so the passes cost little beside the one [E, C] write forward
// and the [E, C] reads and write backward, where the PyTorch chain they
// replace (the gathers of f_src, f_dst, the maxima and the denominators,
// the elementwise steps and their backward) took some fifteen [E, C]
// passes through HBM. The row's partials fold by shuffles within its group
// and, on a long row's CTA, through shared memory in warp order, so every
// lane holds the row's max, denominator or dot before the next pass. All
// float32 with IEEE expf and division, the chain's formula and order of
// operations per edge; the sums run in the walk's fixed order (no atomics),
// so a launch repeats bit for bit. Replaces no TPU kernel (the JAX package
// leaves the chain to XLA beside _segmax_kernel).

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
// The softmax modes' edges in flight a lane, on a row and on a long row's
// CTA alike: the passes keep the row's max, denominator or dot and f_dst
// live beside the edges' values, and the backward carries alpha and dalpha
// beside the scores, in the same register budget.
constexpr int kSoftUnroll = 4;
constexpr int kBwdUnroll = 2;

// The kernel's modes: the segment max, GAT's edge softmax, its backward.
enum Mode { kMax = 0, kSoftmax = 1, kSoftmaxBwd = 2 };

struct SegArgs {
  const float* src;       // [E_pad, C] scores, or [N_table, C] (kGather)
  const int* senders;     // [E_pad] (kGather)
  const int* row_ptr;     // [n_rows + 1]
  const int* long_rows;   // [n_long] rows a CTA of their own takes
  float* out;             // [n_rows, C]
  int n_rows, c, lpe, group, per, n_long, long_edges;
  float empty;
  // the softmax modes: src is f_src and senders its index; out is d f_dst
  const float* dst;       // f_dst [n_rows, C]
  const float* alpha;     // [E_pad, C] (kSoftmaxBwd)
  const float* grad;      // dalpha [E_pad, C] (kSoftmaxBwd)
  float* edge_out;        // alpha (kSoftmax) or ds (kSoftmaxBwd) [E_pad, C]
  float slope;            // LeakyReLU's negative slope
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

__device__ __forceinline__ float leaky(float z, float slope) {
  return z > 0.f ? z : z * slope;
}

struct MaxOp {
  __device__ __forceinline__ float operator()(float x, float y) const {
    return max_nan(x, y);
  }
};

struct AddOp {
  __device__ __forceinline__ float operator()(float x, float y) const {
    return x + y;
  }
};

// Where a lane sits in its row's walk: its span [lo, hi), its edge lanes'
// stride epg and offset eg, its vector (sub, col) and whether it holds one
// (on); split: the row is a long row's CTA.
struct Lane {
  int lo, hi, eg, epg, sub, col, warp;
  bool on, split;
};

// One lane's walk of its edges lo + eg, lo + eg + epg, ... below hi, U at a
// time: the loads of all U first (kScore: the sender, then its f_src row,
// to which the row's f_dst `fd` is added, giving z; kPair: alpha and dalpha
// at the edge), then f(edge, z, alpha, dalpha) for each.
template <int V, int U, bool kScore, bool kPair, class F>
__device__ __forceinline__ void walk_edges(const SegArgs& a, const Lane& l,
                                           const float (&fd)[V], F f) {
  if (!l.on) return;
  for (int e = l.lo + l.eg; e < l.hi; e += l.epg * U) {
    bool ok[U];
    int idx[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ee = e + u * l.epg;
      ok[u] = ee < l.hi;
      idx[u] = kScore && ok[u] ? __ldg(a.senders + ee) : 0;
    }
    float z[U][V], al[U][V], g[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const long long at = static_cast<long long>(e + u * l.epg) * a.c + l.col;
      if (kScore)
        Vec<V>::load(a.src + static_cast<long long>(idx[u]) * a.c + l.col,
                     z[u]);
      if (kPair) {
        Vec<V>::load(a.alpha + at, al[u]);
        Vec<V>::load(a.grad + at, g[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      if (kScore)
#pragma unroll
        for (int i = 0; i < V; ++i) z[u][i] += fd[i];
      f(e + u * l.epg, z[u], al[u], g[u]);
    }
  }
}

// Fold v over the row's lanes, so that every lane of the row holds the
// row's value: the group's edge lanes (lanes lpe apart) by xor shuffles,
// and on a long row's CTA the 8 warps' partials through shared memory,
// combined in warp order from `init`.
template <int V, class Op>
__device__ __forceinline__ void row_fold(float (&v)[V], const Lane& l,
                                         int lpe, int group,
                                         float (*part)[kSlabVecs * V],
                                         float init, Op op) {
  for (int off = lpe; off < group; off <<= 1)
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = op(v[i], __shfl_xor_sync(kFull, v[i], off));
  if (!l.split) return;
  if (l.eg == 0 && l.on)
#pragma unroll
    for (int i = 0; i < V; ++i) part[l.warp][l.sub * V + i] = v[i];
  __syncthreads();
  if (l.on)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float t = init;
      for (int q = 0; q < kWarps; ++q) t = op(t, part[q][l.sub * V + i]);
      v[i] = t;
    }
  __syncthreads();   // part is free again for the next fold
}

// One row of the softmax modes on its lanes (module note); `store` is
// false on lanes whose row is not theirs (past the end, or a long row in
// the row sets).
template <int V, int kMode>
__device__ __forceinline__ void softmax_row(const SegArgs& a, int row,
                                            const Lane& l, int group,
                                            bool store,
                                            float (*part)[kSlabVecs * V]) {
  float fd[V];
#pragma unroll
  for (int i = 0; i < V; ++i) fd[i] = 0.f;
  if (l.on && l.hi > l.lo)
    Vec<V>::load(a.dst + static_cast<long long>(row) * a.c + l.col, fd);
  const float slope = a.slope;
  if constexpr (kMode == kSoftmax) {
    float m[V], d[V];
#pragma unroll
    for (int i = 0; i < V; ++i) m[i] = a.empty;
    walk_edges<V, kSoftUnroll, true, false>(
        a, l, fd, [&](int, const float (&z)[V], const float (&)[V],
                      const float (&)[V]) {
#pragma unroll
          for (int i = 0; i < V; ++i) m[i] = max_nan(m[i], leaky(z[i], slope));
        });
    row_fold(m, l, a.lpe, group, part, a.empty, MaxOp());
#pragma unroll
    for (int i = 0; i < V; ++i) {
      // a row whose every score lies at the sentinel shifts by 0, as the
      // chain's does
      m[i] = m[i] > 0.5f * a.empty ? m[i] : 0.f;
      d[i] = 0.f;
    }
    walk_edges<V, kSoftUnroll, true, false>(
        a, l, fd, [&](int, const float (&z)[V], const float (&)[V],
                      const float (&)[V]) {
#pragma unroll
          for (int i = 0; i < V; ++i) d[i] += expf(leaky(z[i], slope) - m[i]);
        });
    row_fold(d, l, a.lpe, group, part, 0.f, AddOp());
#pragma unroll
    for (int i = 0; i < V; ++i) d[i] = d[i] < 1e-16f ? 1e-16f : d[i];
    walk_edges<V, kSoftUnroll, true, false>(
        a, l, fd, [&](int e, const float (&z)[V], const float (&)[V],
                      const float (&)[V]) {
          float o[V];
#pragma unroll
          for (int i = 0; i < V; ++i)
            o[i] = expf(leaky(z[i], slope) - m[i]) / d[i];
          Vec<V>::store(a.edge_out + static_cast<long long>(e) * a.c + l.col,
                        o);
        });
  } else {
    float c[V], t[V];
#pragma unroll
    for (int i = 0; i < V; ++i) c[i] = t[i] = 0.f;
    walk_edges<V, kBwdUnroll, false, true>(
        a, l, fd, [&](int, const float (&)[V], const float (&al)[V],
                      const float (&g)[V]) {
#pragma unroll
          for (int i = 0; i < V; ++i) c[i] += al[i] * g[i];
        });
    row_fold(c, l, a.lpe, group, part, 0.f, AddOp());
    walk_edges<V, kBwdUnroll, true, true>(
        a, l, fd, [&](int e, const float (&z)[V], const float (&al)[V],
                      const float (&g)[V]) {
          float ds[V];
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float v = al[i] * (g[i] - c[i]);
            ds[i] = z[i] > 0.f ? v : v * slope;
            t[i] += ds[i];
          }
          Vec<V>::store(a.edge_out + static_cast<long long>(e) * a.c + l.col,
                        ds);
        });
    row_fold(t, l, a.lpe, group, part, 0.f, AddOp());
    if (store && l.eg == 0 && l.on && (!l.split || l.warp == 0))
      Vec<V>::store(a.out + static_cast<long long>(row) * a.c + l.col, t);
  }
}

// The softmax modes' work, laid out as the max's (below): a long row on
// all 8 warps of its CTA, each a contiguous share; the other rows in row
// sets of 32 / group a warp, looped over the grid.
template <int V, int kMode>
__device__ __forceinline__ void softmax_rows(const SegArgs& a,
                                             float (*part)[kSlabVecs * V]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool split = blockIdx.x < a.n_long;
  const int group = split ? 32 : a.group;
  const int gl = lane & (group - 1);
  Lane l;
  l.sub = gl & (a.lpe - 1);
  l.eg = gl / a.lpe;
  l.epg = group / a.lpe;
  l.warp = warp;
  l.split = split;
  const int vi = blockIdx.y * a.per + l.sub;
  l.on = l.sub < a.per && vi < a.c / V;
  l.col = vi * V;

  if (split) {
    const int row = a.long_rows[blockIdx.x];
    const int lo = __ldg(a.row_ptr + row), hi = __ldg(a.row_ptr + row + 1);
    const int len = hi - lo, share = (len + kWarps - 1) / kWarps;
    l.lo = lo + min(warp * share, len);
    l.hi = min(l.lo + share, hi);
    softmax_row<V, kMode>(a, row, l, 32, true, part);
    return;
  }

  const int rpw = 32 / group;
  const int n_sets = (a.n_rows + rpw - 1) / rpw;
  const int stride = (gridDim.x - a.n_long) * kWarps;
  int set = (blockIdx.x - a.n_long) * kWarps + warp;
  int row = set * rpw + lane / group;
  bool mine;
  row_span(a, row, l.lo, l.hi, mine);
  while (set < n_sets) {   // uniform per warp
    const int nrow = row + stride * rpw;
    int nlo, nhi;
    bool nmine;
    row_span(a, nrow, nlo, nhi, nmine);
    softmax_row<V, kMode>(a, row, l, group, mine, part);
    set += stride;
    row = nrow;
    l.lo = nlo;
    l.hi = nhi;
    mine = nmine;
  }
}

// The work: blockIdx.x < n_long takes a long row on all 8 warps, each a
// contiguous share; the other CTAs' warps walk row sets (32 / group rows
// a warp, a group of lanes a row) in a loop over the grid, the next set's
// spans loading beside this set's edges. blockIdx.y is the slab: vectors
// [y * per, y * per + per) of the row's c / V. Lane `sub` of an edge's lpe
// lanes holds the slab's vector sub; the group's epg = group / lpe edges
// at a time go to its lanes in turn. kMode: the max (below), or one of
// the softmax modes (softmax_rows, with the gather).
template <int V, bool kGather, int kMode>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    segment_max_kernel(SegArgs a) {
  __shared__ float part[kWarps][kSlabVecs * V];   // a long row's partials
  if constexpr (kMode != kMax) {
    softmax_rows<V, kMode>(a, part);
    return;
  }
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
cudaError_t launch(const SegArgs& a, bool gather, int mode, dim3 grid,
                   cudaStream_t stream) {
  if (mode == kSoftmax)
    segment_max_kernel<V, true, kSoftmax><<<grid, kWarps * 32, 0, stream>>>(
        a);
  else if (mode == kSoftmaxBwd)
    segment_max_kernel<V, true, kSoftmaxBwd>
        <<<grid, kWarps * 32, 0, stream>>>(a);
  else if (gather)
    segment_max_kernel<V, true, kMax><<<grid, kWarps * 32, 0, stream>>>(a);
  else
    segment_max_kernel<V, false, kMax><<<grid, kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

bool bad_layout(int c, int vec, int lpe, int group, int per, int n_slabs,
                int n_long, const void* long_rows) {
  return (vec != 1 && vec != 4) || c % vec || !pow2(lpe) || !pow2(group) ||
         lpe > group || group > 32 || per < 1 || per > lpe ||
         static_cast<long long>(per) * n_slabs < c / vec ||
         (n_long > 0 && long_rows == nullptr);
}

cudaError_t run(const SegArgs& a, int vec, int n_slabs, int row_ctas,
                bool gather, int mode, void* stream) {
  const int rows_per_cta = kWarps * (32 / a.group);
  const int needed = (a.n_rows + rows_per_cta - 1) / rows_per_cta;
  const dim3 grid(a.n_long + (row_ctas > 0 ? min(row_ctas, needed) : needed),
                  n_slabs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec == 4 ? launch<4>(a, gather, mode, grid, s)
                  : launch<1>(a, gather, mode, grid, s);
}

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
  if (bad_layout(c, vec, lpe, group, per, n_slabs, n_long, long_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  SegArgs a{static_cast<const float*>(src), static_cast<const int*>(senders),
            static_cast<const int*>(row_ptr),
            static_cast<const int*>(long_rows), static_cast<float*>(out),
            n_rows, c, lpe, group, per, n_long, long_edges, empty};
  return static_cast<int>(
      run(a, vec, n_slabs, row_ctas, senders != nullptr, kMax, stream));
}

// GAT's edge softmax (kSoftmax, backward 0) and its backward (kSoftmaxBwd,
// backward 1) over the same layout: f_src [N_table, C] read at senders,
// f_dst [n_rows, C]; forward writes alpha into edge_out [E_pad, C];
// backward reads alpha and grad (dalpha) [E_pad, C] and writes ds into
// edge_out and d f_dst into out [n_rows, C]. The edges past row_ptr[n_rows]
// are neither read nor written. Returns the launch's cudaError_t.
extern "C" int gnn_gat_softmax(const void* f_src, const void* f_dst,
                               const void* senders, const void* row_ptr,
                               const void* long_rows, const void* alpha,
                               const void* grad, void* edge_out, void* out,
                               int n_rows, int c, int vec, int lpe,
                               int group, int per, int n_slabs, int row_ctas,
                               int n_long, int long_edges, float empty,
                               float slope, int backward, void* stream) {
  if (n_rows <= 0 || c <= 0) return 0;
  if (bad_layout(c, vec, lpe, group, per, n_slabs, n_long, long_rows) ||
      !f_src || !f_dst || !senders || !row_ptr || !edge_out ||
      (backward && (!alpha || !grad || !out)))
    return static_cast<int>(cudaErrorInvalidValue);
  SegArgs a{static_cast<const float*>(f_src),
            static_cast<const int*>(senders),
            static_cast<const int*>(row_ptr),
            static_cast<const int*>(long_rows), static_cast<float*>(out),
            n_rows, c, lpe, group, per, n_long, long_edges, empty,
            static_cast<const float*>(f_dst),
            static_cast<const float*>(alpha),
            static_cast<const float*>(grad), static_cast<float*>(edge_out),
            slope};
  return static_cast<int>(run(a, vec, n_slabs, row_ctas, true,
                              backward ? kSoftmaxBwd : kSoftmax, stream));
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
