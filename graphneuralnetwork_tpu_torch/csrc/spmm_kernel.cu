// K1: receiver-sorted CSR segment sum, per edge or with the sender gather
// folded in, for Hopper (sm_90a).
//
//   per-edge:  out[r, c] = sum over e in [row_ptr[r], row_ptr[r+1]) of
//                          src[e, c]
//   gathered:  out[r, c] = sum over the same e of
//                          round_T(w[wi(e), h(c)] * src[idx[e], c])
//
// src [E_pad, C] (per-edge values) or [N_table, C] (a node table read at
// idx[e], the edge's sender), in T = float32 or bfloat16; w float32
// [E_pad, H] (H = 1, or the heads of x [N, H, F] with h(c) = c / F), read
// at wi(e) = wperm[e] where a permutation is given, else at e, and rounded
// to T first where round_w is set; row_ptr int32 [N+1]; out [N, C] in T,
// accumulated in float32. The product rounds to T before it is added, as
// the plain version's gathered copy does (float32 products by __fmul_rn,
// which no FMA contraction merges into the add). Edges past row_ptr[N] (a
// graph's padding) are not read. The same walk over the transposed order
// (row_ptr the sender offsets, idx the receivers, wperm the edge ids) is
// the backward of the gathered form; the per-edge form with idx = the edge
// ids in sender order is the backward of a sender gather.
//
//   dot mode:  dw[wi(e), h] = sum over c of head h of
//                             src[idx[e], c] * x[r, c]   (e in span(r))
//
// beside the gathered form with weights (kDot), in float32: x [N, C] is
// the rows' own table in T. Over the transposed order (src the output's
// gradient, x the forward's table, wperm the edge ids) that is the
// gradient of the gathered form's weights, g[receiver] . x[sender] per
// edge and head, written beside d x in the same walk; with out null the
// launch writes dw alone. It replaces no TPU kernel: the JAX package
// leaves this dot to XLA. Formed apart, it gathers both operands into
// [E, C] float32 copies and reduces their product (about 5 GB of traffic
// an epoch at ogbn-arxiv's GAT), where this walk already holds
// g[receiver] and the row's x is one read a row.
//
// Bound of the dot mode: bytes, those of the walk it rides on plus the
// rows' x once and dw written once (4 bytes an edge and head).
//
// Replaces the TPU kernels _spmm_kernel_hilo and _spmm_kernel_bf16 of
// graphneuralnetwork_tpu/ops/pallas/spmm_kernel.py (:94, :119; launched by
// _spmm_pallas_call at :177). The TPU kernel turned the scatter into a
// one-hot matmul on its matrix unit, and split float32 into two bfloat16
// halves to keep precision. Here every output element has one owner, so
// neither is needed.
//
// Bound: bytes. Per-edge: each edge's values read once, the spans, out
// written once. Gathered: the table rows that the edges name (once, if the
// cache keeps them), the senders, the weights (and their permutation), the
// spans, out. One add (and one multiply) per value read. What held the
// first design (one thread per (row, 16-byte column vector), the row's
// edges walked one load at a time) back, and what this one does about it:
//   * one load in flight a thread, and at 920 rows of 128 float32 columns
//     only ~7 warps an SM: here a row takes a group of lanes, lpe lanes an
//     edge (one 16-byte vector, or one scalar, of the edge's C values each:
//     a slab of up to 32 vectors, wider rows in slabs on the grid's second
//     dimension), the group's other lanes the next edges, kUnroll edges in
//     flight a lane; the group folds its lanes by shuffles in a fixed
//     order. 128 float32 columns and more take two 16-byte vectors a lane,
//     so that a warp takes two edges at a time on a short row (Cora); two
//     columns (GTN's compositions) one 8-byte vector, so that a warp holds
//     32 such rows. The host sizes the group (ops/cuda/spmm_kernel.py:spmm_layout)
//     from C, the graph's mean row length, the row count and the SM count,
//     up to 8 warps a row (row_warps), which fold in shared memory in warp
//     order: the fill rule gives GTN's 920 rows of ~140 edges 8 warps each;
//   * narrow widths (C = 1, 2, 7, 8) put up to 32 rows on a warp's lanes,
//     each load its own sector and the warp as long as its longest row:
//     here a group covers twice the mean row length in one step, the
//     row's edges one contiguous run read by neighbouring lanes, and, for
//     vectors of up to 8 bytes, a row of more than two of its group's
//     steps (GTN's compositions: rows of up to 32 edges where the mean is
//     0.34) is taken after the others by the whole warp;
//   * a hub row serialised on its thread: a row with more than the graph's
//     threshold of edges (Graph.long_rows, the transpose's own for the
//     backward) takes a CTA of its own, whose 8 warps walk its edges
//     interleaved, kUnroll edges in flight a lane, and fold in shared
//     memory in warp order;
//   * its callers built a gathered [E, F] copy x[senders] * w first (two
//     PyTorch kernels), and the copy's backward sorted the indices on
//     every call: here the kernel reads the sender, the weight and then the
//     table row itself, and the backward is this kernel over the
//     transposed order.
// The dot mode folds each edge's products within the edge's own lanes (a
// hub's CTA too puts each edge on one lane group), so it needs no fold
// across warps; a head split over two slabs leaves a part in each slab's
// dw, which the caller sums (a reduction in a fixed order).
// No atomics, and every sum in a fixed order: the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstring>

namespace {

constexpr int kWarps = 8;          // warps of a CTA
constexpr int kSlabVecs = 32;      // vectors of a slab: one a lane
constexpr int kUnroll = 4;         // edges in flight a lane, on a row
// CTAs an SM holds at once, which the register budget must allow (64 a
// lane): the rows' loads in flight set the kernel's speed.
constexpr int kMinBlocks = 4;

constexpr unsigned kFull = 0xffffffffu;

struct SumArgs {
  const void* src;        // [E_pad, C] values, or [N_table, C] (kGather)
  const int* idx;         // [E_pad] the table row of each edge (kGather)
  const float* w;         // [E_pad, heads] (kWeight)
  const int* wperm;       // w read at wperm[e] (null: at e)
  const int* row_ptr;     // [n_rows + 1]
  const int* long_rows;   // [n_long] rows a CTA of their own takes
  void* out;              // [n_rows, C] (kDot: null for the dot alone)
  int n_rows, c, f, heads, lpe, group, row_warps, per, n_long, long_edges,
      round_w;
  const void* x;          // [n_rows, C] each row's own vector (kDot)
  float* dw;              // [n_slabs, dw_rows, heads] the dots (kDot)
  int dw_rows;
};

// kDot: where this lane's vector lies in its head's run of vectors within
// the slab (j of n; n = 0 for a lane that holds none), the longest run
// (uniform over the grid), the edge's lanes, and this slab's part of dw.
struct Dot {
  unsigned mask;
  int j, n, run;
  long long slab;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// one V-wide vector (32, 16, 8, 4 or 2 bytes) through the read-only path
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  Pack<T, V> r;
  constexpr int kBytes = sizeof(T) * V;
  if constexpr (kBytes == 32) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 t0 = __ldg(q), t1 = __ldg(q + 1);
    memcpy(&r, &t0, 16);
    memcpy(reinterpret_cast<char*>(&r) + 16, &t1, 16);
  } else if constexpr (kBytes == 16) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    memcpy(&r, &t, kBytes);
  } else if constexpr (kBytes == 8) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    memcpy(&r, &t, kBytes);
  } else if constexpr (kBytes == 4) {
    const float t = __ldg(reinterpret_cast<const float*>(p));
    memcpy(&r, &t, kBytes);
  } else {
    static_assert(kBytes == 2, "vectors of 32, 16, 8, 4 or 2 bytes");
    const unsigned short t =
        __ldg(reinterpret_cast<const unsigned short*>(p));
    memcpy(&r, &t, kBytes);
  }
  return r;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T (round to nearest even, as PyTorch's casts) and back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <int V>
__device__ __forceinline__ Dot dot_lanes(const SumArgs& a, int lane, int vi,
                                         int head, bool on) {
  const int hv = a.f / V;   // vectors a head
  const int s0 = blockIdx.y * a.per, s1 = min(s0 + a.per, a.c / V);
  Dot d;
  d.mask = a.lpe == 32 ? kFull
                       : ((1u << a.lpe) - 1) << (lane & ~(a.lpe - 1));
  d.run = min(hv, a.per);
  d.j = 1;
  d.n = 0;
  if (on) {
    const int h0 = max(head * hv, s0);
    d.j = vi - h0;
    d.n = min(head * hv + hv, s1) - h0;
  }
  d.slab = static_cast<long long>(blockIdx.y) * a.dw_rows * a.heads;
  return d;
}

// kDot: the row's own vector at this lane's columns, as float (zeros for
// row < 0 or a lane that holds no vector)
template <typename T, int V, bool kDot>
__device__ __forceinline__ void load_row(const SumArgs& a, int row, int col,
                                         bool on, float (&xr)[V]) {
  if constexpr (kDot) {
    Pack<T, V> p;
    const bool in = on && row >= 0;
    if (in)
      p = load_pack<T, V>(static_cast<const T*>(a.x) +
                          static_cast<long long>(row) * a.c + col);
#pragma unroll
    for (int i = 0; i < V; ++i) xr[i] = in ? to_float(p.v[i]) : 0.f;
  }
}

// kDot: one edge's dot with the row's own vector: this lane's V products
// in column order, folded over the head's run by a tree of shuffles within
// the edge's lanes (lane j takes lane j + off where j is a multiple of
// 2 off), stored by the run's first lane at dw[wi, head]. Every lane of
// the edge calls it.
template <typename T, int V>
__device__ __forceinline__ void edge_dot(const SumArgs& a, const Dot& d,
                                         const float (&xr)[V],
                                         const Pack<T, V>& v, int wi,
                                         int head, bool on) {
  float p = 0.f;
  if (on)
#pragma unroll
    for (int i = 0; i < V; ++i)
      p = __fadd_rn(p, __fmul_rn(to_float(v.v[i]), xr[i]));
  for (int off = 1; off < d.run; off <<= 1) {
    const float q = __shfl_down_sync(d.mask, p, off, a.lpe);
    if ((d.j & (2 * off - 1)) == 0 && d.j + off < d.n) p += q;
  }
  if (on && d.j == 0)
    a.dw[d.slab + static_cast<long long>(wi) * a.heads + head] = p;
}

// One lane's walk of the edges lo + eg, lo + eg + epg, ... below hi, U at a
// time (the indices of all U first, then their values and weights), summed
// into acc in edge order. kDot: every lane of an edge walks it (a lane
// that holds no vector loads nothing but takes part in the edge's folds),
// and each edge's dot with xr goes to dw (edge_dot).
template <typename T, int V, bool kGather, bool kWeight, bool kDot, int U>
__device__ __forceinline__ void walk(const SumArgs& a, int lo, int hi,
                                     int eg, int epg, int col, int head,
                                     bool on, const Dot& d,
                                     const float (&xr)[V], float (&acc)[V]) {
  if (!kDot && !on) return;
  const T* src = static_cast<const T*>(a.src);
  for (int e = lo + eg; e < hi; e += epg * U) {
    int si[U], wi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ee = e + u * epg;
      const bool in = ee < hi;
      si[u] = in ? (kGather ? __ldg(a.idx + ee) : ee) : -1;
      if constexpr (kWeight)
        wi[u] = in ? (a.wperm ? __ldg(a.wperm + ee) : ee) : 0;
    }
    Pack<T, V> v[U];
    float wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (si[u] < 0 || (kDot && !on)) continue;
      v[u] = load_pack<T, V>(src + static_cast<long long>(si[u]) * a.c + col);
      if constexpr (kWeight)
        wv[u] = __ldg(a.w + static_cast<long long>(wi[u]) * a.heads + head);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (si[u] < 0 || (kDot && !on)) continue;
      float wt = 1.f;
      if constexpr (kWeight) wt = a.round_w ? round_to<T>(wv[u]) : wv[u];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float x = to_float(v[u].v[i]);
        if constexpr (kWeight) x = round_to<T>(__fmul_rn(wt, x));
        acc[i] += x;
      }
    }
    if constexpr (kDot) {
#pragma unroll
      for (int u = 0; u < U; ++u)   // si[u] is uniform over the edge's lanes
        if (si[u] >= 0) edge_dot<T, V>(a, d, xr, v[u], wi[u], head, on);
    }
  }
}

// This lane's span of a row: [lo, hi); mine is false for a row past the
// end and for a long row, which a CTA of its own takes (its lanes walk
// nothing but still take part in the shuffles and barriers).
__device__ __forceinline__ void row_span(const SumArgs& a, int row, int& lo,
                                         int& hi, bool& mine) {
  lo = hi = 0;
  mine = row < a.n_rows;
  if (!mine) return;
  lo = __ldg(a.row_ptr + row);
  hi = __ldg(a.row_ptr + row + 1);
  if (a.n_long > 0 && hi - lo > a.long_edges) {
    hi = lo;
    mine = false;
  }
}

// fold the group's edge lanes (lanes lpe apart) into every lane, by the
// xor tree of the shuffles: one fixed order
template <int V>
__device__ __forceinline__ void group_fold(float (&acc)[V], int lpe,
                                           int group) {
  for (int off = lpe; off < group; off <<= 1)
#pragma unroll
    for (int i = 0; i < V; ++i)
      acc[i] += __shfl_xor_sync(kFull, acc[i], off);
}

template <typename T, int V, bool kDot>
__device__ __forceinline__ void store(const SumArgs& a, int row, int col,
                                      const float (&acc)[V]) {
  if constexpr (kDot)
    if (a.out == nullptr) return;   // the dot alone
  Pack<T, V> o;
#pragma unroll
  for (int i = 0; i < V; ++i) o.v[i] = from_float<T>(acc[i]);
  *reinterpret_cast<Pack<T, V>*>(static_cast<T*>(a.out) +
                                 static_cast<long long>(row) * a.c + col) = o;
}

// A row on rw warps (first .. first + rw - 1) of this CTA: each warp folds
// its lanes, writes its partial, and the first warp adds them in warp
// order. Every thread of the CTA calls it (two barriers).
template <typename T, int V, bool kDot>
__device__ __forceinline__ void warps_fold_store(
    const SumArgs& a, float (&acc)[V], float (*part)[kSlabVecs * V],
    int warp, int first, int rw, int sub, int eg, bool on, bool mine,
    int row, int col) {
  group_fold(acc, a.lpe, 32);
  if (eg == 0 && on)
#pragma unroll
    for (int i = 0; i < V; ++i) part[warp][sub * V + i] = acc[i];
  __syncthreads();
  if (warp == first && eg == 0 && on && mine) {
    float t[V];
#pragma unroll
    for (int i = 0; i < V; ++i) t[i] = 0.f;
    for (int q = 0; q < rw; ++q)
#pragma unroll
      for (int i = 0; i < V; ++i) t[i] += part[first + q][sub * V + i];
    store<T, V, kDot>(a, row, col, t);
  }
  __syncthreads();
}

// The work: blockIdx.x < n_long takes a long row on all 8 warps; the other
// CTAs take rows in a loop over the grid, either row sets of 32 / group
// rows a warp (row_warps 1; the next set's spans loading beside this
// set's edges) or 8 / row_warps rows a CTA on row_warps warps each.
// blockIdx.y is the slab: vectors [y * per, y * per + per) of the row's
// c / V. Lane `sub` of an edge's lpe lanes holds the slab's vector sub; a
// row's edge lanes (its group's, over all its warps) take its edges in
// turn, warp by warp. kDot: each lane holds the walked row's own vector
// at its columns (xr, loaded once a row), and every edge's lanes fold its
// dot in the walk itself; no fold across the row's lanes or warps.
template <typename T, int V, bool kGather, bool kWeight, bool kDot>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    segment_sum_kernel(SumArgs a) {
  constexpr bool kBigRows = sizeof(T) * V <= 8;
  __shared__ float part[kWarps][kSlabVecs * V];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool split = blockIdx.x < a.n_long;
  const int rw = split ? kWarps : a.row_warps;
  const int group = rw > 1 ? 32 : a.group;
  const int gl = lane & (group - 1);
  const int sub = gl & (a.lpe - 1), eg = gl / a.lpe, epg = group / a.lpe;
  const int vi = blockIdx.y * a.per + sub;
  const bool on = sub < a.per && vi < a.c / V;
  const int col = vi * V;
  const int head = kWeight && on ? col / a.f : 0;
  float acc[V], xr[V];
  Dot d{};
  if constexpr (kDot) d = dot_lanes<V>(a, lane, vi, head, on);

  if (split) {
    const int row = a.long_rows[blockIdx.x];
    const int lo = __ldg(a.row_ptr + row), hi = __ldg(a.row_ptr + row + 1);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    load_row<T, V, kDot>(a, row, col, on, xr);
    walk<T, V, kGather, kWeight, kDot, kUnroll>(
        a, lo, hi, warp * epg + eg, kWarps * epg, col, head, on, d, xr, acc);
    warps_fold_store<T, V, kDot>(a, acc, part, warp, 0, kWarps, sub, eg, on,
                                 true, row, col);
    return;
  }

  if (rw > 1) {   // rows on several warps each
    const int rpc = kWarps / rw, first = warp / rw * rw, wr = warp - first;
    const int stride = (gridDim.x - a.n_long) * rpc;
    for (int base = (blockIdx.x - a.n_long) * rpc; base < a.n_rows;
         base += stride) {   // uniform over the CTA
      const int row = base + warp / rw;
      int lo, hi;
      bool mine;
      row_span(a, row, lo, hi, mine);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      load_row<T, V, kDot>(a, hi > lo ? row : -1, col, on, xr);
      walk<T, V, kGather, kWeight, kDot, kUnroll>(
          a, lo, hi, wr * epg + eg, rw * epg, col, head, on, d, xr, acc);
      warps_fold_store<T, V, kDot>(a, acc, part, warp, first, rw, sub, eg,
                                   on, mine, row, col);
    }
    return;
  }

  const int rpw = 32 / group;
  const int n_sets = (a.n_rows + rpw - 1) / rpw;
  const int big_edges = group < 32 ? 2 * kUnroll * epg : INT_MAX;
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
    // a row longer than two steps of its group (below the long rows'
    // threshold) would hold the warp's other rows: the whole warp takes it
    // after them (vectors of 8 bytes or less: the 16-byte instances have
    // no registers to spare for it)
    const bool big = kBigRows && mine && hi - lo > big_edges;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    load_row<T, V, kDot>(a, hi > lo && !big ? row : -1, col, on, xr);
    walk<T, V, kGather, kWeight, kDot, kUnroll>(a, lo, big ? lo : hi, eg, epg,
                                                col, head, on, d, xr, acc);
    group_fold(acc, a.lpe, group);
    if (eg == 0 && mine && !big && on) store<T, V, kDot>(a, row, col, acc);
    // the warp's big rows, by their groups' first lanes in lane order, each
    // on all 32 lanes (32 / lpe edge lanes)
    for (unsigned bigs = kBigRows ? __ballot_sync(kFull, big && gl == 0) : 0;
         bigs; bigs &= bigs - 1) {
      const int first = __ffs(bigs) - 1;
      const int brow = __shfl_sync(kFull, row, first);
      const int blo = __shfl_sync(kFull, lo, first);
      const int bhi = __shfl_sync(kFull, hi, first);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      load_row<T, V, kDot>(a, brow, col, on, xr);
      walk<T, V, kGather, kWeight, kDot, kUnroll>(a, blo, bhi, lane / a.lpe,
                                                  32 / a.lpe, col, head, on,
                                                  d, xr, acc);
      group_fold(acc, a.lpe, 32);
      if (lane < a.lpe && on) store<T, V, kDot>(a, brow, col, acc);
    }
    set += stride;
    row = nrow;
    lo = nlo;
    hi = nhi;
    mine = nmine;
  }
}

template <typename T, int V>
cudaError_t launch(const SumArgs& a, dim3 grid, cudaStream_t s) {
  if (a.dw != nullptr)
    segment_sum_kernel<T, V, true, true, true>
        <<<grid, kWarps * 32, 0, s>>>(a);
  else if (a.w != nullptr)
    segment_sum_kernel<T, V, true, true, false>
        <<<grid, kWarps * 32, 0, s>>>(a);
  else if (a.idx != nullptr)
    segment_sum_kernel<T, V, true, false, false>
        <<<grid, kWarps * 32, 0, s>>>(a);
  else
    segment_sum_kernel<T, V, false, false, false>
        <<<grid, kWarps * 32, 0, s>>>(a);
  return cudaGetLastError();
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// idx: null for per-edge values, else the table row of each edge; w: null
// for none, else (with idx) float32 [E_pad, c / f] weights, read at
// wperm[e] (wperm null: at e) and rounded to the values' type first where
// round_w is set.
// dtype: 0 = float32, 1 = bfloat16. The layout
// (ops/cuda/spmm_kernel.py:spmm_layout): vectors of `vec` elements (8
// float32 in two 16-byte loads, 16 bytes, 2 elements or 1, as c, f and the
// addresses allow), `lpe` lanes an edge,
// `group` lanes a row in a warp (powers of two, lpe <= group <= 32) on
// `row_warps` warps (1, 2, 4 or 8; group 32 where more than 1), slabs of
// `per` vectors (per <= lpe) on the grid's second dimension, `n_slabs` of
// them; at most row_ctas CTAs for the rows (0: as many as the rows take),
// which loop over the rest; long_rows: the n_long rows with more than
// long_edges edges, each over a CTA. x and dw (both null, or both given
// with w): the dot mode, x [n_rows, c] in the values' type, dw float32
// [n_slabs, dw_rows, c / f], each slab's part of the dots (the caller sums
// them where n_slabs > 1); out may then be null (the dot alone). Returns
// the launch's cudaError_t.
extern "C" int gnn_segment_sum(const void* src, const void* idx,
                               const void* w, const void* wperm,
                               const void* row_ptr, const void* long_rows,
                               void* out, int n_rows, int c, int f,
                               int dtype, int vec, int lpe, int group,
                               int row_warps, int per, int n_slabs,
                               int row_ctas, int n_long, int long_edges,
                               int round_w, const void* x, void* dw,
                               int dw_rows, void* stream) {
  if (n_rows <= 0 || c <= 0) return 0;
  if ((dtype != 0 && dtype != 1) ||
      (vec != 1 && vec != 2 && vec != (dtype == 0 ? 4 : 8) &&
       !(dtype == 0 && vec == 8)) ||
      f <= 0 || c % f || c % vec || (w != nullptr && f % vec) ||
      (w != nullptr && idx == nullptr) ||
      !pow2(lpe) || !pow2(group) || lpe > group || group > 32 ||
      !pow2(row_warps) || row_warps > 8 || (row_warps > 1 && group != 32) ||
      per < 1 || per > lpe ||
      static_cast<long long>(per) * n_slabs < c / vec ||
      (n_long > 0 && long_rows == nullptr) ||
      ((x == nullptr) != (dw == nullptr)) ||
      (dw != nullptr && (w == nullptr || dw_rows <= 0)) ||
      (out == nullptr && dw == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  SumArgs a{src, static_cast<const int*>(idx), static_cast<const float*>(w),
            static_cast<const int*>(wperm), static_cast<const int*>(row_ptr),
            static_cast<const int*>(long_rows), out, n_rows, c, f, c / f,
            lpe, group, row_warps, per, n_long, long_edges, round_w,
            x, static_cast<float*>(dw), dw_rows};
  const int rows_per_cta =
      row_warps > 1 ? kWarps / row_warps : kWarps * (32 / group);
  const int needed = (n_rows + rows_per_cta - 1) / rows_per_cta;
  const dim3 grid(n_long + (row_ctas > 0 ? min(row_ctas, needed) : needed),
                  n_slabs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vec == 8   ? launch<float, 8>(a, grid, s)
          : vec == 4 ? launch<float, 4>(a, grid, s)
          : vec == 2 ? launch<float, 2>(a, grid, s)
                     : launch<float, 1>(a, grid, s);
  else
    err = vec == 8   ? launch<__nv_bfloat16, 8>(a, grid, s)
          : vec == 2 ? launch<__nv_bfloat16, 2>(a, grid, s)
                     : launch<__nv_bfloat16, 1>(a, grid, s);
  return static_cast<int>(err);
}

extern "C" const char* gnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
