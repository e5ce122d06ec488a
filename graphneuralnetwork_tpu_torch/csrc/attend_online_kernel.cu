// K4: hybrid GAT softmax attention (forward), for Hopper (sm_90a).
//
// For every receiver row r and head h, over the in-edges s -> r of the
// hybrid layout (the row's slots in its row block's dense tiles and its
// COO remainder edges):
//
//   score  = LeakyReLU(f_dst[r,h] + f_src[s,h])
//   m[r,h] = max score over the live edges (tile slot != 0, remainder w > 0)
//   p      = w * exp(min(score - m, 0))            (w: tile count / weight)
//   den    = sum p;   num = sum p * keep * x[s, h, :]
//   out    = num / max(den, 1e-16)                 (in x's type)
//
// keep is the attention-dropout multiplier of the numerator only: for a tile
// slot head_keep(bits[t,i,j], h) / keep_prob from the tile's uint32 lattice,
// for a remainder edge keep_mul[e,h]. Rows without edges get out = 0,
// den = 0 and m = -1e30.
//
// Replaces the TPU kernels _attend_2d_kernel (:198) and
// _attend_unrolled_kernel (:239) of
// graphneuralnetwork_tpu/ops/pallas/attend_online_kernel.py (pallas_call
// at :440, attend_online_pallas). The TPU kernel takes a 128-row block per
// grid step, fetches receiver values with one-hot matmuls on its matrix
// unit and keeps an online softmax (_rescale, :83) across 256-edge
// remainder chunks and tiles. Here a warp takes one row and one slab of
// its columns, and keeps the same online softmax across batches of 32
// edges (attend_walk.cuh): one pass over the row.
//
// Bound: bytes. Per call the function reads each named x row once (its
// [H*F] values), f_src at the senders and f_dst at the receivers, the
// tiles' masks (16 bytes a tile row) and their values at the nonzero slots
// (or the dense store, if less), and writes out, den and m; one exp per
// (edge, head) and 2 flops per (edge, column). What held its first design
// back (a warp per row, a lane group per head), and what this one does
// about it:
//   * it read every tile row's 128 values and balloted on != 0, twice (one
//     pass for the exact max, one for the sums): here the per-graph masks
//     (BCSRGraph.row_masks) give the slots, and a value (and, under
//     dropout, a lattice word) is read only at a nonzero slot;
//   * each edge was a chain of dependent loads (sender -> f_src -> exp ->
//     x row) run one edge at a time: here a batch of 32 edges takes one
//     lane per edge for its loads and one per (edge, head) for the scores
//     and weights, so the chains of a batch run side by side; the batch
//     max is a reduction over a head's lanes, with an online rescale of
//     den and num between batches (exact: m is still the max over the live
//     edges); the gathers of a group's first edges go out beside the
//     scores' loads;
//   * a lane read one scalar of a column run per instruction, 128
//     registers with spills at 8x128: here a lane reads 16-byte vectors, a
//     group of lanes covers whole 32-byte sectors of the gathered row, 2 to
//     4 edges' loads are in flight, and a lane holds at most 16 columns (a
//     second grid dimension takes the slabs);
//   * a hub row ran on one warp: here a row with more edges than the
//     host's threshold takes a CTA of its own, whose 8 warps each walk a
//     share and combine (max, den, num) in shared memory in warp order.
// Staging each tile's named x rows in shared memory (a CTA per 64-row half
// and head) was measured slower at every shape and is not used (PERF.md
// §6): it multiplies the per-edge work by the heads and the tiles.
// No atomics; every sum in a fixed order: deterministic.

#include "attend_walk.cuh"

namespace gnn_attend {
namespace {

struct OnlineArgs {
  const void* x;           // [n, hf] XT
  const float* fs;         // [n, heads]
  const float* fd;         // [n, heads]
  const void* tiles;       // [T, 128, 128] float or bf16
  const int* bits;         // [T, 128, 128] uint32 lattice, or null
  const int* col_ids;      // [T]
  const int* tile_off;     // [n_row_blocks]
  const int* tile_cnt;     // [n_row_blocks]
  const int* row_masks;    // [T, 128, 4] nonzero slots of each tile row
  const int* rem_senders;  // [E_pad] receiver-sorted remainder
  const int* rem_row_ptr;  // [n + 1]
  const float* rem_w;      // [E_pad]
  const float* keep_mul;   // [E_pad, heads], or null
  const int* row_edges;    // [n] edges of each row (HybridGraph.row_edges)
  const int* long_rows;    // [n_long] rows split over a CTA's warps
  void* out;               // [n, hf] XT
  float* den;              // [n, heads]
  float* m;                // [n, heads]
  int n, heads, feat, tile_bf16, dropping;
  int vph, lpe, slab_heads, parts, n_long, long_edges;
  float slope, inv_keep;
  uint32_t thresh;
};

// A warp's scratch for one batch: its edges, each (edge, head)'s score and
// numerator weight p * keep, and each head's rescale factor.
struct BatchScratch {
  EdgeScratch ed;
  float sc[32 * kPStride];
  float pn[32 * kPStride];
  float scale[kSlabHeads];
};

// Per (edge, head) of a batch of nb edges: the scores, the batch max, the
// online rescale of this lane's running max mx and den share, and p * keep
// and each head's rescale factor into the scratch. kUnroll rounds' loads
// go out together (fewer where a lane has 64 registers).
template <int kUnroll>
__device__ __forceinline__ void online_pairs(BatchScratch& ws,
                                              const OnlineArgs& a,
                                              const PairLanes& P, int nb,
                                              int hg, float fd, float& mx,
                                              float& den) {
  const int rounds = (nb + P.epr - 1) / P.epr;   // at most kSlabHeads
  float bm = kNeg;
#pragma unroll (kUnroll)
  for (int r = 0; r < kSlabHeads; ++r) {
    const int j = r * P.epr + P.jr;
    if (r < rounds && P.on && j < nb) {
      const float sc = leaky(
          fd + a.fs[static_cast<long long>(ws.ed.node[j]) * a.heads + hg],
          a.slope);
      ws.sc[j * kPStride + P.h] = sc;
      if (edge_live(ws.ed, j)) bm = fmaxf(bm, sc);
    }
  }
  const float mn = fmaxf(mx, head_max(bm, P));
  const float scale = expf(mx - mn);   // exp(NEG - x) == 0
  mx = mn;
  den *= scale;
  if (P.on && P.jr == 0) ws.scale[P.h] = scale;
#pragma unroll (kUnroll)
  for (int r = 0; r < kSlabHeads; ++r) {
    const int j = r * P.epr + P.jr;
    if (r < rounds && P.on && j < nb) {
      const float p =
          ws.ed.w[j] * expf(fminf(ws.sc[j * kPStride + P.h] - mn, 0.f));
      den += p;
      float keep = 1.f;
      if (a.dropping) {
        const int e = ws.ed.e[j];
        keep = e >= 0 ? a.keep_mul[static_cast<long long>(e) * a.heads + hg]
               : head_keep(ws.ed.word[j], hg, a.thresh) ? a.inv_keep
                                                        : 0.f;
      }
      ws.pn[j * kPStride + P.h] = p * keep;
    }
  }
}

// A long row's per-warp partials.
struct SplitScratch {
  float m[kWarps][kSlabHeads];
  float den[kWarps][kSlabHeads];
  float acc[kWarps][kMaxSlabCols];
};

template <typename XT, int V, int NV>
__global__ void __launch_bounds__(kWarps * 32, NV == 1 ? 4 : kMinBlocks)
    attend_online_kernel(OnlineArgs a) {
  __shared__ union {
    BatchScratch w[kWarps];
    SplitScratch s;
  } sh;
  __shared__ float fin[kWarps][kSlabHeads];   // den per head, at the end
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool split = blockIdx.x < a.n_long;
  const int row = split ? a.long_rows[blockIdx.x]
                        : (blockIdx.x - a.n_long) * kWarps + warp;
  if (!split && row >= a.n) return;   // uniform per warp
  const Slab S = slab_of(blockIdx.y, a.heads, a.vph, a.slab_heads, a.parts);
  const ColLanes<NV> L = col_lanes<NV>(S, lane, a.lpe, a.vph, V);
  const PairLanes P = pair_lanes(S.hs, lane);
  const int heads = a.heads, hf = heads * a.feat, hg = S.h0 + P.h;
  // the row's length, loaded beside the walk's first loads: a long row
  // has a CTA of its own
  const int len = split || a.n_long > 0 ? a.row_edges[row] : 0;
  RowStream rs = row_stream(a.tile_off, a.tile_cnt, a.rem_row_ptr,
                            a.row_masks, row, lane);
  if (!split && a.n_long > 0 && len > a.long_edges) return;
  int lo, hi;
  warp_range(split, len, warp, lo, hi);

  // this lane's head: f_dst, the running max, its share of den
  const float fd = P.on ? a.fd[row * heads + hg] : 0.f;
  float mx = kNeg, den = 0.f;
  float acc[NV][V];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[k][i] = 0.f;

  BatchScratch& ws = sh.w[warp];
  const XT* x = static_cast<const XT*>(a.x);
  for (int pos = lo; pos < hi && seek(rs, a.row_masks, pos, lane);) {
    const int end = min(min(pos + 32, hi), rs.base + rs.ch.total);
    const int nb = end - pos;
    fill_edge(ws.ed, a, batch_entry(rs, pos, end, lane), rs.ri, lane);
    __syncwarp();
    // the x rows of the group's first U edges load beside the scores'
    // operands; then rescale and accumulate, U edges at a time
    constexpr int U = edges_in_flight(NV * V);
    typename VecIO<XT, V>::Raw v[U][NV];
    gather_rows<XT, V, NV, U>(v, x, hf, ws.ed.node, L.grp, nb, L);
    online_pairs<NV == 1 ? 4 : kSlabHeads>(ws, a, P, nb, hg, fd, mx, den);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const float s = L.on[k] ? ws.scale[L.hk[k]] : 1.f;
#pragma unroll
      for (int i = 0; i < V; ++i) acc[k][i] *= s;
    }
    for (int j = L.grp;;) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jj = j + u * L.ngrp;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const float pw =
              jj < nb && L.on[k] ? ws.pn[jj * kPStride + L.hk[k]] : 0.f;
          float f[V];
          VecIO<XT, V>::unpack(v[u][k], f);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[k][i] += pw * f[i];
        }
      }
      j += L.ngrp * U;
      if (j >= nb) break;
      gather_rows<XT, V, NV, U>(v, x, hf, ws.ed.node, j, nb, L);
    }
    __syncwarp();
    pos = end;
  }

  // this warp's totals: den over the head's lanes, num over the groups
  den = head_sum(den, P);
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[k][i] = group_combine(acc[k][i], a.lpe);

  int fw = warp;   // the warp whose `fin` holds the final den
  if (split) {     // combine the warps' partials in warp order
    __syncthreads();   // the batch scratch is no longer read
    SplitScratch& sp = sh.s;
    if (P.on && P.jr == 0) {
      sp.m[warp][P.h] = mx;
      sp.den[warp][P.h] = den;
    }
    if (L.grp == 0)
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i)
          sp.acc[warp][(L.sub + a.lpe * k) * V + i] = acc[k][i];
    __syncthreads();
    if (warp != 0) return;
    fw = 0;
    if (P.on) {
      float mm = kNeg, dd = 0.f;
      for (int q = 0; q < kWarps; ++q) mm = fmaxf(mm, sp.m[q][P.h]);
      for (int q = 0; q < kWarps; ++q)
        dd += sp.den[q][P.h] * expf(sp.m[q][P.h] - mm);
      mx = mm;
      den = dd;
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
      if (!L.on[k]) continue;
      float mk = kNeg;   // the final max of this vector's head
      for (int q = 0; q < kWarps; ++q) mk = fmaxf(mk, sp.m[q][L.hk[k]]);
      for (int q = 0; q < kWarps; ++q) {
        const float sc = expf(sp.m[q][L.hk[k]] - mk);
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc[k][i] += sp.acc[q][(L.sub + a.lpe * k) * V + i] * sc;
      }
    }
  }

  if (P.on && P.jr == 0) {
    fin[fw][P.h] = den;
    if (S.first) {
      a.den[row * heads + hg] = den;
      a.m[row * heads + hg] = mx;
    }
  }
  __syncwarp();
  if (L.grp != 0) return;
  XT* out = static_cast<XT*>(a.out) + static_cast<long long>(row) * hf;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (!L.on[k]) continue;
    const float d = fmaxf(fin[fw][L.hk[k]], 1e-16f);
    float o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = acc[k][i] / d;
    VecIO<XT, V>::store(out + L.col[k], o);
  }
}

template <typename XT, int V>
cudaError_t launch_nv(const OnlineArgs& a, int nv, dim3 grid,
                      cudaStream_t stream) {
  const dim3 block(kWarps * 32);
  switch (nv) {
    case 1: attend_online_kernel<XT, V, 1><<<grid, block, 0, stream>>>(a); break;
    case 2: attend_online_kernel<XT, V, 2><<<grid, block, 0, stream>>>(a); break;
    case 4:
      if constexpr (V * 4 <= 16) {
        attend_online_kernel<XT, V, 4><<<grid, block, 0, stream>>>(a);
        break;
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch(const OnlineArgs& a, int vec, int nv, int n_slabs,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(XT);
  const dim3 grid(a.n_long + (a.n + kWarps - 1) / kWarps, n_slabs);
  if (vec == kVec) return launch_nv<XT, kVec>(a, nv, grid, stream);
  if (vec == 1) return launch_nv<XT, 1>(a, nv, grid, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace gnn_attend

// x_bf16 / tile_bf16: 0 = float32, 1 = bfloat16. The column layout
// (ops/cuda/attend_common.py:attend_layout): vectors of `vec` elements (1,
// or 16 bytes), `nv` of them a lane (nv * vec <= 16), `lpe` lanes an edge
// (a power of two), slabs of `slab_heads` heads (<= 8) or, with parts > 1,
// one head in `parts` slabs. row_edges: each row's edges; long_rows: the
// n_long rows with more than long_edges of them, each split over a CTA
// (both from HybridGraph). bits and keep_mul are read only
// when dropping. Returns the launch's cudaError_t.
extern "C" int gnn_attend_online(
    const void* x, const void* fs, const void* fd, const void* tiles,
    const void* bits, const void* col_ids, const void* tile_off,
    const void* tile_cnt, const void* row_masks, const void* rem_senders,
    const void* rem_row_ptr, const void* rem_w, const void* keep_mul,
    const void* row_edges, const void* long_rows, void* out, void* den,
    void* m, int n, int heads, int feat, int x_bf16, int tile_bf16, int vec,
    int nv, int lpe, int slab_heads, int parts, int n_long, int long_edges,
    float slope, float inv_keep, unsigned thresh, int dropping,
    void* stream) {
  using namespace gnn_attend;
  if (n <= 0) return 0;
  if (!slab_ok(heads, feat, vec, nv, lpe, slab_heads, parts) ||
      (n_long > 0 && (long_rows == nullptr || row_edges == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  OnlineArgs a{x,
               static_cast<const float*>(fs),
               static_cast<const float*>(fd),
               tiles,
               static_cast<const int*>(bits),
               static_cast<const int*>(col_ids),
               static_cast<const int*>(tile_off),
               static_cast<const int*>(tile_cnt),
               static_cast<const int*>(row_masks),
               static_cast<const int*>(rem_senders),
               static_cast<const int*>(rem_row_ptr),
               static_cast<const float*>(rem_w),
               static_cast<const float*>(keep_mul),
               static_cast<const int*>(row_edges),
               static_cast<const int*>(long_rows),
               out,
               static_cast<float*>(den),
               static_cast<float*>(m),
               n, heads, feat, tile_bf16, dropping,
               feat / vec, lpe, slab_heads, parts, n_long, long_edges,
               slope, inv_keep, thresh};
  const int n_slabs = parts > 1 ? heads * parts
                                : (heads + slab_heads - 1) / slab_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(x_bf16
                              ? launch<__nv_bfloat16>(a, vec, nv, n_slabs, s)
                              : launch<float>(a, vec, nv, n_slabs, s));
}
