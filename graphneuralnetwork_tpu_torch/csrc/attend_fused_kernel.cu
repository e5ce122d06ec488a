// K8, K9 and K10: the softmax partials and the seeded tile pass of the
// three-pass hybrid GAT attend, for Hopper (sm_90a): three modes of one
// kernel on the row walk of attend_walk.cuh.
//
// With the shift m[r,h] given (the three-pass attend takes it from the
// neighbour max of f_src: K7 on the tiles, K2 on the remainder), over a
// part of the edges s -> r of each receiver row r, per head h:
//
//   p   = w * exp(min(LeakyReLU(f_dst[r,h] + f_src[s,h]) - m[r,h], 0))
//   den = sum p;   num = sum p * keep * x[s, h, :]
//
//   gnn_rem_attend   (K8, kRem)    the row's COO remainder edges (w: the
//                                  edge weight; keep: keep_mul[e,h]);
//                                  writes num [n, hf] and den [n, heads]
//   gnn_tile_parts   (K9, kTiles)  the nonzero slots of the row's tiles
//                                  (w: the tile count; keep:
//                                  head_keep(bits[t,i,j], h) / keep_prob);
//                                  writes num and den
//   gnn_attend_fused (K10, kFused) the tile slots as K9, the sums started
//                                  from num_init [n, hf] and den_init [n,
//                                  heads] (K8's partials); writes
//                                  out = num / max(den, 1e-16) and the raw
//                                  den
//
// keep is 1 without attention dropout. Outputs are float32, and every row
// < n is written (K8 and K9: zeros on a row without edges in their part;
// K10: num_init / den_init divided on a row without tile slots). The
// exponent is clamped at 0 whatever m is (the profiler's stand-in m = 0
// relies on it).
//
// Replaces the TPU kernels _rem_attend_kernel
// (graphneuralnetwork_tpu/ops/pallas/rem_attend_kernel.py:48, pallas_call
// at :173), _attend_kernel and _attend_fused_kernel
// (graphneuralnetwork_tpu/ops/bcsr_attention.py:417 and :440, pallas_calls
// at :543 and :630). A TPU grid step owns a 128-row block and one
// 1,024-edge remainder chunk (K8: each edge's receiver values fetched and
// its terms scattered with one-hot matmuls) or one dense tile (K9, K10:
// the whole 128x128 probability tile, zero slots included, times its x
// block on the matrix unit). None of that carries over.
//
// Design: K4's row walk (attend_walk.cuh) with K5's settings. A warp takes
// one receiver row and one slab of its columns (attend_layout: whole heads,
// or one part of a head wider than a warp holds, the parts on the grid's
// second dimension as in K4). The row's stream is its remainder edges,
// entries [0, nr), then its tile slots, entries [nr, len); K8 walks the
// first and reads no tile operand (its only loads before the gathers are
// rem_row_ptr, then the edges' senders, weights and keep_mul, then f_src
// and x), K9 and K10 the second (a row's tile slots start at its remainder
// count; the slots come from the row masks). Batches of 32 entries: one
// lane per entry for the sender, the weight and the dropout word
// (fill_edge), one lane per (entry, head) for p from the given m (no online
// max: m is given, so num and den need no rescale), then the senders' x
// rows gathered in 16-byte vectors, 2 to 4 edges in flight a lane. K10's
// accumulators start from the row's num_init slab (the first edge group's
// lanes) and den_init (the first lane of each head). A row above the
// host's threshold takes a CTA of its own, whose 8 warps each walk a share
// of the row's part and add their partials in shared memory in warp order
// (K10's seeds go to warp 0): K9 and K10 split HybridGraph.long_rows
// (remainder and tile slots counted together above LONG_ROW_EDGES: the set
// K4 splits, which holds every row long by its tile slots alone), K8
// HybridGraph.rem_long_rows (the remainder alone above that threshold), so
// that a row long only by its tile slots does not take a CTA for its few
// remainder edges. K10's instances compile as before the other modes were
// added; K8 and K9 depart from its text only where a short row (1.6 to 4.5
// remainder edges on the graphs measured) pays for it: their row's first
// loads go out before the lanes' set-up, which takes shifts for the
// divisions by powers of two; their per-(edge, head) step stops at the
// batch's last round; K8 keeps four edges in flight a lane where its lanes
// hold one float32 16-byte vector.
//
// Bound: bytes, the x rows the part's edges name, f_src at the senders,
// f_dst and m at the receivers, the remainder's spans, senders and weights
// (K8) or the tiles' masks and nonzero values (or the dense store, if less;
// K9, K10), under dropout one keep_mul row per remainder edge or one
// lattice word per nonzero slot, the seeds read and the outputs written
// once; one exp per (edge, head) and 2 flops per (edge, column). What held
// the first design of K8 and K9 (lane groups, one warp a row) back: each
// edge was a chain of dependent loads run one at a time (here 32 edges'
// chains side by side); strided 4-byte gathers, a head's lane group reading
// its columns as scalars (here 16-byte vectors covering whole sectors);
// K9 read every tile row's 128 values and balloted on them (here the row
// masks give the slots); a row block's tiles on the row's one warp (here
// split rows); a head wider than 32 columns a lane re-walked the row once
// per window on a warp of its own (here the walk's slabs and parts).
// No atomics; every sum in a fixed order: deterministic.
//
// GNN_WALK_STOP (a diagnostic build of time_walk_steps.py, never the
// kernels' own): 1 stops each warp before its first batch, 2 after each
// batch's per-edge step, 3 after its per-(edge, head) step, so that the
// steps' times can be told apart; such a build's outputs are wrong.

#include "attend_walk.cuh"

namespace gnn_attend {
namespace {

enum Mode { kFused = 0, kTiles = 1, kRem = 2 };

// Edges of a group whose row loads are in flight at once: K4's rule, but
// four where K8's lanes hold one float32 16-byte vector each, which takes a
// remainder row of up to 32 edges in fewer gathers one after another.
template <int MODE, int V, int NV>
constexpr int kInFlight =
    MODE == kRem && NV == 1 && V == 4 ? 4 : edges_in_flight(NV * V);

// K8's and K9's lane set-up: col_lanes and pair_lanes of attend_walk.cuh
// with the divisions by powers of two (lpe, the slab's heads rounded up) as
// shifts, and a vector's head (below 2^7 vectors into a slab of whole
// heads) by a float reciprocal, exact at those sizes: a short row spends
// fewer instructions before its first batch.
template <int NV>
__device__ __forceinline__ ColLanes<NV> col_lanes_pow2(const Slab& s,
                                                       int lane, int lpe,
                                                       int vph, int vec,
                                                       int parts) {
  ColLanes<NV> c;
  const int sh = __ffs(lpe) - 1;
  c.sub = lane & (lpe - 1);
  c.grp = lane >> sh;
  c.ngrp = 32 >> sh;
  const float rv = __frcp_rn(static_cast<float>(vph));
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int rel = c.sub + lpe * k;   // the vector within the slab
    const int vi = s.v0 + rel;
    c.on[k] = vi < s.v1;
    c.hk[k] = c.on[k] && parts == 1
                  ? __float2int_rz((static_cast<float>(rel) + 0.5f) * rv)
                  : 0;
    c.col[k] = vi * vec;
  }
  return c;
}

__device__ __forceinline__ PairLanes pair_lanes_pow2(int hs, int lane) {
  PairLanes p;
  const int sh = hs <= 1 ? 0 : 32 - __clz(hs - 1);
  p.hp = 1 << sh;
  p.h = lane & (p.hp - 1);
  p.jr = lane >> sh;
  p.epr = 32 >> sh;
  p.on = p.h < hs;
  return p;
}


struct FusedArgs {
  const void* x;           // [n, hf] XT
  const float* fs;         // [n, heads]
  const float* fd;         // [n, heads]
  const float* m;          // [n, heads], given
  const void* tiles;       // [T, 128, 128] float or bf16 (K9, K10)
  const int* bits;         // [T, 128, 128] uint32 lattice, or null
  const int* col_ids;      // [T]
  const int* tile_off;     // [n_row_blocks]
  const int* tile_cnt;     // [n_row_blocks]
  const int* row_masks;    // [T, 128, 4]
  const int* rem_senders;  // [E_pad] receiver-sorted remainder (K8)
  const float* rem_w;      // [E_pad] (K8)
  const int* rem_row_ptr;  // [n + 1]: K8's edges; where K9's and K10's
                           //   tile slots start in a row's stream
  const float* num_init;   // [n, hf] (K10)
  const float* den_init;   // [n, heads] (K10)
  const int* row_edges;    // [n] remainder edges plus tile slots a row
                           //   (K9, K10)
  const int* long_rows;    // [n_long]
  float* out;              // [n, hf]: K10's out, K8's and K9's num
  float* den;              // [n, heads]
  int n, heads, feat, tile_bf16, dropping;
  int vph, lpe, slab_heads, parts, n_long, long_edges;
  float slope, inv_keep;
  uint32_t thresh;
  const float* keep_mul;   // [E_pad, heads], or null (K8)
};

// V consecutive float32 values (the seeds and out, whose columns follow
// x's vectors of V elements): 16-byte accesses for V >= 4.
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (V == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  if constexpr (V == 1) {
    p[0] = v[0];
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// K8's entry of a batch: the remainder edge at stream position pos + lane
// of the row whose edges start at rs.e0 (no mask chunk is read).
__device__ __forceinline__ Entry rem_entry(const RowStream& rs, int pos,
                                           int end, int lane) {
  Entry en;
  en.valid = pos + lane < end;
  en.rem = true;
  en.e = rs.e0 + pos + lane;
  en.t = en.col = 0;
  return en;
}

// A warp's scratch for one batch: its slots and each (slot, head)'s
// numerator weight p * keep.
struct FusedScratch {
  EdgeScratch ed;
  float pn[32 * kPStride];
};

// A long row's per-warp partials.
struct FusedSplit {
  float den[kWarps][kSlabHeads];
  float acc[kWarps][kMaxSlabCols];
};

template <int MODE, typename XT, int V, int NV>
__global__ void __launch_bounds__(kWarps * 32, NV == 1 ? 4 : kMinBlocks)
    attend_fused_kernel(FusedArgs a) {
  __shared__ union {
    FusedScratch w[kWarps];
    FusedSplit s;
  } sh;
  __shared__ float fin[kWarps][kSlabHeads];   // den per head, at the end
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool split = blockIdx.x < a.n_long;
  const int row = split ? a.long_rows[blockIdx.x]
                        : (blockIdx.x - a.n_long) * kWarps + warp;
  if (!split && row >= a.n) return;   // uniform per warp
  RowStream rs;
  int len = 0;
  // K8 and K9: the row's first loads go out before the lanes' set-up (K8:
  // the row's remainder edges, entries [0, nr) of its stream)
  if constexpr (MODE == kRem) {
    rs.e0 = a.rem_row_ptr[row];
    rs.nr = a.rem_row_ptr[row + 1] - rs.e0;
  } else if constexpr (MODE == kTiles) {
    len = split || a.n_long > 0 ? a.row_edges[row] : 0;
    rs = row_stream(a.tile_off, a.tile_cnt, a.rem_row_ptr, a.row_masks, row,
                    lane);
  }
  const Slab S = slab_of(blockIdx.y, a.heads, a.vph, a.slab_heads, a.parts);
  const ColLanes<NV> L =
      MODE == kFused ? col_lanes<NV>(S, lane, a.lpe, a.vph, V)
                     : col_lanes_pow2<NV>(S, lane, a.lpe, a.vph, V, a.parts);
  const PairLanes P =
      MODE == kFused ? pair_lanes(S.hs, lane) : pair_lanes_pow2(S.hs, lane);
  const int heads = a.heads, hf = heads * a.feat, hg = S.h0 + P.h;
  int lo, hi;   // this warp's share of the row's stream
  if constexpr (MODE == kRem) {
    // a long row (by its remainder alone) has a CTA of its own
    if (!split && a.n_long > 0 && rs.nr > a.long_edges) return;
    warp_range(split, rs.nr, warp, lo, hi);
    if (!split) hi = rs.nr;
  } else {
    if constexpr (MODE == kFused) {
      // the row's length, loaded beside the walk's first loads: a long
      // row has a CTA of its own
      len = split || a.n_long > 0 ? a.row_edges[row] : 0;
      rs = row_stream(a.tile_off, a.tile_cnt, a.rem_row_ptr, a.row_masks,
                      row, lane);
    }
    if (!split && a.n_long > 0 && len > a.long_edges) return;
    // the row's tile slots are its stream's entries [nr, len): this
    // warp's share of them
    warp_range(split, len - rs.nr, warp, lo, hi);
    lo += rs.nr;
    if (split) hi += rs.nr;
  }
#if defined(GNN_WALK_STOP) && GNN_WALK_STOP == 1
  hi = lo;
#endif

  // this lane's head: f_dst, the given shift, its share of den (K10: the
  // seed in the head's first lane of the row's warp, or of a long row's
  // warp 0)
  const bool seeds = MODE == kFused && (!split || warp == 0);
  const float fd = P.on ? a.fd[row * heads + hg] : 0.f;
  const float mr = P.on ? a.m[row * heads + hg] : 0.f;
  float den = seeds && P.on && P.jr == 0 ? a.den_init[row * heads + hg]
                                         : 0.f;
  // acc = num over this lane's columns, K10's seed in the first edge group
  float acc[NV][V];
  const float* ninit = a.num_init + static_cast<long long>(row) * hf;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (seeds && L.grp == 0 && L.on[k]) {
      load_f32<V>(ninit + L.col[k], acc[k]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
    }
  }

  FusedScratch& ws = sh.w[warp];
  const XT* x = static_cast<const XT*>(a.x);
  for (int pos = lo;
       pos < hi && (MODE == kRem || seek(rs, a.row_masks, pos, lane));) {
    const int end = MODE == kRem
                        ? min(pos + 32, hi)
                        : min(min(pos + 32, hi), rs.base + rs.ch.total);
    const int nb = end - pos;
    if constexpr (MODE == kRem)
      fill_edge(ws.ed, a, rem_entry(rs, pos, end, lane), 0, lane);
    else
      fill_edge(ws.ed, a, batch_entry(rs, pos, end, lane), rs.ri, lane);
    __syncwarp();
#if defined(GNN_WALK_STOP) && GNN_WALK_STOP == 2
    pos = end;
    continue;
#endif
    // the x rows of the group's first U edges load beside the pairs'
    // operands
    constexpr int U = kInFlight<MODE, V, NV>;
    typename VecIO<XT, V>::Raw v[U][NV];
    gather_rows<XT, V, NV, U>(v, x, hf, ws.ed.node, L.grp, nb, L);
    // per (edge, head): p from the given shift, clamped; pn = p * keep
    const int rounds =   // at most kSlabHeads; K8, K9: epr a power of two
        MODE == kFused ? (nb + P.epr - 1) / P.epr
                       : (nb + P.epr - 1) >> (31 - __clz(P.epr));
#pragma unroll (NV == 1 ? 4 : kSlabHeads)
    for (int r = 0; r < kSlabHeads; ++r) {
      if (MODE != kFused && r >= rounds) break;   // K8, K9; uniform per warp
      const int j = r * P.epr + P.jr;
      if (r < rounds && P.on && j < nb) {
        const float sc = leaky(
            fd + a.fs[static_cast<long long>(ws.ed.node[j]) * heads + hg],
            a.slope);
        const float p = ws.ed.w[j] * expf(fminf(sc - mr, 0.f));
        den += p;
        const float keep =
            !a.dropping ? 1.f
            : MODE == kRem
                ? a.keep_mul[static_cast<long long>(rs.e0 + pos + j) * heads +
                             hg]
            : head_keep(ws.ed.word[j], hg, a.thresh) ? a.inv_keep
                                                     : 0.f;
        ws.pn[j * kPStride + P.h] = p * keep;
      }
    }
    __syncwarp();
#if defined(GNN_WALK_STOP) && GNN_WALK_STOP == 3
    pos = end;
    continue;
#endif
    // per column, the whole warp: acc += pn * x_s, U edges at a time
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
  if (split) {     // add the warps' partials in warp order
    __syncthreads();   // the batch scratch is no longer read
    FusedSplit& sp = sh.s;
    if (P.on && P.jr == 0) sp.den[warp][P.h] = den;
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
      float dd = 0.f;
      for (int q = 0; q < kWarps; ++q) dd += sp.den[q][P.h];
      den = dd;
    }
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float t = 0.f;
        for (int q = 0; q < kWarps; ++q)
          t += sp.acc[q][(L.sub + a.lpe * k) * V + i];
        acc[k][i] = t;
      }
  }

  if constexpr (MODE != kFused) {   // K8 and K9: num and den as summed
    if (P.on && P.jr == 0 && S.first) a.den[row * heads + hg] = den;
    if (L.grp != 0) return;
    float* num = a.out + static_cast<long long>(row) * hf;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (L.on[k]) store_f32<V>(num + L.col[k], acc[k]);
  } else {   // K10: out = num / max(den, 1e-16)
    if (P.on && P.jr == 0) {
      fin[fw][P.h] = den;
      if (S.first) a.den[row * heads + hg] = den;
    }
    __syncwarp();
    if (L.grp != 0) return;
    float* out = a.out + static_cast<long long>(row) * hf;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!L.on[k]) continue;
      const float d = fmaxf(fin[fw][L.hk[k]], 1e-16f);
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = acc[k][i] / d;
      store_f32<V>(out + L.col[k], o);
    }
  }
}

template <int MODE, typename XT, int V>
cudaError_t launch_nv(const FusedArgs& a, int nv, dim3 grid,
                      cudaStream_t stream) {
  const dim3 block(kWarps * 32);
  switch (nv) {
    case 1:
      attend_fused_kernel<MODE, XT, V, 1><<<grid, block, 0, stream>>>(a);
      break;
    case 2:
      attend_fused_kernel<MODE, XT, V, 2><<<grid, block, 0, stream>>>(a);
      break;
    case 4:
      if constexpr (V * 4 <= 16) {
        attend_fused_kernel<MODE, XT, V, 4><<<grid, block, 0, stream>>>(a);
        break;
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int MODE, typename XT>
cudaError_t launch_typed(const FusedArgs& a, int vec, int nv, int n_slabs,
                         cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(XT);
  const dim3 grid(a.n_long + (a.n + kWarps - 1) / kWarps, n_slabs);
  if (vec == kVec) return launch_nv<MODE, XT, kVec>(a, nv, grid, stream);
  if (vec == 1) return launch_nv<MODE, XT, 1>(a, nv, grid, stream);
  return cudaErrorInvalidValue;
}

// The fields every entry sets the same way; the operands of one mode are
// set by its entry.
FusedArgs walk_args(const void* x, const void* fs, const void* fd,
                    const void* m, const void* long_rows, void* out,
                    void* den, int n, int heads, int feat, int vec, int lpe,
                    int slab_heads, int parts, int n_long, int long_edges,
                    float slope, int dropping) {
  FusedArgs a{};
  a.x = x;
  a.fs = static_cast<const float*>(fs);
  a.fd = static_cast<const float*>(fd);
  a.m = static_cast<const float*>(m);
  a.long_rows = static_cast<const int*>(long_rows);
  a.out = static_cast<float*>(out);
  a.den = static_cast<float*>(den);
  a.n = n;
  a.heads = heads;
  a.feat = feat;
  a.dropping = dropping;
  a.vph = vec > 0 ? feat / vec : 0;   // slab_ok refuses vec < 1
  a.lpe = lpe;
  a.slab_heads = slab_heads;
  a.parts = parts;
  a.n_long = n_long;
  a.long_edges = long_edges;
  a.slope = slope;
  return a;
}

template <int MODE>
int launch(const FusedArgs& a, int x_bf16, int vec, int nv, int lpe,
           void* stream) {
  if (a.n <= 0) return 0;
  if (!slab_ok(a.heads, a.feat, vec, nv, lpe, a.slab_heads, a.parts) ||
      (a.n_long > 0 && a.long_rows == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_slabs = a.parts > 1
                          ? a.heads * a.parts
                          : (a.heads + a.slab_heads - 1) / a.slab_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_bf16 ? launch_typed<MODE, __nv_bfloat16>(a, vec, nv, n_slabs, s)
             : launch_typed<MODE, float>(a, vec, nv, n_slabs, s));
}

// K9's and K10's tile operands.
void set_tiles(FusedArgs& a, const void* tiles, const void* bits,
               const void* col_ids, const void* tile_off,
               const void* tile_cnt, const void* row_masks,
               const void* rem_row_ptr, const void* row_edges, int tile_bf16,
               float inv_keep, unsigned thresh) {
  a.tiles = tiles;
  a.bits = static_cast<const int*>(bits);
  a.col_ids = static_cast<const int*>(col_ids);
  a.tile_off = static_cast<const int*>(tile_off);
  a.tile_cnt = static_cast<const int*>(tile_cnt);
  a.row_masks = static_cast<const int*>(row_masks);
  a.rem_row_ptr = static_cast<const int*>(rem_row_ptr);
  a.row_edges = static_cast<const int*>(row_edges);
  a.tile_bf16 = tile_bf16;
  a.inv_keep = inv_keep;
  a.thresh = thresh;
}

}  // namespace
}  // namespace gnn_attend

// The column layout, as K4's (ops/cuda/attend_common.py:attend_layout of
// x and the [n, hf] outputs and seeds): vectors of `vec` elements of x (1,
// or 16 bytes), `nv` of them a lane, `lpe` lanes an edge, slabs of
// `slab_heads` heads or, with parts > 1, one head in `parts` slabs.
// x_bf16 / tile_bf16: 0 = float32, 1 = bfloat16. long_rows: the n_long
// rows above long_edges (K8: HybridGraph.rem_long_rows, by the remainder's
// own length; K9 and K10: HybridGraph.long_rows[0], by row_edges, the
// forward lengths, remainder plus tile slots). keep_mul (K8) and bits (K9,
// K10) are read only when dropping. Each returns the launch's cudaError_t.

extern "C" int gnn_rem_attend(
    const void* x, const void* fs, const void* fd, const void* m,
    const void* rem_senders, const void* rem_w, const void* rem_row_ptr,
    const void* keep_mul, const void* long_rows, void* num, void* den,
    int n, int heads, int feat, int x_bf16, int vec, int nv, int lpe,
    int slab_heads, int parts, int n_long, int long_edges, float slope,
    int dropping, void* stream) {
  using namespace gnn_attend;
  FusedArgs a = walk_args(x, fs, fd, m, long_rows, num, den, n, heads, feat,
                          vec, lpe, slab_heads, parts, n_long, long_edges,
                          slope, dropping);
  a.rem_senders = static_cast<const int*>(rem_senders);
  a.rem_w = static_cast<const float*>(rem_w);
  a.rem_row_ptr = static_cast<const int*>(rem_row_ptr);
  a.keep_mul = static_cast<const float*>(keep_mul);
  if (dropping && keep_mul == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<kRem>(a, x_bf16, vec, nv, lpe, stream);
}

extern "C" int gnn_tile_parts(
    const void* x, const void* fs, const void* fd, const void* m,
    const void* tiles, const void* bits, const void* col_ids,
    const void* tile_off, const void* tile_cnt, const void* row_masks,
    const void* rem_row_ptr, const void* row_edges, const void* long_rows,
    void* num, void* den, int n, int heads, int feat, int x_bf16,
    int tile_bf16, int vec, int nv, int lpe, int slab_heads, int parts,
    int n_long, int long_edges, float slope, float inv_keep,
    unsigned thresh, int dropping, void* stream) {
  using namespace gnn_attend;
  FusedArgs a = walk_args(x, fs, fd, m, long_rows, num, den, n, heads, feat,
                          vec, lpe, slab_heads, parts, n_long, long_edges,
                          slope, dropping);
  set_tiles(a, tiles, bits, col_ids, tile_off, tile_cnt, row_masks,
            rem_row_ptr, row_edges, tile_bf16, inv_keep, thresh);
  if (row_edges == nullptr || (dropping && bits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<kTiles>(a, x_bf16, vec, nv, lpe, stream);
}

extern "C" int gnn_attend_fused(
    const void* x, const void* fs, const void* fd, const void* m,
    const void* tiles, const void* bits, const void* col_ids,
    const void* tile_off, const void* tile_cnt, const void* row_masks,
    const void* rem_row_ptr, const void* num_init, const void* den_init,
    const void* row_edges, const void* long_rows, void* out, void* den,
    int n, int heads, int feat, int x_bf16, int tile_bf16, int vec, int nv,
    int lpe, int slab_heads, int parts, int n_long, int long_edges,
    float slope, float inv_keep, unsigned thresh, int dropping,
    void* stream) {
  using namespace gnn_attend;
  FusedArgs a = walk_args(x, fs, fd, m, long_rows, out, den, n, heads, feat,
                          vec, lpe, slab_heads, parts, n_long, long_edges,
                          slope, dropping);
  set_tiles(a, tiles, bits, col_ids, tile_off, tile_cnt, row_masks,
            rem_row_ptr, row_edges, tile_bf16, inv_keep, thresh);
  a.num_init = static_cast<const float*>(num_init);
  a.den_init = static_cast<const float*>(den_init);
  if (row_edges == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kFused>(a, x_bf16, vec, nv, lpe, stream);
}
