// K10: the seeded tile pass of the three-pass hybrid GAT attend, for
// Hopper (sm_90a).
//
// With the shift m[r,h] given (the three-pass attend takes it from the
// neighbour max of f_src: K7 on the tiles, K2 on the remainder) and the
// remainder's partials num_init [n, hf] and den_init [n, heads] (K8), over
// the nonzero slots s -> r of each receiver row's tiles, per head h:
//
//   p   = w * exp(min(LeakyReLU(f_dst[r,h] + f_src[s,h]) - m[r,h], 0))
//   num = num_init + sum p * keep * x[s, h, :]
//   den = den_init + sum p
//   out = num / max(den, 1e-16)                  (float32), and the raw den
//
// w is the tile count, keep 1 or, under attention dropout,
// head_keep(bits[t,i,j], h) / keep_prob. The exponent is clamped at 0
// whatever m is (the profiler's stand-in m = 0 relies on it). Every row is
// written, also a row whose row block has no tile (num_init / den_init
// divided).
//
// Replaces the TPU kernel _attend_fused_kernel of
// graphneuralnetwork_tpu/ops/bcsr_attention.py (:440, pallas_call at :630,
// _fused_pallas), which multiplies each whole 128x128 probability tile,
// zero slots included, with its x block on the TPU's matrix unit.
//
// Design: K4's row walk (attend_walk.cuh) with K5's settings. A warp takes
// one receiver row and one slab of its columns (attend_layout: whole heads,
// or one part of a head wider than a warp holds, the parts on the grid's
// second dimension as in K4); the row's stream starts at its tile slots
// (entry rem_row_ptr[r+1] - rem_row_ptr[r]), so the remainder, whose
// partials are the seeds, is skipped; batches of 32 slots, one lane per
// slot for the sender, the count and the dropout word (fill_edge), one lane
// per (slot, head) for p from the given m (no online max: m is given, so
// num and den need no rescale), then the senders' x rows gathered in
// 16-byte vectors, 2 to 4 edges in flight a lane. The accumulators start
// from the row's num_init slab (the first edge group's lanes) and den_init
// (the first lane of each head); a row above the host's threshold takes a
// CTA of its own (HybridGraph.long_rows, the remainder's edges counted with
// the tile slots: the set K4 splits, which holds every row long by its
// tile slots alone, so no second per-graph array is built), whose 8 warps
// each walk a share of the row's tile slots and add their partials in
// shared memory in warp order; the seeds go to warp 0.
//
// Bound: bytes, the x rows the slots name, f_src at the senders, f_dst and
// m at the receivers, the tiles' masks and nonzero values (or the dense
// store, if less), one lattice word per nonzero slot under dropout, the
// seeds read and out and den written once; one exp per (slot, head) and 2
// flops per (slot, column). What held its first design (K8-K10's lane
// groups, attend_parts_kernel.cu) back: it read every tile row's 128
// values and balloted on them (here the row masks give the slots); each
// slot was a chain of dependent loads run one at a time (here 32 slots'
// chains side by side); a row block's tiles on the row's one warp, the
// hub's 8 tiles on one warp each (here split rows); a head wider than 32
// columns a lane re-walked the row once per window on a warp of its own
// (here the walk's slabs and parts).
// No atomics; every sum in a fixed order: deterministic.

#include "attend_walk.cuh"

namespace gnn_attend {
namespace {

struct FusedArgs {
  const void* x;           // [n, hf] XT
  const float* fs;         // [n, heads]
  const float* fd;         // [n, heads]
  const float* m;          // [n, heads], given
  const void* tiles;       // [T, 128, 128] float or bf16
  const int* bits;         // [T, 128, 128] uint32 lattice, or null
  const int* col_ids;      // [T]
  const int* tile_off;     // [n_row_blocks]
  const int* tile_cnt;     // [n_row_blocks]
  const int* row_masks;    // [T, 128, 4]
  const int* rem_senders;  // fill_edge's remainder operands: never read,
  const float* rem_w;      //   the stream starts past the remainder
  const int* rem_row_ptr;  // [n + 1]: where a row's tile slots start
  const float* num_init;   // [n, hf]
  const float* den_init;   // [n, heads]
  const int* row_edges;    // [n] remainder edges plus tile slots a row
  const int* long_rows;    // [n_long]
  float* out;              // [n, hf]
  float* den;              // [n, heads]
  int n, heads, feat, tile_bf16, dropping;
  int vph, lpe, slab_heads, parts, n_long, long_edges;
  float slope, inv_keep;
  uint32_t thresh;
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

template <typename XT, int V, int NV>
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
  // the row's tile slots are its stream's entries [nr, len): this warp's
  // share of them
  int lo, hi;
  warp_range(split, len - rs.nr, warp, lo, hi);
  lo += rs.nr;
  if (split) hi += rs.nr;

  // this lane's head: f_dst, the given shift, its share of den (the seed
  // in the head's first lane of the row's warp, or of a long row's warp 0)
  const bool seeds = !split || warp == 0;
  const float fd = P.on ? a.fd[row * heads + hg] : 0.f;
  const float mr = P.on ? a.m[row * heads + hg] : 0.f;
  float den = seeds && P.on && P.jr == 0 ? a.den_init[row * heads + hg]
                                         : 0.f;
  // acc = num over this lane's columns, the seed in the first edge group
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
  for (int pos = lo; pos < hi && seek(rs, a.row_masks, pos, lane);) {
    const int end = min(min(pos + 32, hi), rs.base + rs.ch.total);
    const int nb = end - pos;
    fill_edge(ws.ed, a, batch_entry(rs, pos, end, lane), rs.ri, lane);
    __syncwarp();
    // the x rows of the group's first U slots load beside the pairs'
    // operands
    constexpr int U = edges_in_flight(NV * V);
    typename VecIO<XT, V>::Raw v[U][NV];
    gather_rows<XT, V, NV, U>(v, x, hf, ws.ed.node, L.grp, nb, L);
    // per (slot, head): p from the given shift, clamped; pn = p * keep
    const int rounds = (nb + P.epr - 1) / P.epr;   // at most kSlabHeads
#pragma unroll (NV == 1 ? 4 : kSlabHeads)
    for (int r = 0; r < kSlabHeads; ++r) {
      const int j = r * P.epr + P.jr;
      if (r < rounds && P.on && j < nb) {
        const float sc = leaky(
            fd + a.fs[static_cast<long long>(ws.ed.node[j]) * heads + hg],
            a.slope);
        const float p = ws.ed.w[j] * expf(fminf(sc - mr, 0.f));
        den += p;
        const float keep = !a.dropping ? 1.f
                           : head_keep(ws.ed.word[j], hg, a.thresh)
                               ? a.inv_keep
                               : 0.f;
        ws.pn[j * kPStride + P.h] = p * keep;
      }
    }
    __syncwarp();
    // per column, the whole warp: acc += pn * x_s, U slots at a time
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

template <typename XT, int V>
cudaError_t launch_nv(const FusedArgs& a, int nv, dim3 grid,
                      cudaStream_t stream) {
  const dim3 block(kWarps * 32);
  switch (nv) {
    case 1: attend_fused_kernel<XT, V, 1><<<grid, block, 0, stream>>>(a); break;
    case 2: attend_fused_kernel<XT, V, 2><<<grid, block, 0, stream>>>(a); break;
    case 4:
      if constexpr (V * 4 <= 16) {
        attend_fused_kernel<XT, V, 4><<<grid, block, 0, stream>>>(a);
        break;
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch(const FusedArgs& a, int vec, int nv, int n_slabs,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(XT);
  const dim3 grid(a.n_long + (a.n + kWarps - 1) / kWarps, n_slabs);
  if (vec == kVec) return launch_nv<XT, kVec>(a, nv, grid, stream);
  if (vec == 1) return launch_nv<XT, 1>(a, nv, grid, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace gnn_attend

// x_bf16 / tile_bf16: 0 = float32, 1 = bfloat16. The column layout, as
// K4's (ops/cuda/attend_common.py:attend_layout of x, num_init and out):
// vectors of `vec` elements of x (1, or 16 bytes), `nv` of them a lane,
// `lpe` lanes an edge, slabs of `slab_heads` heads or, with parts > 1, one
// head in `parts` slabs. row_edges and long_rows: HybridGraph's forward
// lengths (remainder plus tile slots) and its n_long rows above long_edges.
// bits is read only when dropping. Returns the launch's cudaError_t.
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
  if (n <= 0) return 0;
  if (!slab_ok(heads, feat, vec, nv, lpe, slab_heads, parts) ||
      (n_long > 0 && long_rows == nullptr) || row_edges == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  FusedArgs a{x,
              static_cast<const float*>(fs),
              static_cast<const float*>(fd),
              static_cast<const float*>(m),
              tiles,
              static_cast<const int*>(bits),
              static_cast<const int*>(col_ids),
              static_cast<const int*>(tile_off),
              static_cast<const int*>(tile_cnt),
              static_cast<const int*>(row_masks),
              nullptr,
              nullptr,
              static_cast<const int*>(rem_row_ptr),
              static_cast<const float*>(num_init),
              static_cast<const float*>(den_init),
              static_cast<const int*>(row_edges),
              static_cast<const int*>(long_rows),
              static_cast<float*>(out),
              static_cast<float*>(den),
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
