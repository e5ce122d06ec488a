// K5 and K6: the gradient of the hybrid GAT attend (K4), for Hopper
// (sm_90a).
//
// With the forward's den and exact shift m, gn = g / den (0 on empty rows)
// and dden = -sum_f(g * out) / den, computed by the caller, the cotangents
// of x, f_src and f_dst split into two passes that recompute
// p = w * exp(min(LeakyReLU(f_dst[r] + f_src[s]) - m[r], 0)) per edge:
//
//   pass A (K5), receiver rows, forward tiles and remainder:
//     q = gn[r,h,:] . x[s,h,:] * keep;  ds = p * (q + dden[r,h]) * leaky'
//     dfd[r,h] = sum_s ds
//   pass B (K6), sender rows, transpose tiles and sender-sorted remainder:
//     dx[s,h,:] = sum_r p * keep * gn[r,h,:];   dfs[s,h] = sum_r ds
//
// Both passes see the forward's dropout masks: pass A reads the forward
// lattice and keep_mul directly; pass B reads the lattice of the forward
// tile bits_tmap[t'] transposed (slot [j, i] for its slot [i, j]) and
// keep_mul[rem_t_eperm[e]], so no transposed copy is built.
// fdm3 [n, 3H] = [f_dst | m | dden] holds the receiver-side scalars.
//
// Pass A (K5) replaces _bwd_a_kernel of
// graphneuralnetwork_tpu/ops/pallas/attend_bwd_kernel.py (:68, pallas_call
// at :226). It keeps its first design: one warp owns one receiver row
// and walks its edges, each head's lane group reading its columns, q a sum
// over the group. Bound: bytes, once per edge two gathered [H*F] rows (x
// and gn) and once per tile its store and lattice.
//
// Pass B (K6) replaces _bwd_b_kernel of the same file (:251, pallas_call
// at :439), which contracts q and dx per 128-row block on the TPU's matrix
// unit. Here it walks the row stream of attend_walk.cuh, as K4 does: a
// warp takes a sender row and a slab of whole heads; one lane per edge
// loads the receiver, the weight and the dropout word; one lane per (edge,
// head) loads f_dst, m and dden at the receiver and computes p * keep and
// p * keep * leaky'; then the warp gathers the receivers' gn rows in
// 16-byte vectors. q never needs a
// per-edge reduction: dfs[s,h] = sum_r ds is linear in q, so each lane
// keeps sum_r p * keep * leaky' * (its part of gn_r . x_s) and the lanes
// of a head are summed once per row. Bound: bytes, the named gn rows, the
// row's own x row, fdm3 at the receivers, f_src at the senders, the masks
// and the tile values (or the dense store, if less), one lattice word per
// nonzero slot under dropout and its map, dx and dfs written once; one exp
// per (edge, head) and 4 flops per (edge, column). What held its first design
// back, and what this one does about it: it read every tile value and
// balloted on it (here the masks of hg.bcsr_t give the slots); each edge
// was a serial chain with a 5-shuffle group sum per edge (here 32 edges'
// chains run side by side and q needs no shuffle per edge); a lane kept
// own[32], oth[32] and acc[32] at 8x128 and spilled (here at most 16
// columns a lane, in vectors); its lattice reads were 32 rows 512 bytes
// apart per warp (here each lane reads the word of its own slot, one
// sector per nonzero slot either way, so no transposed copy is built); a
// row with many edges ran on one warp (here it takes a CTA, as in K4). A
// head wider than a warp holds splits into parts that the row's warp
// walks in turn (K4 puts them on the grid; K6's dfs needs every part's q
// shares, which one warp sums in order without atomics or a second pass).
// No atomics; every sum in a fixed order: deterministic.

#include "attend_walk.cuh"

namespace gnn_attend {
namespace {

struct BwdArgs {
  const void* x;           // [n, hf] XT
  const void* gn;          // [n, hf] XT
  const float* fs;         // [n, heads]
  const float* fdm3;       // [n, 3 * heads]
  const void* tiles;       // [T, 128, 128]
  const int* bits;         // forward lattice [T, 128, 128], or null
  const int* col_ids;      // [T]
  const int* tile_off;     // [n_row_blocks]
  const int* tile_cnt;     // [n_row_blocks]
  const int* rem_cols;     // [E_pad] the sender of each edge
  const int* rem_row_ptr;  // [n + 1]
  const float* rem_w;      // [E_pad]
  const float* keep_mul;   // [E_pad, heads], or null
  float* dhead;            // dfd [n, heads]
  int n, heads, feat, tile_bf16, dropping;
  float slope, inv_keep;
  uint32_t thresh;
};

// Pass A for one receiver row.
template <typename XT, int CPL>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    attend_bwd_a_kernel(BwdArgs a) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.n) return;   // uniform per warp
  const Lanes L = lane_layout(threadIdx.x & 31, a.heads);
  const int heads = a.heads, feat = a.feat, h = L.head;
  const long long hf = static_cast<long long>(heads) * feat;
  // head h's columns of x and gn
  const XT* x = static_cast<const XT*>(a.x) + h * feat;
  const XT* gn = static_cast<const XT*>(a.gn) + h * feat;

  // the receiver's own gn and f_dst/m/dden
  float own[CPL];
  const XT* own_row = gn + row * hf;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int f = L.sub + L.group * j;
    own[j] = L.active && f < feat ? to_float(own_row[f]) : 0.f;
  }
  const float* r3 = a.fdm3 + static_cast<long long>(row) * 3 * heads;
  const float fd = r3[h], m = r3[heads + h], dd = r3[2 * heads + h];
  float dhead = 0.f;

  // one edge between this row and node `col` with weight w and numerator
  // multiplier keep (1 without dropout)
  auto edge = [&](int col, float w, float keep) {
    const XT* other = x + col * hf;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int f = L.sub + L.group * j;
      part += own[j] * (L.active && f < feat ? to_float(other[f]) : 0.f);
    }
    const float q = group_sum(part, L.group);   // gn_r . x_s of head h
    const float pre = fd + a.fs[col * heads + h];
    const float p = w * expf(fminf(leaky(pre, a.slope) - m, 0.f));
    dhead += p * (q * keep + dd) * leaky_grad(pre, a.slope);
  };

  const int e0 = a.rem_row_ptr[row], e1 = a.rem_row_ptr[row + 1];
  for (int e = e0; e < e1; ++e) {
    const float keep = a.dropping ? a.keep_mul[static_cast<long long>(e) *
                                               heads + h]
                                  : 1.f;
    edge(a.rem_cols[e], a.rem_w[e], keep);
  }
  const int rb = row / kRowBlock, ri = row % kRowBlock;
  const int t0 = a.tile_off[rb], t1 = t0 + a.tile_cnt[rb];
  for (int t = t0; t < t1; ++t) {
    const int cb = a.col_ids[t];
    const long long base = (static_cast<long long>(t) * kRowBlock + ri) *
                           kColBlock;
#pragma unroll
    for (int q = 0; q < kColBlock / 32; ++q) {
      const int j = q * 32 + (threadIdx.x & 31);
      const float wv = tile_val(a.tiles, a.tile_bf16, base + j);
      const uint32_t bv = a.dropping && wv != 0.f
                              ? static_cast<uint32_t>(a.bits[base + j])
                              : 0u;
      unsigned nz = __ballot_sync(kFull, wv != 0.f);
      while (nz) {
        const int l = __ffs(nz) - 1;
        nz &= nz - 1;
        const float w = __shfl_sync(kFull, wv, l);
        const uint32_t b = __shfl_sync(kFull, bv, l);
        const float keep = !a.dropping ? 1.f
                           : head_keep(b, h, a.thresh) ? a.inv_keep
                                                       : 0.f;
        edge(cb * kColBlock + q * 32 + l, w, keep);
      }
    }
  }

  if (L.active && L.sub == 0) a.dhead[row * heads + h] = dhead;
}

template <typename XT>
cudaError_t launch_a(const BwdArgs& a, int cpl, cudaStream_t stream) {
  const dim3 grid((a.n + kWarps - 1) / kWarps), block(kWarps * 32);
  switch (cpl) {
    case 1: attend_bwd_a_kernel<XT, 1><<<grid, block, 0, stream>>>(a); break;
    case 2: attend_bwd_a_kernel<XT, 2><<<grid, block, 0, stream>>>(a); break;
    case 4: attend_bwd_a_kernel<XT, 4><<<grid, block, 0, stream>>>(a); break;
    case 8: attend_bwd_a_kernel<XT, 8><<<grid, block, 0, stream>>>(a); break;
    case 16: attend_bwd_a_kernel<XT, 16><<<grid, block, 0, stream>>>(a); break;
    case 32: attend_bwd_a_kernel<XT, 32><<<grid, block, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

struct BwdBArgs {
  const void* x;           // [n, hf] XT
  const void* gn;          // [n, hf] XT
  const float* fs;         // [n, heads]
  const float* fdm3;       // [n, 3 * heads]
  const void* tiles;       // [T', 128, 128] transpose tiles
  const int* bits;         // forward lattice [T, 128, 128], or null
  const int* bits_tmap;    // [T'] forward tile of each transpose tile
  const int* col_ids;      // [T']
  const int* tile_off;     // [n_row_blocks]
  const int* tile_cnt;     // [n_row_blocks]
  const int* row_masks;    // [T', 128, 4]
  const int* rem_cols;     // [E_pad] the receiver of each edge
  const int* rem_row_ptr;  // [n + 1] over senders
  const float* rem_w;      // [E_pad]
  const int* rem_eperm;    // [E_pad] keep_mul row of each edge
  const float* keep_mul;   // [E_pad_fwd, heads], or null
  const int* row_edges;    // [n] edges of each sender row
  const int* long_rows;    // [n_long]
  void* dx;                // [n, hf] XT
  float* dfs;              // [n, heads]
  int n, heads, feat, tile_bf16, dropping;
  int vph, lpe, slab_heads, parts, n_long, long_edges;
  float slope, inv_keep;
  uint32_t thresh;
};

// A warp's scratch for one batch: its edges, each (edge, head)'s p * keep
// and p * keep * leaky'; at the end, each lane's q shares and their heads.
struct BScratch {
  EdgeScratch ed;
  float pn[32 * kPStride];
  float pa[32 * kPStride];
  float red[32 * 4];
  int red_head[32 * 4];
};

// A long row's per-warp partials.
struct BSplit {
  float dfs[kWarps][kSlabHeads];
  float acc[kWarps][kMaxSlabCols];
};

// Pass B for one sender row and one slab of whole heads, or (kParts,
// a.parts > 1) one head, whose parts the warp walks in turn: each part
// writes its columns of dx, and dfs sums the parts' q shares in part
// order. kParts is a template switch so that the one-part walk keeps its
// registers.
template <typename XT, int V, int NV, bool kParts>
__global__ void __launch_bounds__(kWarps * 32, NV == 1 ? 4 : kMinBlocks)
    attend_bwd_b_kernel(BwdBArgs a) {
  __shared__ union {
    BScratch w[kWarps];
    BSplit s;
  } sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool split = blockIdx.x < a.n_long;
  const int row = split ? a.long_rows[blockIdx.x]
                        : (blockIdx.x - a.n_long) * kWarps + warp;
  if (!split && row >= a.n) return;   // uniform per warp
  // the row's length, loaded beside the walk's first loads: a long row
  // has a CTA of its own
  const int len = split || a.n_long > 0 ? a.row_edges[row] : 0;
  const int parts = kParts ? a.parts : 1;
  const int heads = a.heads, hf = heads * a.feat;
  // the first slab: its heads are every part's
  const Slab S0 = slab_of(blockIdx.y * parts, heads, a.vph, a.slab_heads,
                          parts);
  const PairLanes P = pair_lanes(S0.hs, lane);
  const XT* x = static_cast<const XT*>(a.x);
  const XT* gn = static_cast<const XT*>(a.gn);
  BScratch& ws = sh.w[warp];
  float dfs_row = 0.f;   // this lane's head's dfs over the parts so far

  for (int part = 0; part < parts; ++part) {
    const Slab S = slab_of(blockIdx.y * parts + part, heads, a.vph,
                           a.slab_heads, parts);
    const ColLanes<NV> L = col_lanes<NV>(S, lane, a.lpe, a.vph, V);
    const int hg = S.h0 + P.h;
    RowStream rs = row_stream(a.tile_off, a.tile_cnt, a.rem_row_ptr,
                              a.row_masks, row, lane);
    if (!split && a.n_long > 0 && len > a.long_edges) return;
    int lo, hi;
    warp_range(split, len, warp, lo, hi);
    // the row's own x, packed until used
    typename VecIO<XT, V>::Raw xo[NV];
    float acc[NV][V], tq[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      xo[k] = L.on[k] ? VecIO<XT, V>::load(
                            x + static_cast<long long>(row) * hf + L.col[k])
                      : typename VecIO<XT, V>::Raw{};
#pragma unroll
      for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
      tq[k] = 0.f;
    }
    // this lane's head: f_src of the row, its share of sum p * leaky' * dden
    const float fs = P.on ? a.fs[row * heads + hg] : 0.f;
    float bsum = 0.f;

    for (int pos = lo; pos < hi && seek(rs, a.row_masks, pos, lane);) {
      const int end = min(min(pos + 32, hi), rs.base + rs.ch.total);
      const int nb = end - pos;
      // per edge, one lane: receiver, weight, dropout word
      const Entry en = batch_entry(rs, pos, end, lane);
      if (en.valid) {
        int rcv, ke = -1;
        float w;
        uint32_t word = 0u;
        if (en.rem) {
          rcv = a.rem_cols[en.e];
          w = a.rem_w[en.e];
          if (a.dropping) ke = a.rem_eperm[en.e];
        } else {
          const long long slot =
              (static_cast<long long>(en.t) * kRowBlock + rs.ri) * kColBlock +
              en.col;
          rcv = a.col_ids[en.t] * kColBlock + en.col;
          w = tile_val(a.tiles, a.tile_bf16, slot);
          if (a.dropping)   // the forward tile's slot [col, ri]
            word = static_cast<uint32_t>(
                a.bits[(static_cast<long long>(a.bits_tmap[en.t]) * kRowBlock +
                        en.col) * kColBlock + rs.ri]);
        }
        ws.ed.node[lane] = rcv;
        ws.ed.w[lane] = w;
        ws.ed.word[lane] = word;
        ws.ed.e[lane] = en.rem ? ke : -1;
      }
      __syncwarp();

      // the gn rows of the group's first U edges load beside the pairs'
      // operands
      constexpr int U = edges_in_flight(NV * V);
      typename VecIO<XT, V>::Raw v[U][NV];
      gather_rows<XT, V, NV, U>(v, gn, hf, ws.ed.node, L.grp, nb, L);
      // per (edge, head): p, p * keep and p * keep * leaky'
      const int rounds = (nb + P.epr - 1) / P.epr;   // at most kSlabHeads
#pragma unroll (NV == 1 ? 2 : 4)
      for (int r = 0; r < kSlabHeads; ++r) {
        const int j = r * P.epr + P.jr;
        if (r < rounds && P.on && j < nb) {
          const float* r3 =
              a.fdm3 + static_cast<long long>(ws.ed.node[j]) * 3 * heads + hg;
          const float pre = fs + r3[0];
          const float p = ws.ed.w[j] *
                          expf(fminf(leaky(pre, a.slope) - r3[heads], 0.f));
          const float lg = leaky_grad(pre, a.slope);
          float keep = 1.f;
          if (a.dropping) {
            const int e = ws.ed.e[j];
            keep = e >= 0 ? a.keep_mul[static_cast<long long>(e) * heads + hg]
                   : head_keep(ws.ed.word[j], hg, a.thresh) ? a.inv_keep
                                                            : 0.f;
          }
          ws.pn[j * kPStride + P.h] = p * keep;
          ws.pa[j * kPStride + P.h] = p * keep * lg;
          bsum += p * lg * r3[2 * heads];
        }
      }
      __syncwarp();

      // per column, the whole warp: accumulate dx and q, U edges at a time
      for (int j = L.grp;;) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int jj = j + u * L.ngrp;
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const bool ok = jj < nb && L.on[k];
            const float pw = ok ? ws.pn[jj * kPStride + L.hk[k]] : 0.f;
            const float pq = ok ? ws.pa[jj * kPStride + L.hk[k]] : 0.f;
            float f[V], own[V], dot = 0.f;
            VecIO<XT, V>::unpack(v[u][k], f);
            VecIO<XT, V>::unpack(xo[k], own);
#pragma unroll
            for (int i = 0; i < V; ++i) {
              acc[k][i] += pw * f[i];
              dot += f[i] * own[i];
            }
            tq[k] += pq * dot;
          }
        }
        j += L.ngrp * U;
        if (j >= nb) break;
        gather_rows<XT, V, NV, U>(v, gn, hf, ws.ed.node, j, nb, L);
      }
      __syncwarp();
      pos = end;
    }

    // dfs: the q shares of every lane's vectors of this lane's head (and,
    // once, the dden term), then the sum over the head's lanes; dx: the sum
    // over the edge groups
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      ws.red[lane * NV + k] = tq[k];
      ws.red_head[lane * NV + k] = L.on[k] ? L.hk[k] : -1;
    }
    __syncwarp();
    float dfs = S.first ? bsum : 0.f;
    if (P.on)
      for (int i = P.jr; i < 32 * NV; i += P.epr)
        if (ws.red_head[i] == P.h) dfs += ws.red[i];
    dfs = head_sum(dfs, P);
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[k][i] = group_combine(acc[k][i], a.lpe);

    if (split) {   // combine the warps' partials in warp order
      __syncthreads();   // the batch scratch is no longer read
      BSplit& sp = sh.s;
      if (P.on && P.jr == 0) sp.dfs[warp][P.h] = dfs;
      if (L.grp == 0)
#pragma unroll
        for (int k = 0; k < NV; ++k)
#pragma unroll
          for (int i = 0; i < V; ++i)
            sp.acc[warp][(L.sub + a.lpe * k) * V + i] = acc[k][i];
      __syncthreads();
      if (warp == 0) {
        if (P.on) {
          dfs = 0.f;
          for (int q = 0; q < kWarps; ++q) dfs += sp.dfs[q][P.h];
        }
#pragma unroll
        for (int k = 0; k < NV; ++k)
#pragma unroll
          for (int i = 0; i < V; ++i) {
            acc[k][i] = 0.f;
            for (int q = 0; q < kWarps; ++q)
              acc[k][i] += sp.acc[q][(L.sub + a.lpe * k) * V + i];
          }
      }
      if (part + 1 < parts)
        __syncthreads();   // sp is read before the next part's scratch
    }

    dfs_row += dfs;
    if ((!split || warp == 0) && L.grp == 0) {
      XT* dx = static_cast<XT*>(a.dx) + static_cast<long long>(row) * hf;
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (L.on[k]) VecIO<XT, V>::store(dx + L.col[k], acc[k]);
    }
  }

  if ((!split || warp == 0) && P.on && P.jr == 0)
    a.dfs[row * heads + S0.h0 + P.h] = dfs_row;
}

// A head splits into parts only where a lane holds the most it can
// (attend_common.attend_layout): nv * V == 16, or four scalars.
template <typename XT, int V, int NV>
cudaError_t launch_b_one(const BwdBArgs& a, dim3 grid, cudaStream_t stream) {
  const dim3 block(kWarps * 32);
  if (a.parts == 1)
    attend_bwd_b_kernel<XT, V, NV, false><<<grid, block, 0, stream>>>(a);
  else if constexpr (NV * V == 16 || (V == 1 && NV == 4))
    attend_bwd_b_kernel<XT, V, NV, true><<<grid, block, 0, stream>>>(a);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename XT, int V>
cudaError_t launch_b_nv(const BwdBArgs& a, int nv, dim3 grid,
                        cudaStream_t stream) {
  switch (nv) {
    case 1: return launch_b_one<XT, V, 1>(a, grid, stream);
    case 2: return launch_b_one<XT, V, 2>(a, grid, stream);
    case 4:
      if constexpr (V * 4 <= 16) return launch_b_one<XT, V, 4>(a, grid, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t launch_b(const BwdBArgs& a, int vec, int nv, int n_slabs,
                     cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(XT);
  const dim3 grid(a.n_long + (a.n + kWarps - 1) / kWarps, n_slabs);
  if (vec == kVec) return launch_b_nv<XT, kVec>(a, nv, grid, stream);
  if (vec == 1) return launch_b_nv<XT, 1>(a, nv, grid, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace gnn_attend

// Pass A: dfd [n, heads] over the forward tiles and the receiver-sorted
// remainder (rem_senders, rem_row_ptr, rem_w). x_bf16 / tile_bf16: 0 =
// float32, 1 = bfloat16; cpl: columns per lane, one of 1, 2, 4, 8, 16, 32,
// with cpl * (32 / heads rounded up to a power of two) >= feat. Returns
// the launch's cudaError_t.
extern "C" int gnn_attend_bwd_a(
    const void* x, const void* gn, const void* fs, const void* fdm3,
    const void* tiles, const void* bits, const void* col_ids,
    const void* tile_off, const void* tile_cnt, const void* rem_senders,
    const void* rem_row_ptr, const void* rem_w, const void* keep_mul,
    void* dfd, int n, int heads, int feat, int x_bf16, int tile_bf16,
    int cpl, float slope, float inv_keep, unsigned thresh, int dropping,
    void* stream) {
  using namespace gnn_attend;
  if (n <= 0) return 0;
  if (!layout_ok(heads, feat, cpl))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{x, gn,
            static_cast<const float*>(fs),
            static_cast<const float*>(fdm3),
            tiles,
            static_cast<const int*>(bits),
            static_cast<const int*>(col_ids),
            static_cast<const int*>(tile_off),
            static_cast<const int*>(tile_cnt),
            static_cast<const int*>(rem_senders),
            static_cast<const int*>(rem_row_ptr),
            static_cast<const float*>(rem_w),
            static_cast<const float*>(keep_mul),
            static_cast<float*>(dfd),
            n, heads, feat, tile_bf16, dropping, slope, inv_keep, thresh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(x_bf16 ? launch_a<__nv_bfloat16>(a, cpl, s)
                                 : launch_a<float>(a, cpl, s));
}

// Pass B: dx [n, heads*feat] (x's type) and dfs [n, heads] over the
// transpose tiles (tiles_t, col_ids_t, tile_off_t, tile_cnt_t, their
// row_masks_t) and the sender-sorted remainder (remt_receivers: each
// edge's receiver, remt_row_ptr over senders, remt_w, remt_eperm). bits is
// the FORWARD lattice, read through bits_tmap; keep_mul the forward
// multiplier, read through remt_eperm. The column layout (vec, nv, lpe,
// slab_heads, parts) is gnn_attend_online's; the grid takes the slabs of
// whole heads, or with parts > 1 the heads, whose parts each warp walks
// in turn. row_edges: each sender row's edges; long_rows: the n_long
// sender rows with more than long_edges of them.
extern "C" int gnn_attend_bwd_b(
    const void* x, const void* gn, const void* fs, const void* fdm3,
    const void* tiles_t, const void* bits, const void* bits_tmap,
    const void* col_ids_t, const void* tile_off_t, const void* tile_cnt_t,
    const void* row_masks_t, const void* remt_receivers,
    const void* remt_row_ptr, const void* remt_w, const void* remt_eperm,
    const void* keep_mul, const void* row_edges, const void* long_rows,
    void* dx, void* dfs, int n, int heads, int feat, int x_bf16,
    int tile_bf16, int vec, int nv, int lpe, int slab_heads, int parts,
    int n_long, int long_edges, float slope, float inv_keep,
    unsigned thresh, int dropping, void* stream) {
  using namespace gnn_attend;
  if (n <= 0) return 0;
  if (!slab_ok(heads, feat, vec, nv, lpe, slab_heads, parts) ||
      (n_long > 0 && (long_rows == nullptr || row_edges == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdBArgs a{x, gn,
             static_cast<const float*>(fs),
             static_cast<const float*>(fdm3),
             tiles_t,
             static_cast<const int*>(bits),
             static_cast<const int*>(bits_tmap),
             static_cast<const int*>(col_ids_t),
             static_cast<const int*>(tile_off_t),
             static_cast<const int*>(tile_cnt_t),
             static_cast<const int*>(row_masks_t),
             static_cast<const int*>(remt_receivers),
             static_cast<const int*>(remt_row_ptr),
             static_cast<const float*>(remt_w),
             static_cast<const int*>(remt_eperm),
             static_cast<const float*>(keep_mul),
             static_cast<const int*>(row_edges),
             static_cast<const int*>(long_rows),
             dx,
             static_cast<float*>(dfs),
             n, heads, feat, tile_bf16, dropping,
             feat / vec, lpe, slab_heads, parts, n_long, long_edges,
             slope, inv_keep, thresh};
  const int n_slabs = parts > 1 ? heads
                                : (heads + slab_heads - 1) / slab_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(x_bf16
                              ? launch_b<__nv_bfloat16>(a, vec, nv, n_slabs, s)
                              : launch_b<float>(a, vec, nv, n_slabs, s));
}
