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
// at :226), which puts a head's whole width in one VMEM block per 128-row
// block. Here it walks the row stream of attend_walk.cuh, as K4 does: a
// warp takes a receiver row and a slab of whole heads; one lane per edge
// loads the sender, the weight and the dropout word (fill_edge, K4's); one
// lane per (edge, head) loads f_src at the sender and computes p, leaky'
// and keep against the row's own f_dst, m and dden (loaded once); then
// the warp gathers the senders' x rows in 16-byte vectors. dfd is linear
// in x_s:
//   dfd[r,h] = dden[r,h] * sum_s p * leaky'
//              + gn[r,h,:] . (sum_s p * keep * leaky' * x[s,h,:])
// so each lane accumulates the second sum over its columns (K4's numerator
// with the weights pa = p * keep * leaky' and no rescale: m is given), dots
// it with the row's own gn once at the end of the row, and the lanes of a
// head add their shares once (tagged by head, as K6's q shares). Bound:
// bytes, the named x rows, the row's own gn row, fdm3 at the receivers,
// f_src at the senders, the masks and the tile values (or the dense store,
// if less), one lattice word per nonzero slot under dropout, dfd written
// once; one exp per (edge, head) and 2 flops per (edge, column). What held
// its first design back, and what this one does about it: it read every
// tile value and balloted on it (here the masks of hg.bcsr give the
// slots); each edge was a serial chain ending in a 5-shuffle group sum
// (here 32 edges' chains run side by side and no edge needs a shuffle); a
// lane held own[32] and read 32 scalars per edge at 8x128 (here at most 16
// columns a lane, in vectors); a hub row ran on one warp (here a row above
// the host's threshold takes a CTA of its own, whose warps' dfd partials
// add in warp order). A head wider than a warp holds splits into parts:
// the row's warp walks the row once and each batch part by part, dotting
// each part's sums with the row's own gn of that part at once, since dfd
// needs every part's shares. Each part gathers the batch's edges again, so
// a head of scalars takes up to eight a lane (K4 and K6 four) before it
// splits: up to 256 columns in one part.
//
// Pass B (K6) replaces _bwd_b_kernel of the same file (:251, pallas_call
// at :439), which contracts q and dx per 128-row block on the TPU's matrix
// unit. Here it walks the row stream of attend_walk.cuh too: a
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
// walks in turn (K4 puts them on the grid; K5's dfd and K6's dfs need every
// part's shares, which one warp sums in order without atomics or a second
// pass).
// No atomics; every sum in a fixed order: deterministic.

#include "attend_walk.cuh"

namespace gnn_attend {
namespace {

struct BwdAArgs {
  const void* x;           // [n, hf] XT
  const void* gn;          // [n, hf] XT
  const float* fs;         // [n, heads]
  const float* fdm3;       // [n, 3 * heads]
  const void* tiles;       // [T, 128, 128] forward tiles
  const int* bits;         // forward lattice [T, 128, 128], or null
  const int* col_ids;      // [T]
  const int* tile_off;     // [n_row_blocks]
  const int* tile_cnt;     // [n_row_blocks]
  const int* row_masks;    // [T, 128, 4]
  const int* rem_senders;  // [E_pad] receiver-sorted remainder
  const int* rem_row_ptr;  // [n + 1]
  const float* rem_w;      // [E_pad]
  const float* keep_mul;   // [E_pad, heads], or null
  const int* row_edges;    // [n] edges of each receiver row
  const int* long_rows;    // [n_long]
  float* dfd;              // [n, heads]
  int n, heads, feat, tile_bf16, dropping;
  int vph, lpe, slab_heads, parts, n_long, long_edges;
  float slope, inv_keep;
  uint32_t thresh;
};

// gn_r . acc over one vector (own: the row's gn there, packed).
template <typename XT, int V>
__device__ __forceinline__ float row_dot(const float (&acc)[V],
                                         typename VecIO<XT, V>::Raw own) {
  float g[V], t = 0.f;
  VecIO<XT, V>::unpack(own, g);
#pragma unroll
  for (int i = 0; i < V; ++i) t += acc[i] * g[i];
  return t;
}

// A warp's scratch for one batch: its edges and each (edge, head)'s
// p * keep * leaky'; at the end of the row, each lane's shares of
// gn_r . sum_s pa * x_s and their heads (NV of them, at least room for 4).
template <int NV>
struct AScratch {
  EdgeScratch ed;
  float pa[32 * kPStride];
  float red[32 * (NV > 4 ? NV : 4)];
  int red_head[32 * (NV > 4 ? NV : 4)];
};

// Pass A for one receiver row and one slab of whole heads, or (kParts,
// a.parts > 1) one head in parts: the warp walks the row once, and each
// batch's edges part by part, each part's gathered columns dotted with the
// row's own gn of that part at once (dfd needs every part's shares).
// kParts is a template switch so that the one-part walk keeps its
// registers: there acc runs over the whole row and is dotted once.
template <typename XT, int V, int NV, bool kParts>
__global__ void __launch_bounds__(kWarps * 32, NV == 1 ? 4 : kMinBlocks)
    attend_bwd_a_kernel(BwdAArgs a) {
  __shared__ AScratch<NV> sh[kWarps];
  __shared__ float split_dfd[kWarps][kSlabHeads];   // a long row's partials
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
  // the slab, or the first part: its heads are every part's
  const Slab S = slab_of(blockIdx.y * parts, heads, a.vph, a.slab_heads,
                         parts);
  const ColLanes<NV> L0 = col_lanes<NV>(S, lane, a.lpe, a.vph, V);
  const PairLanes P = pair_lanes(S.hs, lane);
  const int hg = S.h0 + P.h;
  const XT* x = static_cast<const XT*>(a.x);
  const XT* gn = static_cast<const XT*>(a.gn) + static_cast<long long>(row) *
                                                    hf;
  AScratch<NV>& ws = sh[warp];
  RowStream rs = row_stream(a.tile_off, a.tile_cnt, a.rem_row_ptr,
                            a.row_masks, row, lane);
  if (!split && a.n_long > 0 && len > a.long_edges) return;
  int lo, hi;
  warp_range(split, len, warp, lo, hi);
  // this lane's head: the row's own f_dst and m (dden is read at the end)
  const long long r3 = static_cast<long long>(row) * 3 * heads + hg;
  const float fd = P.on ? a.fdm3[r3] : 0.f;
  const float m = P.on ? a.fdm3[r3 + heads] : 0.f;
  // the row's own gn (kParts: the part's, reloaded per part), packed until
  // used; acc = sum_s pa * x_s over this lane's columns
  typename VecIO<XT, V>::Raw go[NV];
  float acc[NV][V];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    go[k] = L0.on[k] ? VecIO<XT, V>::load(gn + L0.col[k])
                     : typename VecIO<XT, V>::Raw{};
#pragma unroll
    for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
  }
  float plg = 0.f;    // this lane's share of sum_s p * leaky'
  float tpart = 0.f;  // kParts: its shares of gn_r . acc, over the parts

  for (int pos = lo; pos < hi && seek(rs, a.row_masks, pos, lane);) {
    const int end = min(min(pos + 32, hi), rs.base + rs.ch.total);
    const int nb = end - pos;
    fill_edge(ws.ed, a, batch_entry(rs, pos, end, lane), rs.ri, lane);
    __syncwarp();
    // the x rows of the group's first U edges load beside the pairs'
    // operands
    constexpr int U = edges_in_flight(NV * V);
    typename VecIO<XT, V>::Raw v[U][NV];
    gather_rows<XT, V, NV, U>(v, x, hf, ws.ed.node, L0.grp, nb, L0);
    // per (edge, head): p, leaky' and keep; pa = p * keep * leaky'
    const int rounds = (nb + P.epr - 1) / P.epr;   // at most kSlabHeads
#pragma unroll (NV == 1 ? 2 : 4)
    for (int r = 0; r < kSlabHeads; ++r) {
      const int j = r * P.epr + P.jr;
      if (r < rounds && P.on && j < nb) {
        const float pre =
            fd + a.fs[static_cast<long long>(ws.ed.node[j]) * heads + hg];
        const float p = ws.ed.w[j] *
                        expf(fminf(leaky(pre, a.slope) - m, 0.f));
        const float lg = leaky_grad(pre, a.slope);
        float keep = 1.f;
        if (a.dropping) {
          const int e = ws.ed.e[j];
          keep = e >= 0 ? a.keep_mul[static_cast<long long>(e) * heads + hg]
                 : head_keep(ws.ed.word[j], hg, a.thresh) ? a.inv_keep
                                                          : 0.f;
        }
        ws.pa[j * kPStride + P.h] = p * keep * lg;
        plg += p * lg;
      }
    }
    __syncwarp();

    for (int part = 0; part < parts; ++part) {
      ColLanes<NV> L = L0;
      if (kParts) {   // this part's columns, own gn and first gathers
        if (part > 0) {
          L = col_lanes<NV>(slab_of(blockIdx.y * parts + part, heads, a.vph,
                                    a.slab_heads, parts),
                            lane, a.lpe, a.vph, V);
          gather_rows<XT, V, NV, U>(v, x, hf, ws.ed.node, L.grp, nb, L);
        }
#pragma unroll
        for (int k = 0; k < NV; ++k)
          go[k] = L.on[k] ? VecIO<XT, V>::load(gn + L.col[k])
                          : typename VecIO<XT, V>::Raw{};
      }
      // per column, the whole warp: acc += pa * x_s, U edges at a time
      for (int j = L.grp;;) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int jj = j + u * L.ngrp;
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const float pw =
                jj < nb && L.on[k] ? ws.pa[jj * kPStride + L.hk[k]] : 0.f;
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
      if (kParts) {   // the part's shares, and acc back to zero
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          tpart += row_dot<XT, V>(acc[k], go[k]);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
        }
      }
    }
    __syncwarp();
    pos = end;
  }

  // per head: the shares gn_r . acc of the head's lanes, tagged by head (a
  // vector outside the slab holds a zero share; kParts: one head), and the
  // dden term
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    ws.red[lane * NV + k] = kParts ? (k == 0 ? tpart : 0.f)
                                   : row_dot<XT, V>(acc[k], go[k]);
    ws.red_head[lane * NV + k] = L0.hk[k];
  }
  __syncwarp();
  float dfd = P.on ? plg * a.fdm3[r3 + 2 * heads] : 0.f;
  if (P.on)
    for (int i = P.jr; i < 32 * NV; i += P.epr)
      if (ws.red_head[i] == P.h) dfd += ws.red[i];
  dfd = head_sum(dfd, P);

  if (split) {   // combine the warps' partials in warp order
    if (P.on && P.jr == 0) split_dfd[warp][P.h] = dfd;
    __syncthreads();
    if (warp != 0) return;
    dfd = 0.f;
    if (P.on)
      for (int q = 0; q < kWarps; ++q) dfd += split_dfd[q][P.h];
  }
  if (P.on && P.jr == 0) a.dfd[row * heads + hg] = dfd;
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

// Each pass's kernel instances, for the launch helpers below: kScalars is
// the most scalars a lane holds (attend_common.attend_layout; K5's
// WIDE_SCALARS_PER_LANE), which a head of scalars split into parts takes.
struct PassA {
  using Args = BwdAArgs;
  static constexpr int kScalars = 8;
  template <typename XT, int V, int NV, bool kParts>
  static void run(const Args& a, dim3 grid, cudaStream_t stream) {
    attend_bwd_a_kernel<XT, V, NV, kParts>
        <<<grid, kWarps * 32, 0, stream>>>(a);
  }
};

struct PassB {
  using Args = BwdBArgs;
  static constexpr int kScalars = 4;
  template <typename XT, int V, int NV, bool kParts>
  static void run(const Args& a, dim3 grid, cudaStream_t stream) {
    attend_bwd_b_kernel<XT, V, NV, kParts>
        <<<grid, kWarps * 32, 0, stream>>>(a);
  }
};

// A head splits into parts only where a lane holds the most it can
// (attend_common.attend_layout): nv * V == 16, or Pass::kScalars scalars.
template <typename Pass, typename XT, int V, int NV>
cudaError_t launch_one(const typename Pass::Args& a, dim3 grid,
                       cudaStream_t stream) {
  if (a.parts == 1)
    Pass::template run<XT, V, NV, false>(a, grid, stream);
  else if constexpr (NV * V == 16 || (V == 1 && NV == Pass::kScalars))
    Pass::template run<XT, V, NV, true>(a, grid, stream);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename Pass, typename XT, int V>
cudaError_t launch_nv(const typename Pass::Args& a, int nv, dim3 grid,
                      cudaStream_t stream) {
  switch (nv) {
    case 1: return launch_one<Pass, XT, V, 1>(a, grid, stream);
    case 2: return launch_one<Pass, XT, V, 2>(a, grid, stream);
    case 4:
      if constexpr (V * 4 <= 16)
        return launch_one<Pass, XT, V, 4>(a, grid, stream);
      return cudaErrorInvalidValue;
    case 8:
      if constexpr (V == 1 && Pass::kScalars == 8)
        return launch_one<Pass, XT, V, 8>(a, grid, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename Pass, typename XT>
cudaError_t launch(const typename Pass::Args& a, int vec, int nv,
                   int n_slabs, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(XT);
  const dim3 grid(a.n_long + (a.n + kWarps - 1) / kWarps, n_slabs);
  if (vec == kVec) return launch_nv<Pass, XT, kVec>(a, nv, grid, stream);
  if (vec == 1) return launch_nv<Pass, XT, 1>(a, nv, grid, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace gnn_attend

// Pass A: dfd [n, heads] over the forward tiles (their row_masks) and the
// receiver-sorted remainder (rem_senders, rem_row_ptr, rem_w). x_bf16 /
// tile_bf16: 0 = float32, 1 = bfloat16. The column layout (vec, nv, lpe,
// slab_heads, parts) is gnn_attend_online's; the grid takes the slabs of
// whole heads, or with parts > 1 the heads, whose parts each warp walks in
// turn. row_edges: each receiver row's edges; long_rows: the n_long
// receiver rows with more than long_edges of them (both from HybridGraph,
// forward side). bits and keep_mul are read only when dropping. Returns
// the launch's cudaError_t.
extern "C" int gnn_attend_bwd_a(
    const void* x, const void* gn, const void* fs, const void* fdm3,
    const void* tiles, const void* bits, const void* col_ids,
    const void* tile_off, const void* tile_cnt, const void* row_masks,
    const void* rem_senders, const void* rem_row_ptr, const void* rem_w,
    const void* keep_mul, const void* row_edges, const void* long_rows,
    void* dfd, int n, int heads, int feat, int x_bf16, int tile_bf16,
    int vec, int nv, int lpe, int slab_heads, int parts, int n_long,
    int long_edges, float slope, float inv_keep, unsigned thresh,
    int dropping, void* stream) {
  using namespace gnn_attend;
  if (n <= 0) return 0;
  if (!slab_ok(heads, feat, vec, nv, lpe, slab_heads, parts) ||
      (n_long > 0 && (long_rows == nullptr || row_edges == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdAArgs a{x, gn,
             static_cast<const float*>(fs),
             static_cast<const float*>(fdm3),
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
             static_cast<float*>(dfd),
             n, heads, feat, tile_bf16, dropping,
             feat / vec, lpe, slab_heads, parts, n_long, long_edges,
             slope, inv_keep, thresh};
  const int n_slabs = parts > 1 ? heads
                                : (heads + slab_heads - 1) / slab_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_bf16 ? launch<PassA, __nv_bfloat16>(a, vec, nv, n_slabs, s)
             : launch<PassA, float>(a, vec, nv, n_slabs, s));
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
  return static_cast<int>(
      x_bf16 ? launch<PassB, __nv_bfloat16>(a, vec, nv, n_slabs, s)
             : launch<PassB, float>(a, vec, nv, n_slabs, s));
}
