// The row walk of the redesigned hybrid attend kernels K4
// (attend_online_kernel.cu), K5 and K6 (passes A and B of
// attend_bwd_kernel.cu) and K8, K9 and K10 (the three modes of
// attend_fused_kernel.cu, each over one part of the row's stream), for
// Hopper (sm_90a).
//
// A work item is one row of the hybrid layout (K4 and K5: a receiver row of
// the forward tiles and the receiver-sorted remainder; K6: a sender row of
// the transpose tiles and the sender-sorted remainder) times one slab of
// its columns. The host picks the slab (ops/cuda/attend_common.py:
// attend_layout): whole heads, at most kSlabHeads of them and at most 16
// columns a lane, or one part of a head wider than a warp holds (K4 takes
// the parts on the grid, K5 and K6 in turn on one warp).
// The row's edges form one stream: its remainder edges, then the nonzero
// slots of its tile rows, tile by tile, columns ascending. A warp takes the
// stream 32 entries at a time, in three steps:
//   * per edge, one lane: the lane loads its edge's other endpoint, weight
//     and dropout word into the warp's scratch in shared memory. Slots come
//     from the tile rows' 128-bit masks (BCSRGraph.row_masks), kChunkTiles
//     tiles at a time, one 32-bit word a lane: a popcount prefix over the
//     lanes and a binary search by shuffles give each lane its slot, so no
//     tile value is read at an empty slot;
//   * per (edge, head), one lane (PairLanes: 32 / hp edges of hp heads a
//     round): the per-head scalars (scores, softmax weights, dropout), left
//     in the scratch; a reduction over a head's lanes is log2(32 / hp)
//     shuffles;
//   * per column, the whole warp: 32 / lpe edges at a time, each by lpe
//     lanes, every lane reading nv vectors of V elements (16 bytes where
//     the rows allow), so that a group's loads cover whole 32-byte sectors
//     of the gathered row, and several edges' loads are in flight; the
//     group's first loads go out before the per-(edge, head) step, beside
//     its own loads.
// A row with more edges than the host's threshold is split over the
// kWarps warps of a CTA of its own (HybridGraph.long_rows); their partials
// combine in shared memory in warp order. Which rows are long, and how
// long, the kernels read from HybridGraph.row_edges, the one source of
// that rule: a non-split warp leaves a long row to its CTA. Every sum runs in a fixed order,
// with no atomics: the result is deterministic.

#pragma once

#include "attend_common.cuh"

namespace gnn_attend {

constexpr int kSlabHeads = 8;              // heads of a slab, at most
constexpr int kPStride = kSlabHeads + 1;   // [edge][head] scratch stride
constexpr int kChunkTiles = 8;             // tiles of one mask chunk
constexpr int kMaxSlabCols = 512;          // 32 lanes x 16 columns

// The column layout agrees with heads and feat: vectors of vec elements,
// nv of them a lane (nv * vec <= 16 columns; nv = 8 only of scalars, which
// K5 alone takes), lpe lanes an edge; a slab of
// slab_heads whole heads, or (parts > 1) one part of a head, fits the
// lpe * nv vectors of a group.
__host__ inline bool slab_ok(int heads, int feat, int vec, int nv, int lpe,
                             int slab_heads, int parts) {
  if (heads < 1 || heads > 32 || feat < 1 || vec < 1 || feat % vec) return false;
  if ((nv != 1 && nv != 2 && nv != 4 && !(nv == 8 && vec == 1)) ||
      nv * vec > 16)
    return false;
  if (lpe < 1 || lpe > 32 || (lpe & (lpe - 1))) return false;
  const int vph = feat / vec;
  if (parts == 1)
    return slab_heads >= 1 && slab_heads <= kSlabHeads &&
           slab_heads * vph <= lpe * nv;
  return parts > 1 && slab_heads == 1 && (vph + parts - 1) / parts <= lpe * nv;
}

// V consecutive elements of XT: one 16-byte access for V > 1. A gather
// keeps the loaded value packed (Raw, 4 registers for 8 bf16 values) until
// it is used, and unpacks it to floats then.
template <typename XT, int V>
struct VecIO;

template <>
struct VecIO<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void unpack(Raw r, float* v) { v[0] = r; }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    p[0] = v[0];
  }
};

template <>
struct VecIO<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(Raw r, float* v) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct VecIO<__nv_bfloat16, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void unpack(Raw r, float* v) { v[0] = r; }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    p[0] = __float2bfloat16(v[0]);
  }
};

template <>
struct VecIO<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(Raw r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 -> f32 is a 16-bit shift
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The slab of work item `sl` (blockIdx.y): heads [h0, h0 + hs) and the
// row's vectors [v0, v1). With parts > 1 (then slab_heads == 1) a head's
// vph vectors split into `parts` slabs; `first` marks the slab that writes
// the per-head outputs.
struct Slab {
  int h0, hs, v0, v1;
  bool first;
};

__device__ __forceinline__ Slab slab_of(int sl, int heads, int vph,
                                        int slab_heads, int parts) {
  Slab s;
  if (parts == 1) {
    s.h0 = sl * slab_heads;
    s.hs = min(slab_heads, heads - s.h0);
    s.v0 = s.h0 * vph;
    s.v1 = s.v0 + s.hs * vph;
    s.first = true;
  } else {
    const int part = sl % parts, per = (vph + parts - 1) / parts;
    s.h0 = sl / parts;
    s.hs = 1;
    s.v0 = s.h0 * vph + part * per;
    s.v1 = min(s.v0 + per, (s.h0 + 1) * vph);
    s.first = part == 0;
  }
  return s;
}

// This lane's columns: vector k (k < NV) is the row's vector
// v0 + sub + lpe*k, of head hk[k] - h0 (slab-relative); edges go to the
// 32 / lpe groups of lpe lanes in turn.
template <int NV>
struct ColLanes {
  int sub, grp, ngrp;
  int col[NV];    // first element of vector k in the row
  int hk[NV];     // its slab-relative head (0 where the vector is idle)
  bool on[NV];    // vector k lies in the slab
};

template <int NV>
__device__ __forceinline__ ColLanes<NV> col_lanes(const Slab& s, int lane,
                                                  int lpe, int vph, int vec) {
  ColLanes<NV> c;
  c.sub = lane & (lpe - 1);
  c.grp = lane / lpe;
  c.ngrp = 32 / lpe;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int vi = s.v0 + c.sub + lpe * k;
    c.on[k] = vi < s.v1;
    c.hk[k] = c.on[k] ? vi / vph - s.h0 : 0;
    c.col[k] = vi * vec;
  }
  return c;
}

// Edges of a group whose row loads are in flight at once, by the columns
// a lane holds: 4 up to 2 columns, 2 beyond (so that a 64-register lane
// needs no spill).
__host__ __device__ constexpr int edges_in_flight(int cols) {
  return cols <= 2 ? 4 : 2;
}

// This lane's vectors of the rows (x in K4, gn in K6) of U edges of its
// group, edges j, j + ngrp, ... below nb, packed; zeros past nb.
template <typename XT, int V, int NV, int U>
__device__ __forceinline__ void gather_rows(
    typename VecIO<XT, V>::Raw (&v)[U][NV], const XT* base, int hf,
    const int* node, int j, int nb, const ColLanes<NV>& L) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int jj = j + u * L.ngrp;
    const bool ok = jj < nb;
    const XT* r = base + static_cast<long long>(ok ? node[jj] : 0) * hf;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      v[u][k] = ok && L.on[k] ? VecIO<XT, V>::load(r + L.col[k])
                              : typename VecIO<XT, V>::Raw{};
  }
}

// Sum over the edge groups (lanes lpe apart), in every lane.
__device__ __forceinline__ float group_combine(float v, int lpe) {
  for (int off = lpe; off < 32; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// kChunkTiles tiles' mask words of one tile row, one word a lane (tile
// lane / 4, word lane % 4), with the inclusive popcount prefix.
struct SlotChunk {
  uint32_t word;
  int incl;
  int total;
};

__device__ __forceinline__ SlotChunk load_chunk(const int* row_masks,
                                                int t_first, int t_end,
                                                int ri, int lane) {
  SlotChunk c;
  const int t = t_first + (lane >> 2);
  c.word = t < t_end
               ? static_cast<uint32_t>(__ldg(
                     row_masks + (static_cast<long long>(t) * kRowBlock + ri) *
                                     4 + (lane & 3)))
               : 0u;
  c.incl = __popc(c.word);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, c.incl, off);
    if (lane >= off) c.incl += v;
  }
  c.total = __shfl_sync(kFull, c.incl, 31);
  return c;
}

// Position of the k-th (from 0) set bit of w; k < popc(w).
__device__ __forceinline__ int nth_bit(uint32_t w, int k) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width > 0; width >>= 1) {
    const int lo = __popc(w & ((1u << width) - 1u));
    if (k >= lo) {
      k -= lo;
      w >>= width;
      pos += width;
    }
  }
  return pos;
}

// The chunk's q-th slot (0 <= q < total; every lane with its own q, all
// lanes calling): the tile within the chunk and the column in the tile.
__device__ __forceinline__ void chunk_slot(const SlotChunk& c, int q,
                                           int& tile, int& col) {
  int lane = 0;   // the first lane whose inclusive prefix exceeds q
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const int v = __shfl_sync(kFull, c.incl, lane + step - 1);
    if (v <= q) lane += step;
  }
  const uint32_t w = __shfl_sync(kFull, c.word, lane);
  const int before = __shfl_sync(kFull, c.incl, lane) - __popc(w);
  tile = lane >> 2;
  col = (lane & 3) * 32 + nth_bit(w, max(q - before, 0));
}

// A cursor over one row's stream: the remainder edges [e0, e0 + nr), then
// the slots of the row block's tiles [t0, t0 + tn), one mask chunk at a
// time; `base` is the stream index of the current chunk's first slot.
struct RowStream {
  int t0, tn, ri, e0, nr;
  int c, base;
  SlotChunk ch;
};

__device__ __forceinline__ RowStream row_stream(const int* tile_off,
                                                const int* tile_cnt,
                                                const int* row_ptr,
                                                const int* row_masks,
                                                int row, int lane) {
  RowStream rs;
  const int rb = row / kRowBlock;
  rs.ri = row % kRowBlock;
  rs.t0 = tile_off[rb];
  rs.tn = tile_cnt[rb];
  rs.e0 = row_ptr[row];
  rs.nr = row_ptr[row + 1] - rs.e0;
  rs.c = 0;
  rs.base = rs.nr;
  rs.ch = load_chunk(row_masks, rs.t0, rs.t0 + min(rs.tn, kChunkTiles),
                     rs.ri, lane);
  return rs;
}

__device__ __forceinline__ bool next_chunk(RowStream& rs,
                                           const int* row_masks, int lane) {
  if ((rs.c + 1) * kChunkTiles >= rs.tn) return false;
  rs.base += rs.ch.total;
  ++rs.c;
  rs.ch = load_chunk(row_masks, rs.t0 + rs.c * kChunkTiles, rs.t0 + rs.tn,
                     rs.ri, lane);
  return true;
}

// Moves the cursor to the chunk that holds stream entry pos (or past the
// remainder); false when the stream ends before pos.
__device__ __forceinline__ bool seek(RowStream& rs, const int* row_masks,
                                     int pos, int lane) {
  while (pos >= rs.base + rs.ch.total)
    if (!next_chunk(rs, row_masks, lane)) return false;
  return true;
}

// One lane's entry of a batch: a remainder edge (index e) or a tile slot
// (tile t, column col).
struct Entry {
  bool valid, rem;
  int e, t, col;
};

__device__ __forceinline__ Entry batch_entry(const RowStream& rs, int pos,
                                             int end, int lane) {
  Entry en;
  const int g = pos + lane;
  en.valid = g < end;
  en.rem = g < rs.nr;
  int tl, col;
  chunk_slot(rs.ch, en.rem ? 0 : g - rs.base, tl, col);
  en.e = rs.e0 + g;
  en.t = rs.t0 + rs.c * kChunkTiles + tl;
  en.col = col;
  return en;
}

// A batch's edges as the per-edge phase leaves them: the other endpoint,
// the weight, the dropout word of a tile slot, and the keep_mul row of a
// remainder edge (-1 for a tile slot). A tile slot is live; a remainder
// edge is live where its weight is positive.
struct EdgeScratch {
  int node[32];
  float w[32];
  uint32_t word[32];
  int e[32];
};

__device__ __forceinline__ bool edge_live(const EdgeScratch& ed, int j) {
  return ed.e[j] < 0 || ed.w[j] > 0.f;
}

// Per edge, one lane, over the forward layout (K4 and K5): the sender,
// weight and dropout word of entry `en` of row `ri` of its row block. Args
// holds the forward operands: rem_senders, rem_w, col_ids, tiles,
// tile_bf16, bits (the forward lattice) and dropping.
template <typename Args>
__device__ __forceinline__ void fill_edge(EdgeScratch& ed, const Args& a,
                                          const Entry& en, int ri, int lane) {
  if (!en.valid) return;
  int src;
  float w;
  uint32_t word = 0u;
  if (en.rem) {
    src = a.rem_senders[en.e];
    w = a.rem_w[en.e];
  } else {
    const long long slot =
        (static_cast<long long>(en.t) * kRowBlock + ri) * kColBlock + en.col;
    src = a.col_ids[en.t] * kColBlock + en.col;
    w = tile_val(a.tiles, a.tile_bf16, slot);
    if (a.dropping) word = static_cast<uint32_t>(a.bits[slot]);
  }
  ed.node[lane] = src;
  ed.w[lane] = w;
  ed.word[lane] = word;
  ed.e[lane] = en.rem ? en.e : -1;
}

// Lanes of the per-(edge, head) phase: lane l takes head l % hp of the
// slab (hp: its heads rounded up to a power of two; on: a real head) and
// edge l / hp of each round of 32 / hp edges, so the lanes of one head are
// hp apart.
struct PairLanes {
  int h, jr, epr, hp;
  bool on;
};

__device__ __forceinline__ PairLanes pair_lanes(int hs, int lane) {
  PairLanes p;
  p.hp = 1;
  while (p.hp < hs) p.hp <<= 1;
  p.h = lane & (p.hp - 1);
  p.jr = lane / p.hp;
  p.epr = 32 / p.hp;
  p.on = p.h < hs;
  return p;
}

// Max and sum over the lanes of this lane's head, in every such lane.
__device__ __forceinline__ float head_max(float v, const PairLanes& p) {
  for (int off = p.hp; off < 32; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float head_sum(float v, const PairLanes& p) {
  for (int off = p.hp; off < 32; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The stream range [lo, hi) of one warp: the whole row, or its share of a
// long row of n entries (HybridGraph.row_edges) split over the CTA's warps.
__device__ __forceinline__ void warp_range(bool split, int n, int warp,
                                           int& lo, int& hi) {
  if (!split) {
    lo = 0;
    hi = 0x7fffffff;
    return;
  }
  const int share = (n + kWarps - 1) / kWarps;
  lo = min(warp * share, n);
  hi = min(lo + share, n);
}

}  // namespace gnn_attend
