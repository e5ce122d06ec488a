// The walk of a row block's dense tiles by their nonzero slots, shared by
// K3 (bcsr_spmm_kernel.cu, a weighted sum) and K7 (neighbor_max_kernel.cu,
// a max), for Hopper (sm_90a).
//
// A CTA owns kRowsPerCta rows of one 128-row block and one 32-column slab
// of v [N, C]. Each of its 8 warps owns kRowsPerWarp rows and each lane one
// column, so every output is one thread's accumulator in a register. For
// every tile t in the row block's span, in order:
//   * the v block rows col_ids[t]*128 .. +128 of the slab are staged in
//     shared memory (coalesced 128-byte rows);
//   * each warp holds its rows of the tile in registers (coalesced 128-value
//     rows), turns each into four 32-bit nonzero masks with __ballot_sync
//     and walks the set bits: the mask is the same for the whole warp, so
//     the walk does not diverge, and only the nonzero slots (1-6 % of them
//     on the path's graphs) read v. K3 fetches a slot's weight from the
//     lane that holds it with one shuffle.
// The next tile's v block and tile rows are loaded into registers before
// the current tile is walked, so their latency hides behind the walk. The
// slots are visited in a fixed order (tiles in span order, then columns
// ascending), with no atomics: the result is deterministic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gnn_tiles {

constexpr int kBlock = 128;                    // ROW_BLOCK == COL_BLOCK
constexpr int kSlab = 32;                      // columns per CTA, one a lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerCta = 32;                // a quarter of a row block
constexpr int kRowsPerWarp = kRowsPerCta / kWarps;
constexpr int kQuarters = kBlock / kRowsPerCta;
constexpr int kWords = kBlock / 32;            // mask words per tile row
constexpr int kVLoads = kBlock * kSlab / kThreads;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// This thread's place: its row block, its warp's first row within the
// block and the CTA's first column. The slabs and quarters of one row block
// are neighbours in launch order, so they share the tile and v reads in L2.
struct Place {
  int rb, row0, c0;
};

__device__ __forceinline__ Place place(int c) {
  const int n_slabs = (c + kSlab - 1) / kSlab;
  const int slab = blockIdx.x % n_slabs;
  const int rest = blockIdx.x / n_slabs;
  return {rest / kQuarters, (rest % kQuarters) * kRowsPerCta +
                                (threadIdx.x >> 5) * kRowsPerWarp,
          slab * kSlab};
}

// Grid size for n_row_blocks row blocks and c columns.
inline long long grid_size(int n_row_blocks, int c) {
  return static_cast<long long>(n_row_blocks) * kQuarters *
         ((c + kSlab - 1) / kSlab);
}

// The registers of one tile: this warp's tile rows (lane l holds column
// q*32 + l of word q) and this thread's share of the v block.
template <typename VT, typename TT>
struct Staged {
  TT w[kRowsPerWarp][kWords];
  VT v[kVLoads];
};

template <typename VT, typename TT>
__device__ __forceinline__ void load_tile(
    Staged<VT, TT>& s, const TT* __restrict__ tiles,
    const VT* __restrict__ v, const int* __restrict__ col_ids, int t,
    const Place& p, int n, int c) {
  const int lane = threadIdx.x & 31;
  const TT* trow = tiles + static_cast<long long>(t) * kBlock * kBlock +
                   p.row0 * kBlock + lane;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int q = 0; q < kWords; ++q) s.w[r][q] = trow[r * kBlock + q * 32];
  const int vrow0 = __ldg(col_ids + t) * kBlock;
#pragma unroll
  for (int m = 0; m < kVLoads; ++m) {
    const int e = threadIdx.x + m * kThreads;
    const int row = vrow0 + e / kSlab, col = p.c0 + e % kSlab;
    // rows at or beyond n hold no nonzero slot, so they are never read
    s.v[m] = from_float<VT>(0.f);
    if (row < n && col < c) s.v[m] = v[static_cast<long long>(row) * c + col];
  }
}

// Fold every nonzero slot (weight w) of this warp's rows over the tiles
// [lo, lo + cnt) into acc: acc[r] = Op::fold(acc[r], w, v[s, lane]) for each
// sender s of row r. Op::kWeighted says whether fold reads w.
template <typename Op, typename VT, typename TT>
__device__ __forceinline__ void walk_tiles(
    float (&acc)[kRowsPerWarp], const TT* __restrict__ tiles,
    const VT* __restrict__ v, const int* __restrict__ col_ids, int lo,
    int cnt, const Place& p, int n, int c) {
  __shared__ float v_s[kBlock][kSlab];
  const int lane = threadIdx.x & 31;
  Staged<VT, TT> next;
  if (cnt > 0) load_tile(next, tiles, v, col_ids, lo, p, n, c);
  for (int k = 0; k < cnt; ++k) {
    const Staged<VT, TT> cur = next;
#pragma unroll
    for (int m = 0; m < kVLoads; ++m) {
      const int e = threadIdx.x + m * kThreads;
      v_s[e / kSlab][e % kSlab] = to_float(cur.v[m]);
    }
    __syncthreads();
    if (k + 1 < cnt) load_tile(next, tiles, v, col_ids, lo + k + 1, p, n, c);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        uint32_t bits = __ballot_sync(kFull, to_float(cur.w[r][q]) != 0.f);
        while (bits) {
          const int j = __ffs(bits) - 1;
          bits &= bits - 1;
          TT w = cur.w[r][q];
          if constexpr (Op::kWeighted) w = __shfl_sync(kFull, w, j);
          acc[r] = Op::fold(acc[r], w, v_s[q * 32 + j][lane]);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace gnn_tiles
