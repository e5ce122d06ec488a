// K7: neighbour max over the dense tiles of the BCSR layout, for Hopper
// (sm_90a).
//
//   out[rb*128 + i, c] = max(neg, max over t in [tile_off[rb],
//                            tile_off[rb] + tile_cnt[rb]) and j with
//                            tiles[t, i, j] != 0 of v[col_ids[t]*128 + j, c])
//
// The tiles [T, 128, 128] enter only through their nonzero pattern, as
// row_masks [T, 128, 4] (each tile row's nonzero slots as four 32-bit
// words, BCSRGraph.row_masks, built once per graph) and col_masks
// [T, 2, 4] (the columns each 64-row half names). v float32 [N, C], out
// float32 [N, C]. A row without a tiled in-edge gets `neg` (-1e30 from the
// caller), which the caller combines with the COO remainder's max. Exact:
// a max of the inputs, no arithmetic; a NaN in v propagates, as
// jnp.maximum does.
//
// Replaces the TPU kernel _nmax_kernel of
// graphneuralnetwork_tpu/ops/bcsr_attention.py (launched by _nmax_pallas),
// which walks a row block's tiles as its sequential grid dimension and, for
// every column, masks the whole 128x128 tile against v and reduces it on
// the vector unit. Here the walk is a loop inside the CTA.
//
// Bound: bytes (the masks, the v rows the nonzero slots name and out once;
// one comparison per nonzero slot and column). The earlier design (a CTA
// per quarter row block and 32-column slab) staged each v block four times
// and re-read each tile once per 32 columns. This one (tile_walk.cuh)
// splits the work into items of a whole row block, or a half where that
// fills the card better, times up to 128 columns (8 at the three-pass
// shift's 8 heads, so no lane idles), and stages each tile's masks and the
// v rows they name once per item, by the Tensor Memory Accelerator's bulk
// copies (or cp.async) into a ring of 2-8 stages, the next tiles' copies
// in flight while the current one is walked. The tile values, 16-32x the
// masks' bytes, are never read. Only the nonzero slots are compared, by
// one max.NaN each.

#include "tile_walk.cuh"

namespace {

// max.NaN: a NaN in either operand gives NaN, as jnp.maximum does.
struct Max {
  static constexpr bool kWeighted = false;
  __device__ static float fold(float acc, float, float x) {
    float m;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(acc), "f"(x));
    return m;
  }
};

}  // namespace

// row_masks [T, 128, 4] and col_masks [T, 2, 4] int32: BCSRGraph's masks
// of the tiles (the tile values are not read). tile_bf16: 0 = float32
// tiles, 1 = bfloat16. rows (128 or 64), slab (4 ...
// 128) and copy_bytes (16, 8 or 4: v's chunk per cp.async) come from
// ops/cuda/tile_walk.py:tile_grid. Returns the launch's cudaError_t.
extern "C" int gnn_neighbor_max(const void* tiles, const void* v,
                                const void* col_ids, const void* tile_off,
                                const void* tile_cnt, const void* row_masks,
                             const void* col_masks,
                                void* out,
                                int n_row_blocks, int n, int c, int tile_bf16,
                                int rows, int slab, int copy_bytes, float neg,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_bf16)
    return gnn_tiles::launch_walk<Max, __nv_bfloat16>(
        tiles, v, col_ids, tile_off, tile_cnt, row_masks, col_masks, out, n_row_blocks,
        n, c, rows, slab, copy_bytes, neg, s);
  return gnn_tiles::launch_walk<Max, float>(
      tiles, v, col_ids, tile_off, tile_cnt, row_masks, col_masks, out, n_row_blocks, n,
      c, rows, slab, copy_bytes, neg, s);
}

extern "C" const char* gnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
