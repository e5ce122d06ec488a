// K7: neighbour max over the dense tiles of the BCSR layout, for Hopper
// (sm_90a).
//
//   out[rb*128 + i, c] = max(neg, max over t in [tile_off[rb],
//                            tile_off[rb] + tile_cnt[rb]) and j with
//                            tiles[t, i, j] != 0 of v[col_ids[t]*128 + j, c])
//
// tiles [T, 128, 128] float32 or bfloat16 (only their nonzero pattern is
// read), v float32 [N, C], out float32 [N, C]. A row without a tiled
// in-edge gets `neg` (-1e30 from the caller), which the caller combines
// with the COO remainder's max. Exact: a max of the inputs, no arithmetic.
//
// Replaces the TPU kernel _nmax_kernel of
// graphneuralnetwork_tpu/ops/bcsr_attention.py (launched by _nmax_pallas),
// which walks a row block's tiles as its sequential grid dimension and, for
// every column, masks the whole 128x128 tile against v and reduces it on
// the vector unit. Here the walk is a loop inside the CTA and the row
// blocks times their quarters times the 32-column slabs make the parallel
// grid.
//
// Bound: bytes (the tile store, v and out once; one comparison per nonzero
// slot and column). The kernel walks only the nonzero slots
// (tile_walk.cuh), so the comparisons cost no more than the function
// needs; a NaN in v propagates, as jnp.maximum does.

#include "tile_walk.cuh"

namespace {

struct Max {
  static constexpr bool kWeighted = false;
  template <typename TT>
  __device__ static float fold(float acc, TT, float x) {
    return (x > acc || x != x) ? x : acc;
  }
};

template <typename TT>
__global__ void __launch_bounds__(gnn_tiles::kThreads)
    neighbor_max_kernel(const TT* __restrict__ tiles,
                        const float* __restrict__ v,
                        const int* __restrict__ col_ids,
                        const int* __restrict__ tile_off,
                        const int* __restrict__ tile_cnt,
                        float* __restrict__ out, int n, int c, float neg) {
  const gnn_tiles::Place p = gnn_tiles::place(c);
  float m[gnn_tiles::kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < gnn_tiles::kRowsPerWarp; ++r) m[r] = neg;
  gnn_tiles::walk_tiles<Max>(m, tiles, v, col_ids, __ldg(tile_off + p.rb),
                             __ldg(tile_cnt + p.rb), p, n, c);
  const int col = p.c0 + (threadIdx.x & 31);
  if (col >= c) return;
#pragma unroll
  for (int r = 0; r < gnn_tiles::kRowsPerWarp; ++r) {
    const int row = p.rb * gnn_tiles::kBlock + p.row0 + r;
    if (row < n) out[static_cast<long long>(row) * c + col] = m[r];
  }
}

template <typename TT>
cudaError_t launch(const void* tiles, const float* v, const int* col_ids,
                   const int* tile_off, const int* tile_cnt, float* out,
                   int n_row_blocks, int n, int c, float neg,
                   cudaStream_t stream) {
  const long long grid = gnn_tiles::grid_size(n_row_blocks, c);
  neighbor_max_kernel<TT><<<static_cast<unsigned>(grid), gnn_tiles::kThreads,
                            0, stream>>>(
      static_cast<const TT*>(tiles), v, col_ids, tile_off, tile_cnt, out, n,
      c, neg);
  return cudaGetLastError();
}

}  // namespace

// tile_bf16: 0 = float32 tiles, 1 = bfloat16. Returns the launch's
// cudaError_t.
extern "C" int gnn_neighbor_max(const void* tiles, const void* v,
                                const void* col_ids, const void* tile_off,
                                const void* tile_cnt, void* out,
                                int n_row_blocks, int n, int c, int tile_bf16,
                                float neg, void* stream) {
  const float* vf = static_cast<const float*>(v);
  const int* ci = static_cast<const int*>(col_ids);
  const int* to = static_cast<const int*>(tile_off);
  const int* tc = static_cast<const int*>(tile_cnt);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_bf16)
    return launch<__nv_bfloat16>(tiles, vf, ci, to, tc, o, n_row_blocks, n, c,
                                 neg, s);
  return launch<float>(tiles, vf, ci, to, tc, o, n_row_blocks, n, c, neg, s);
}

extern "C" const char* gnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
