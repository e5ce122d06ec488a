// K3: dense-tile SpMM over the BCSR layout, for Hopper (sm_90a).
//
//   out[rb*128 + i, f] = sum over t in [tile_off[rb], tile_off[rb] +
//                        tile_cnt[rb]) and k of
//                        tiles[t, i, k] * x[col_ids[t]*128 + k, f]
//
// tiles [T, 128, 128] float32 or bfloat16, x [N, F] float32 or bfloat16,
// out [N, F] in x's type. Each tile value is first rounded to x's type (the
// JAX package casts the tiles to x.dtype), then every product and sum is
// float32 and the output is rounded once. Rows of out at or beyond N are
// not written; a row block without tiles writes zeros.
//
// Replaces the TPU kernels _bcsr_kernel and _bcsr_unrolled_kernel of
// graphneuralnetwork_tpu/ops/bcsr_spmm.py (launched by _bcsr_pallas), which
// walk a row block's tiles as the sequential grid dimension (or unrolled
// into one step) and accumulate tile @ x_block densely on the matrix unit
// in the resident output block. Here the sequential walk is a loop inside
// the CTA, and the row blocks times their quarters times the 32-column
// slabs make the parallel grid: Cora has 22 row blocks and the Pubmed graph
// 16, too few to fill 132 SMs alone.
//
// Bound: the function moves the tile store, x and out once and needs 2
// flops per nonzero tile slot and column, so it is bound by bytes. A dense
// product of each tile would do 2*T*128*128*F flops, 15-80x the needed
// work at the path's tile fills (1-6 % nonzero), so the kernel walks the
// nonzero slots instead (tile_walk.cuh) and multiplies with plain float32
// FMAs (the JAX package's f32 path is Precision.HIGHEST, so no TF32).
// Tensor cores and TMA are later work.

#include <type_traits>

#include "tile_walk.cuh"

namespace {

using gnn_tiles::from_float;

// A tile value as the product sees it: rounded to x's type.
template <typename XT, typename TT>
__device__ __forceinline__ float tile_value(TT v) {
  if constexpr (std::is_same_v<XT, __nv_bfloat16> &&
                std::is_same_v<TT, float>) {
    return __bfloat162float(__float2bfloat16(v));
  } else {
    return gnn_tiles::to_float(v);
  }
}

template <typename XT>
struct WeightedSum {
  static constexpr bool kWeighted = true;
  template <typename TT>
  __device__ static float fold(float acc, TT w, float x) {
    return fmaf(tile_value<XT>(w), x, acc);
  }
};

template <typename XT, typename TT>
__global__ void __launch_bounds__(gnn_tiles::kThreads)
    bcsr_spmm_kernel(const TT* __restrict__ tiles, const XT* __restrict__ x,
                     const int* __restrict__ col_ids,
                     const int* __restrict__ tile_off,
                     const int* __restrict__ tile_cnt, XT* __restrict__ out,
                     int n, int f) {
  const gnn_tiles::Place p = gnn_tiles::place(f);
  float acc[gnn_tiles::kRowsPerWarp] = {};
  gnn_tiles::walk_tiles<WeightedSum<XT>>(acc, tiles, x, col_ids,
                                         __ldg(tile_off + p.rb),
                                         __ldg(tile_cnt + p.rb), p, n, f);
  const int col = p.c0 + (threadIdx.x & 31);
  if (col >= f) return;
#pragma unroll
  for (int r = 0; r < gnn_tiles::kRowsPerWarp; ++r) {
    const int row = p.rb * gnn_tiles::kBlock + p.row0 + r;
    if (row < n)
      out[static_cast<long long>(row) * f + col] = from_float<XT>(acc[r]);
  }
}

template <typename XT, typename TT>
cudaError_t launch(const void* tiles, const void* x, const int* col_ids,
                   const int* tile_off, const int* tile_cnt, void* out,
                   int n_row_blocks, int n, int f, cudaStream_t stream) {
  const long long grid = gnn_tiles::grid_size(n_row_blocks, f);
  bcsr_spmm_kernel<XT, TT><<<static_cast<unsigned>(grid),
                             gnn_tiles::kThreads, 0, stream>>>(
      static_cast<const TT*>(tiles), static_cast<const XT*>(x), col_ids,
      tile_off, tile_cnt, static_cast<XT*>(out), n, f);
  return cudaGetLastError();
}

}  // namespace

// x_bf16 / tile_bf16: 0 = float32, 1 = bfloat16. Returns the launch's
// cudaError_t.
extern "C" int gnn_bcsr_spmm(const void* tiles, const void* x,
                             const void* col_ids, const void* tile_off,
                             const void* tile_cnt, void* out,
                             int n_row_blocks, int n, int f, int x_bf16,
                             int tile_bf16, void* stream) {
  const int* ci = static_cast<const int*>(col_ids);
  const int* to = static_cast<const int*>(tile_off);
  const int* tc = static_cast<const int*>(tile_cnt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && tile_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(tiles, x, ci, to, tc, out,
                                                n_row_blocks, n, f, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(tiles, x, ci, to, tc, out,
                                        n_row_blocks, n, f, s);
  if (tile_bf16)
    return launch<float, __nv_bfloat16>(tiles, x, ci, to, tc, out,
                                        n_row_blocks, n, f, s);
  return launch<float, float>(tiles, x, ci, to, tc, out, n_row_blocks, n, f,
                              s);
}

extern "C" const char* gnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
