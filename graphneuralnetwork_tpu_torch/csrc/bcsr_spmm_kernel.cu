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
// the CTA, and the row blocks (or their 64-row halves, where the row blocks
// alone would not fill the card) times the column slabs of up to 128 make
// the parallel grid (ops/cuda/tile_walk.py:tile_grid).
//
// Bound: bytes. The function moves the tile store, the x rows that the
// nonzero slots name and out once. The earlier design (a CTA per quarter
// row block and 32-column slab) staged each x block four times and re-read
// each tile once per 32 columns; here each tile and each x block is staged
// once per work item into a ring of stages (tile_walk.cuh), the next
// tiles' copies in flight while the current one is folded. Then:
//   * bfloat16 x: the CTA multiplies tile @ x block densely on the tensor
//     cores (mma.sync m16n8k16, bf16 in, float32 accumulators). Float32
//     tiles are rounded to bf16 as their fragments leave shared memory.
//     The dense product, 2 * T * 128 * 128 * F flops, is a few µs at the
//     bf16 tensor rate, under the bytes; bf16 x bf16 products are exact in
//     float32, so only the order of the sums differs from the plain
//     version. Two stages of padded rows by cp.async, a CTA per item.
//   * float32 x: the nonzero-slot walk of tile_walk.cuh with float32 FMAs,
//     each row's slots taken from row_masks (BCSRGraph.row_masks, built
//     once per graph) and only the x rows the item names copied (col_masks).
//     The JAX package's f32 path is Precision.HIGHEST, so no TF32; only
//     the nonzero slots (1-6 % on the path's graphs) are multiplied.

#include "tile_walk.cuh"

namespace {

using gnn_tiles::kBlock;
using gnn_tiles::Place;

struct WeightedSum {
  static constexpr bool kWeighted = true;
  __device__ static float fold(float acc, float w, float x) {
    return fmaf(w, x, acc);
  }
};

// ---- bfloat16 x on the tensor cores ----------------------------------------

// Values of padding per shared row: the 8 rows that one ldmatrix (or the
// float2 reads of a fragment) touches fall in different banks.
constexpr int kPad = 8;
constexpr int kTileStride = kBlock + kPad;

// Shared memory of bcsr_mma_kernel: the mbarriers, then the stages (R
// padded tile rows and 128 padded x rows of S bf16 each).
template <int R, int S, typename TT>
struct MmaRing {
  static constexpr int kTileBytes =
      R * kTileStride * static_cast<int>(sizeof(TT));
  static constexpr int kStageBytes = kTileBytes + kBlock * (S + kPad) * 2;
  // two stages: a third measured no faster
  static constexpr int kStages =
      gnn_tiles::ring_stages<kStageBytes, 0>() < 2 ? 0 : 2;
  static constexpr int kSmem = gnn_tiles::kBarBytes + kStages * kStageBytes;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(gnn_tiles::smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
      : "r"(gnn_tiles::smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&b)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(gnn_tiles::smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragment (16 rows x 16 k) of m16n8k16 from the staged tile rows at
// t (row 0, column k0).
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* t, int lane) {
  ldsm_x4(a, t + (lane & 15) * kTileStride + (lane >> 4) * 8);
}

__device__ __forceinline__ void load_a(uint32_t (&a)[4], const float* t,
                                       int lane) {
  const float* p = t + (lane >> 2) * kTileStride + 2 * (lane & 3);
  a[0] = pack_bf16(*reinterpret_cast<const float2*>(p));
  a[1] = pack_bf16(*reinterpret_cast<const float2*>(p + 8 * kTileStride));
  a[2] = pack_bf16(*reinterpret_cast<const float2*>(p + 8));
  a[3] = pack_bf16(*reinterpret_cast<const float2*>(p + 8 * kTileStride + 8));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* __restrict__ out,
                                           int row, int col, float v0,
                                           float v1, int n, int f) {
  if (row >= n || col >= f) return;
  __nv_bfloat16* o = out + static_cast<long long>(row) * f + col;
  if (f % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  } else {
    o[0] = __float2bfloat16(v0);
    if (col + 1 < f) o[1] = __float2bfloat16(v1);
  }
}

// The dense product's work on one CTA: 8 warps as 4 (rows) x 2 (columns);
// a warp owns R/4 rows and S/2 columns, MT m16 tiles by NT n8 tiles of
// float32 accumulators.
template <int R, int S, typename TT>
struct MmaWork {
  using Ring = MmaRing<R, S, TT>;
  static constexpr int kCtaThreads = gnn_tiles::kThreads;
  static constexpr bool kPadded = true;
  static constexpr int MT = R / 64, NT = S / 16, XS = S + kPad;
  static constexpr int kTileBytes = Ring::kTileBytes;
  static constexpr int kStageBytes = Ring::kStageBytes;

  const TT* __restrict__ tiles;
  const __nv_bfloat16* __restrict__ x;
  const int* __restrict__ col_ids;
  __nv_bfloat16* __restrict__ out;
  int n, f, copy_bytes;
  unsigned char* ring;
  uint64_t* bars;
  int lane, m_base, n_base;
  float acc[MT][NT][4];

  __device__ __forceinline__ void begin() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }

  // A tile's copies: where it goes.
  struct Desc {
    int t, row0, c0, xr0;
  };

  __device__ __forceinline__ Desc describe(const Place& q, int t) const {
    return {t, q.row0, q.c0, __ldg(col_ids + t) * kBlock};
  }

  __device__ __forceinline__ void issue(int s, const Desc& d) {
    unsigned char* base = ring + s * kStageBytes;
    gnn_tiles::stage_tile<R, S, kCtaThreads>(
        reinterpret_cast<TT*>(base), kTileStride, tiles, d.t, d.row0,
        reinterpret_cast<__nv_bfloat16*>(base + kTileBytes), XS, x, d.xr0,
        d.c0, n, f, copy_bytes, make_uint4(~0u, ~0u, ~0u, ~0u), true,
        bars + s);
  }

  __device__ __forceinline__ void consume(int s) {
    const TT* tile_s = reinterpret_cast<const TT*>(ring + s * kStageBytes) +
                       m_base * kTileStride;
    const __nv_bfloat16* x_s = reinterpret_cast<const __nv_bfloat16*>(
        ring + s * kStageBytes + kTileBytes) + n_base;
#pragma unroll 2
    for (int k0 = 0; k0 < kBlock; k0 += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_a(a[mt], tile_s + mt * 16 * kTileStride + k0, lane);
      const __nv_bfloat16* xk = x_s + (k0 + (lane & 15)) * XS;
      if constexpr (NT == 1) {
        ldsm_x2_t(b[0], xk);
      } else {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np)
          ldsm_x4_t(b[2 * np], b[2 * np + 1], xk + np * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
  }

  __device__ __forceinline__ void finish(const Place& p) {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = p.rb * kBlock + p.row0 + m_base + mt * 16 + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = p.c0 + n_base + nt * 8 + 2 * tq;
        store_pair(out, row, col, acc[mt][nt][0], acc[mt][nt][1], n, f);
        store_pair(out, row + 8, col, acc[mt][nt][2], acc[mt][nt][3], n, f);
      }
    }
  }
};

template <int R, int S, typename TT>
__global__ void __launch_bounds__(gnn_tiles::kThreads, 1)
    bcsr_mma_kernel(const TT* __restrict__ tiles,
                    const __nv_bfloat16* __restrict__ x,
                    const int* __restrict__ col_ids,
                    const int* __restrict__ tile_off,
                    const int* __restrict__ tile_cnt,
                    __nv_bfloat16* __restrict__ out, int n_row_blocks, int n,
                    int f, int copy_bytes) {
  using Work = MmaWork<R, S, TT>;
  extern __shared__ __align__(128) unsigned char smem[];
  Work w;
  w.tiles = tiles;
  w.x = x;
  w.col_ids = col_ids;
  w.out = out;
  w.n = n;
  w.f = f;
  w.copy_bytes = copy_bytes;
  w.bars = reinterpret_cast<uint64_t*>(smem);
  w.ring = smem + gnn_tiles::kBarBytes;
  w.lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  w.m_base = (warp & 3) * Work::MT * 16;
  w.n_base = (warp >> 2) * Work::NT * 8;
  gnn_tiles::run_items<R, S, Work::Ring::kStages>(
      w, n_row_blocks, f, copy_bytes, tile_off, tile_cnt, w.bars);
}

template <typename TT>
cudaError_t launch_mma(const void* tiles, const void* x, const void* col_ids,
                       const void* tile_off, const void* tile_cnt, void* out,
                       int n_row_blocks, int n, int f, int rows, int slab,
                       int copy_bytes, cudaStream_t stream) {
  return gnn_tiles::with_shape(rows, slab, [&](auto r, auto s) -> cudaError_t {
    constexpr int R = decltype(r)::value, S = decltype(s)::value;
    if constexpr (S < 16 || MmaRing<R, S, TT>::kStages < 2) {
      return cudaErrorInvalidValue;
    } else {
      constexpr int smem = MmaRing<R, S, TT>::kSmem;
      auto kernel = bcsr_mma_kernel<R, S, TT>;
      static const cudaError_t allowed = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (allowed != cudaSuccess) return allowed;
      const int items = gnn_tiles::n_items<R, S>(n_row_blocks, f);
      if (items == 0) return cudaSuccess;
      // a CTA per item: measured faster here than CTAs that take items in
      // turn
      kernel<<<items, gnn_tiles::kThreads, smem, stream>>>(
          static_cast<const TT*>(tiles),
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const int*>(col_ids), static_cast<const int*>(tile_off),
          static_cast<const int*>(tile_cnt),
          static_cast<__nv_bfloat16*>(out), n_row_blocks, n, f, copy_bytes);
      return cudaGetLastError();
    }
  });
}

}  // namespace

// row_masks [T, 128, 4] and col_masks [T, 2, 4] int32: BCSRGraph's masks
// of the tiles (the float32 walk's slots and named x rows; may be null for
// bfloat16 x, whose dense product reads neither). x_bf16 /
// tile_bf16: 0 = float32, 1 = bfloat16. rows (128 or 64), slab
// (4 ... 128; at least 16 for bfloat16 x) and copy_bytes (x's chunk per
// cp.async: 16, 8, 4, or 2 for a copy through registers) come from
// ops/cuda/tile_walk.py:tile_grid. Returns the launch's cudaError_t.
extern "C" int gnn_bcsr_spmm(const void* tiles, const void* x,
                             const void* col_ids, const void* tile_off,
                             const void* tile_cnt, const void* row_masks,
                             const void* col_masks,
                             void* out,
                             int n_row_blocks, int n, int f, int x_bf16,
                             int tile_bf16, int rows, int slab,
                             int copy_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && tile_bf16)
    return launch_mma<__nv_bfloat16>(tiles, x, col_ids, tile_off, tile_cnt,
                                     out, n_row_blocks, n, f, rows, slab,
                                     copy_bytes, s);
  if (x_bf16)
    return launch_mma<float>(tiles, x, col_ids, tile_off, tile_cnt, out,
                             n_row_blocks, n, f, rows, slab, copy_bytes, s);
  if (tile_bf16)
    return gnn_tiles::launch_walk<WeightedSum, __nv_bfloat16>(
        tiles, x, col_ids, tile_off, tile_cnt, row_masks, col_masks, out, n_row_blocks,
        n, f, rows, slab, copy_bytes, 0.f, s);
  return gnn_tiles::launch_walk<WeightedSum, float>(
      tiles, x, col_ids, tile_off, tile_cnt, row_masks, col_masks, out, n_row_blocks, n,
      f, rows, slab, copy_bytes, 0.f, s);
}

extern "C" const char* gnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
