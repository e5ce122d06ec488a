// The staging and the nonzero-slot walk of a row block's dense tiles,
// shared by K3 (bcsr_spmm_kernel.cu, a weighted sum) and K7
// (neighbor_max_kernel.cu, a max), for Hopper (sm_90a).
//
// Work items: a row block's R rows (R = 128, or a 64-row half where whole
// blocks would leave SMs idle) times one slab of S columns (4 ... 128). The
// host picks R and S (ops/cuda/tile_walk.py:tile_grid) and passes them as
// template arguments. The grid holds as many CTAs (512 threads for the walk,
// 256 for the dense product) as fit on
// the card at once, or fewer when there are fewer items; each CTA takes the
// items blockIdx.x, blockIdx.x + gridDim.x, ... and streams their tiles
// through a ring of stages in dynamic shared memory (as many as fit, 2 to
// 8), the copies of the next tiles (the next item's included) in flight
// while the current tile is folded. Per tile:
//   * its R rows (contiguous in the tile store) land by one bulk copy of
//     the Tensor Memory Accelerator (into padded rows: cp.async), and the
//     128 rows col_ids[t]*128 .. +128 of the item's slab of x by cp.async
//     (16-byte chunks where x's rows allow, else 8, 4, or plain loads for
//     2-byte values); the walk copies only the x rows that the item's rows
//     name (the tile's named-column masks), the dense product all of them.
//     Rows of x at or beyond n and columns at or beyond the width read as
//     zero. Everything lands on the stage's mbarrier, so each tile and each
//     x block is read once per item;
//   * walk_kernel (the weighted sum in float32, and the max) walks each
//     row's nonzero slots by its four 32-bit masks (BCSRGraph.row_masks,
//     staged beside the tile; the max stages only the masks, as it reads
//     nothing else of a tile): S/4 threads of a row each fold a float4 of x
//     for every set bit, four slots' loads at a time, so only the nonzero
//     slots (1-6 % on the path's graphs) are read.
// Slots are visited in a fixed order (tiles in span order, then columns
// ascending), with no atomics: the result is deterministic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gnn_tiles {

constexpr int kBlock = 128;                    // ROW_BLOCK == COL_BLOCK
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;          // the dense product's CTA
constexpr int kWalkThreads = 512;              // the walk's CTA
constexpr int kWords = kBlock / 32;            // mask words per tile row
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 128;                 // the stages' mbarriers
constexpr int kMaxSmem = 232448;               // a CTA's dynamic limit

// Stages of kStageBytes that fit beside kFixed bytes (2 ... kMaxStages).
template <int kStageBytes, int kFixed>
constexpr int ring_stages() {
  const int fit = (kMaxSmem - kBarBytes - kFixed) / kStageBytes;
  return fit < kMaxStages ? fit : kMaxStages;
}

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

// An item's place: its row block, its first row within the block and its
// first column. The slabs and halves of one row block are neighbours in
// item order, so they share the tile reads in L2.
struct Place {
  int rb, row0, c0;
};

template <int R, int S>
__device__ __forceinline__ Place place(int item, int width) {
  const int n_slabs = (width + S - 1) / S;
  const int slab = item % n_slabs;
  const int rest = item / n_slabs;
  return {rest / (kBlock / R), (rest % (kBlock / R)) * R, slab * S};
}

template <int R, int S>
__host__ __device__ inline int n_items(int n_row_blocks, int width) {
  return n_row_blocks * (kBlock / R) * ((width + S - 1) / S);
}

// Allow the kernel its dynamic shared memory (needed above 48 KB) and count
// the CTAs that the card holds at once; the caller keeps the count in a
// static of its own, so both are asked once per kernel.
template <typename Kernel>
inline cudaError_t resident_ctas(Kernel kernel, int smem, int threads,
                                 int* resident) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *resident = sms * per_sm;
  return cudaSuccess;
}

// Calls f(rows, slab) with both as std::integral_constant, for the CTA
// shapes tile_grid chooses: rows 128 or 64, slab 4 ... 128.
template <typename F>
inline cudaError_t with_shape(int rows, int slab, F f) {
  auto by_slab = [&](auto r) -> cudaError_t {
    switch (slab) {
      case 4: return f(r, std::integral_constant<int, 4>{});
      case 8: return f(r, std::integral_constant<int, 8>{});
      case 16: return f(r, std::integral_constant<int, 16>{});
      case 32: return f(r, std::integral_constant<int, 32>{});
      case 64: return f(r, std::integral_constant<int, 64>{});
      case 128: return f(r, std::integral_constant<int, 128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (rows == 128) return by_slab(std::integral_constant<int, 128>{});
  if (rows == 64) return by_slab(std::integral_constant<int, 64>{});
  return cudaErrorInvalidValue;
}

// ---- copies into shared memory ---------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also tells bar how many bytes of bulk copies will land.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Arrive on bar once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned),
// completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Copy G bytes global -> shared by cp.async; a source size of 0 fills
// zeros.
template <int G>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? G : 0;
  if constexpr (G == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  } else if constexpr (G == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  } else {
    static_assert(G == 4, "cp.async copies 4, 8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  }
}

// Bit kr of the 128-bit row set `rows` (4 words).
__device__ __forceinline__ bool has_row(uint4 rows, int kr) {
  const uint32_t w = kr < 64 ? (kr < 32 ? rows.x : rows.y)
                             : (kr < 96 ? rows.z : rows.w);
  return (w >> (kr & 31)) & 1u;
}

// The copy of the rows `rows` (a 128-bit set) of x's block
// xr0 .. xr0+127, columns c0 .. c0+S-1, into dst (rows `stride` values
// apart) in chunks of G bytes; zeros outside x. The host picks G so that
// every row start and c0 are G-aligned and the width is a multiple of G's
// values: a chunk lies wholly inside x or wholly outside.
template <int S, int G, int T, typename XT>
__device__ __forceinline__ void stage_x_g(XT* dst, const XT* x, int xr0,
                                          int c0, int stride, int n,
                                          int width, uint4 rows) {
  constexpr int kPerChunk = G / sizeof(XT);
  constexpr int kChunksPerRow = S / kPerChunk;
  for (int c = threadIdx.x; c < kBlock * kChunksPerRow; c += T) {
    const int kr = c / kChunksPerRow, w = (c % kChunksPerRow) * kPerChunk;
    if (!has_row(rows, kr)) continue;
    const int row = xr0 + kr, col = c0 + w;
    const bool valid = row < n && col < width;
    const XT* src = valid ? x + static_cast<long long>(row) * width + col : x;
    XT* d = dst + kr * stride + w;
    if constexpr (G >= 4) {
      cp_async<G>(d, src, valid);
    } else {  // 2-byte values at an odd width: no cp.async of 2 bytes
      *d = valid ? *src : from_float<XT>(0.f);
    }
  }
}

// Arrivals that fill one stage: thread 0 once with the bulk bytes; where
// the tile (padded rows) or x goes by cp.async, every thread once for its
// copies, and once more after its plain stores where x is copied through
// registers.
template <int T>
__device__ __forceinline__ unsigned full_count(int copy_bytes, bool padded) {
  return 1 + (copy_bytes == 16 && !padded ? 0 : T) +
         (copy_bytes == 2 ? T : 0);
}

// The bits of the 128-bit row set `rows` below `limit`.
__device__ __forceinline__ int rows_below(uint4 rows, int limit) {
  const uint32_t w[4] = {rows.x, rows.y, rows.z, rows.w};
  int count = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = limit - q * 32;
    const uint32_t keep = k >= 32 ? ~0u : (k <= 0 ? 0u : (1u << k) - 1);
    count += __popc(w[q] & keep);
  }
  return count;
}

// The CTA's fill of one stage: the R rows from row0 of tile t into t_dst
// (rows t_stride values apart) and the rows `rows` of the x block of the
// slab at c0 into x_dst (rows x_stride values apart), all landing on bar.
// The tile goes by one bulk copy of the Tensor Memory Accelerator, and x
// by bulk copies too where copy_bytes is 16 (a row a thread); into padded
// rows both go by cp.async, x in chunks of copy_bytes.
// Thread 0 tells bar how many bulk bytes will land (the transaction count
// may run ahead of it). `dense`: rows of x at or beyond n are zeroed, for
// the dense product.
template <int R, int S, int T, typename TT, typename XT>
__device__ __forceinline__ void stage_tile(
    TT* t_dst, int t_stride, const TT* __restrict__ tiles, int t, int row0,
    XT* x_dst, int x_stride, const XT* __restrict__ x, int xr0, int c0, int n,
    int width, int copy_bytes, uint4 rows, bool dense, uint64_t* bar,
    uint32_t* m_dst = nullptr, const int* __restrict__ row_masks = nullptr) {
  static_assert(R <= T && T >= 2 * kBlock, "a thread per copied row");
  constexpr unsigned kMaskBytes = R * kWords * 4;
  // bytes of the tile's bulk copy (none where cp.async copies it)
  const unsigned tile_bytes =
      t_dst && t_stride == kBlock ? R * kBlock * sizeof(TT) : 0u;
  // into padded rows (the dense product) x goes by cp.async: measured
  // faster there than a bulk copy a row
  const bool bulk_x = copy_bytes == 16 && t_stride == kBlock;
  const int rows_ok = max(0, min(kBlock, n - xr0));
  const int cols_ok = min(S, width - c0);
  const TT* src = tiles + (static_cast<long long>(t) * kBlock + row0) * kBlock;
  const int tid = threadIdx.x;
  if (tid == 0)
    mbar_expect_tx(bar, tile_bytes + (m_dst ? kMaskBytes : 0u) +
                            (bulk_x ? rows_below(rows, rows_ok) * cols_ok *
                                          sizeof(XT)
                                    : 0u));
  // this stage's earlier reads (generic proxy) come before the copies
  if (m_dst && tid == 1) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_copy(m_dst, row_masks + (static_cast<long long>(t) * kBlock + row0) *
                                     kWords,
              kMaskBytes, bar);
  }
  if (t_dst && t_stride == kBlock) {
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(t_dst, src, tile_bytes, bar);
    }
  } else if (t_dst) {   // padded rows: cp.async
    constexpr int kPerChunk = 16 / sizeof(TT);
    constexpr int kChunksPerRow = kBlock / kPerChunk;
#pragma unroll 4
    for (int c = tid; c < R * kChunksPerRow; c += T) {
      const int r = c / kChunksPerRow, w = (c % kChunksPerRow) * kPerChunk;
      cp_async<16>(t_dst + r * t_stride + w, src + r * kBlock + w, true);
    }
  }
  if (bulk_x) {
    const int r = tid - T / 2;
    if (r >= 0 && r < rows_ok && has_row(rows, r)) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(x_dst + r * x_stride,
                x + static_cast<long long>(xr0 + r) * width + c0,
                cols_ok * sizeof(XT), bar);
    }
    if (dense && rows_ok < kBlock) {
      for (int e = tid; e < (kBlock - rows_ok) * S; e += T)
        x_dst[(rows_ok + e / S) * x_stride + e % S] = from_float<XT>(0.f);
    }
    if (t_dst && t_stride != kBlock) cp_async_arrive(bar);
    return;
  }
  switch (copy_bytes) {
    case 16:
      if constexpr (S * sizeof(XT) >= 16)
        stage_x_g<S, 16, T>(x_dst, x, xr0, c0, x_stride, n, width, rows);
      break;
    case 8:
      if constexpr (S * sizeof(XT) >= 8)
        stage_x_g<S, 8, T>(x_dst, x, xr0, c0, x_stride, n, width, rows);
      break;
    case 4:
      stage_x_g<S, 4, T>(x_dst, x, xr0, c0, x_stride, n, width, rows);
      break;
    default:
      if constexpr (sizeof(XT) == 2) {
        stage_x_g<S, 2, T>(x_dst, x, xr0, c0, x_stride, n, width, rows);
        __threadfence_block();
        mbar_arrive(bar);
      }
      break;
  }
  cp_async_arrive(bar);
}

// The CTA's stream of tiles: tile ik of item ii, items blockIdx.x,
// blockIdx.x + gridDim.x, ... (items without tiles skipped).
template <int R, int S>
struct TileCursor {
  int items, width, ii, ik, off, cnt;
  Place q;

  __device__ __forceinline__ TileCursor(int items_, int width_)
      : items(items_), width(width_),
        ii(static_cast<int>(blockIdx.x) - static_cast<int>(gridDim.x)),
        ik(0), off(0), cnt(0) {}

  // Moves to the next tile; false once the stream has ended.
  __device__ __forceinline__ bool next(const int* __restrict__ tile_off,
                                       const int* __restrict__ tile_cnt,
                                       int* t) {
    while (ik >= cnt) {
      ii += static_cast<int>(gridDim.x);
      if (ii >= items) return false;
      q = place<R, S>(ii, width);
      off = __ldg(tile_off + q.rb);
      cnt = __ldg(tile_cnt + q.rb);
      ik = 0;
    }
    *t = off + ik++;
    return true;
  }
};

// The CTA's items and their tiles, streamed through a ring of kStages
// stages. w.describe(place, t) loads what the copies of tile t of the item
// at `place` need (a Work::Desc: its loads stay in flight until the next
// issue), w.issue(s, desc) starts those copies into stage s, w.begin()
// starts an item, w.consume(s) folds stage s once its copies have landed,
// w.finish(place) ends the item. bars: kStages mbarriers. (Work's methods
// are forced inline, so its accumulators stay in registers.)
template <int R, int S, int kStages, typename Work>
__device__ __forceinline__ void run_items(Work& w, int n_row_blocks,
                                          int width, int copy_bytes,
                                          const int* __restrict__ tile_off,
                                          const int* __restrict__ tile_cnt,
                                          uint64_t* bars) {
  static_assert(kStages >= 2 && kStages <= kMaxStages, "ring stages");
  const int items = n_items<R, S>(n_row_blocks, width);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      mbar_init(bars + s, full_count<Work::kCtaThreads>(copy_bytes,
                                                        Work::kPadded));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  TileCursor<R, S> cursor(items, width);
  int t = 0;
  {   // the first kStages - 1 tiles: describe them all, then issue
    typename Work::Desc first[kStages - 1];
    bool ok[kStages - 1];
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      ok[i] = cursor.next(tile_off, tile_cnt, &t);
      if (ok[i]) first[i] = w.describe(cursor.q, t);
    }
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i)
      if (ok[i]) w.issue(i, first[i]);
  }
  typename Work::Desc next{};
  bool have = cursor.next(tile_off, tile_cnt, &t);
  if (have) next = w.describe(cursor.q, t);
  int s = 0, fill = kStages - 1;
  unsigned parity = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Place p = place<R, S>(item, width);
    const int cnt = __ldg(tile_cnt + p.rb);
    w.begin();
    for (int k = 0; k < cnt; ++k) {
      if (have) {   // into the stage freed by the last consume
        w.issue(fill, next);
        have = cursor.next(tile_off, tile_cnt, &t);
        if (have) next = w.describe(cursor.q, t);
      }
      fill = fill + 1 == kStages ? 0 : fill + 1;
      mbar_wait(bars + s, (parity >> s) & 1);
      parity ^= 1u << s;
      __syncthreads();
      w.consume(s);
      __syncthreads();   // the stage is refilled by the next issue
      s = s + 1 == kStages ? 0 : s + 1;
    }
    w.finish(p);
  }
}

// ---- the nonzero-slot walk (float32 x) -------------------------------------

// Shared memory of walk_kernel: the mbarriers, then the stages, each with
// R tile rows (only where the fold reads the tile values), the R rows'
// nonzero masks (BCSRGraph.row_masks) and 128 x rows of S floats.
template <int R, int S, typename TT, bool kTile>
struct WalkRing {
  static constexpr int kTileBytes =
      kTile ? R * kBlock * static_cast<int>(sizeof(TT)) : 0;
  static constexpr int kMaskBytes = R * kWords * 4;
  static constexpr int kStageBytes = kTileBytes + kMaskBytes + kBlock * S * 4;
  static constexpr int kStages = ring_stages<kStageBytes, 0>();
  static constexpr int kSmem = kBarBytes + kStages * kStageBytes;
};

// S/4 threads share a row, each folding one float4 of the slab; the CTA
// covers kRowsAtOnce rows at a time and a thread kRowsPerThread rows.
template <int R, int S>
struct WalkShape {
  static constexpr int kThreadsPerRow = S / 4;
  static constexpr int kRowsAtOnce = kWalkThreads / kThreadsPerRow;
  static constexpr int kRowsPerThread =
      R > kRowsAtOnce ? R / kRowsAtOnce : 1;
};

// The x rows that an item's rows name in tile t: col_masks [T, 2, 4] holds
// each 64-row half's named columns; a whole block takes both halves.
template <int R>
__device__ __forceinline__ uint4 named_rows(const int* __restrict__ col_masks,
                                            int t, int row0) {
  const uint4* m = reinterpret_cast<const uint4*>(col_masks) + t * 2;
  if constexpr (R == kBlock) {
    const uint4 a = __ldg(m), b = __ldg(m + 1);
    return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  } else {
    return __ldg(m + row0 / 64);
  }
}

// The walk's work on one CTA: out [n, width] float32, every accumulator
// starting at `init` and folding its row's nonzero slots with Op
// (fold(acc, w, x); Op::kWeighted says whether it reads the tile value w).
template <typename Op, int R, int S, typename TT>
struct WalkWork {
  using Shape = WalkShape<R, S>;
  using Ring = WalkRing<R, S, TT, Op::kWeighted>;
  static constexpr int kCtaThreads = kWalkThreads;
  static constexpr bool kPadded = false;
  static constexpr int kTileBytes = Ring::kTileBytes;
  static constexpr int kMaskOffset = kTileBytes;
  static constexpr int kXOffset = kTileBytes + Ring::kMaskBytes;
  static constexpr int kStageBytes = Ring::kStageBytes;

  const TT* __restrict__ tiles;
  const float* __restrict__ x;
  const int* __restrict__ col_ids;
  const int* __restrict__ row_masks;
  const int* __restrict__ col_masks;
  float* __restrict__ out;
  int n, width, copy_bytes;
  float init;
  unsigned char* ring;
  uint64_t* bars;
  int rg, cv;
  float acc[Shape::kRowsPerThread][4];

  __device__ __forceinline__ void begin() {
#pragma unroll
    for (int i = 0; i < Shape::kRowsPerThread; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = init;
  }

  // A tile's copies: where it goes and which x rows it names.
  struct Desc {
    int t, row0, c0, xr0;
    uint4 rows;
  };

  __device__ __forceinline__ Desc describe(const Place& q, int t) const {
    return {t, q.row0, q.c0, __ldg(col_ids + t) * kBlock,
            named_rows<R>(col_masks, t, q.row0)};
  }

  __device__ __forceinline__ void issue(int s, const Desc& d) {
    unsigned char* base = ring + s * kStageBytes;
    stage_tile<R, S, kWalkThreads>(
        Op::kWeighted ? reinterpret_cast<TT*>(base) : nullptr, kBlock, tiles,
        d.t, d.row0, reinterpret_cast<float*>(base + kXOffset), S, x, d.xr0,
        d.c0, n, width, copy_bytes, d.rows, false, bars + s,
        reinterpret_cast<uint32_t*>(base + kMaskOffset), row_masks);
  }

  __device__ __forceinline__ void consume(int s) {
    const unsigned char* base = ring + s * kStageBytes;
    const TT* tile_s = reinterpret_cast<const TT*>(base);
    const uint32_t* masks =
        reinterpret_cast<const uint32_t*>(base + kMaskOffset);
    const float* x_s = reinterpret_cast<const float*>(base + kXOffset);
#pragma unroll
    for (int i = 0; i < Shape::kRowsPerThread; ++i) {
      const int r = rg + i * Shape::kRowsAtOnce;
      if (r < R) fold_row(acc[i], tile_s + r * kBlock, x_s,
                          *reinterpret_cast<const uint4*>(masks + r * kWords));
    }
  }

  // acc (this thread's 4 columns of one row) folds the row's set bits,
  // four slots' loads at a time.
  __device__ __forceinline__ void fold_row(float (&a)[4], const TT* trow,
                                           const float* x_s, uint4 mw) const {
    const uint32_t words[kWords] = {mw.x, mw.y, mw.z, mw.w};
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      uint32_t bits = words[q];
      while (bits) {
        constexpr int kBatch = 4;
        int sl[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          sl[u] = bits ? q * 32 + __ffs(bits) - 1 : -1;
          bits &= bits - 1;
        }
        float w[kBatch];
        float4 xv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (sl[u] >= 0) {
            w[u] = Op::kWeighted ? to_float(trow[sl[u]]) : 0.f;
            xv[u] = *reinterpret_cast<const float4*>(x_s + sl[u] * S + cv);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (sl[u] >= 0) {
            a[0] = Op::fold(a[0], w[u], xv[u].x);
            a[1] = Op::fold(a[1], w[u], xv[u].y);
            a[2] = Op::fold(a[2], w[u], xv[u].z);
            a[3] = Op::fold(a[3], w[u], xv[u].w);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void finish(const Place& p) {
    const int col = p.c0 + cv;
#pragma unroll
    for (int i = 0; i < Shape::kRowsPerThread; ++i) {
      const int r = rg + i * Shape::kRowsAtOnce;
      const int row = p.rb * kBlock + p.row0 + r;
      if (r >= R || row >= n || col >= width) continue;
      float* o = out + static_cast<long long>(row) * width + col;
      if (width % 4 == 0) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < width) o[e] = acc[i][e];
      }
    }
  }
};

template <typename Op, int R, int S, typename TT>
__global__ void __launch_bounds__(kWalkThreads, 1)
    walk_kernel(const TT* __restrict__ tiles, const float* __restrict__ x,
                const int* __restrict__ col_ids,
                const int* __restrict__ tile_off,
                const int* __restrict__ tile_cnt,
                const int* __restrict__ row_masks,
                const int* __restrict__ col_masks, float* __restrict__ out,
                int n_row_blocks, int n, int width, int copy_bytes,
                float init) {
  using Work = WalkWork<Op, R, S, TT>;
  using Ring = typename Work::Ring;
  extern __shared__ __align__(128) unsigned char smem[];
  Work w;
  w.tiles = tiles;
  w.x = x;
  w.col_ids = col_ids;
  w.row_masks = row_masks;
  w.col_masks = col_masks;
  w.out = out;
  w.n = n;
  w.width = width;
  w.copy_bytes = copy_bytes;
  w.init = init;
  w.bars = reinterpret_cast<uint64_t*>(smem);
  w.ring = smem + kBarBytes;
  w.rg = threadIdx.x / Work::Shape::kThreadsPerRow;
  w.cv = (threadIdx.x % Work::Shape::kThreadsPerRow) * 4;
  run_items<R, S, Ring::kStages>(w, n_row_blocks, width, copy_bytes,
                                 tile_off, tile_cnt, w.bars);
}

template <typename Op, typename TT>
cudaError_t launch_walk(const void* tiles, const void* x, const void* col_ids,
                        const void* tile_off, const void* tile_cnt,
                        const void* row_masks, const void* col_masks,
                        void* out, int n_row_blocks,
                        int n, int width, int rows, int slab, int copy_bytes,
                        float init, cudaStream_t stream) {
  return with_shape(rows, slab, [&](auto r, auto s) -> cudaError_t {
    constexpr int R = decltype(r)::value, S = decltype(s)::value;
    using Ring = WalkRing<R, S, TT, Op::kWeighted>;
    if constexpr (Ring::kStages < 2) {
      return cudaErrorInvalidValue;
    } else {
      constexpr int smem = Ring::kSmem;
      auto kernel = walk_kernel<Op, R, S, TT>;
      static int resident = 0;
      if (resident == 0) {
        const cudaError_t err =
            resident_ctas(kernel, smem, kWalkThreads, &resident);
        if (err != cudaSuccess) return err;
      }
      const int items = n_items<R, S>(n_row_blocks, width);
      if (items == 0) return cudaSuccess;
      kernel<<<items < resident ? items : resident, kWalkThreads, smem,
               stream>>>(
          static_cast<const TT*>(tiles), static_cast<const float*>(x),
          static_cast<const int*>(col_ids), static_cast<const int*>(tile_off),
          static_cast<const int*>(tile_cnt),
          static_cast<const int*>(row_masks),
          static_cast<const int*>(col_masks), static_cast<float*>(out),
          n_row_blocks, n, width, copy_bytes, init);
      return cudaGetLastError();
    }
  });
}

}  // namespace gnn_tiles
