// K8 and K9: the softmax partials of the three-pass hybrid GAT attend, for
// Hopper (sm_90a). K10, the tile pass seeded with K8's partials, walks the
// row stream of attend_walk.cuh (attend_fused_kernel.cu).
//
// With the shift m[r,h] given (the three-pass attend takes it from the
// neighbour max of f_src: K7 on the tiles, K2 on the remainder), every edge
// s -> r of a receiver row r contributes, per head h,
//
//   p    = w * exp(min(LeakyReLU(f_dst[r,h] + f_src[s,h]) - m[r,h], 0))
//   den += p;   num += p * keep * x[s, h, :]
//
//   gnn_rem_attend   (K8)  over the row's real COO remainder edges
//                          (w: edge weight; keep: keep_mul[e,h]);
//                          writes num [n, hf] and den [n, heads]
//   gnn_tile_parts   (K9)  over the row's nonzero slots in its row block's
//                          dense tiles (w: the tile count; keep:
//                          head_keep(bits[slot], h) / keep_prob);
//                          writes num and den
//
// Outputs are float32 and every row < n is written (zeros on a row without
// edges). The exponent is clamped at 0 whatever m is, as the TPU kernels
// clamp it.
//
// Replaces the TPU kernels _rem_attend_kernel
// (graphneuralnetwork_tpu/ops/pallas/rem_attend_kernel.py, rem_attend_pallas)
// and _attend_kernel (graphneuralnetwork_tpu/ops/bcsr_attention.py,
// _parts_pallas). A TPU grid step owns a 128-row block and one 1,024-edge
// remainder chunk or one dense tile: K8 fetches each edge's receiver values
// and scatters its terms with one-hot matmuls on the matrix unit, K9
// multiplies the whole 128x128 probability tile, zero slots included, with
// the x block. None of that carries over. The work is K4's second pass
// (attend_online_kernel.cu) split at the tile/remainder boundary: one warp
// owns one receiver row and reads its values directly, the remainder loop
// walks rem.row_ptr (the real edges only), and the tile loop turns each
// 32-slot word of the receiver's tile row into a __ballot_sync mask, so an
// empty slot reads no x.
//
// Bound: bytes, once per edge a gathered x row ([H*F] values) and for K9
// once per tile the receiver's 128-slot tile row (and lattice row); one exp
// per (edge, head) and 2 flops per (edge, column). Design for it: as K4's
// first design, each head's lane group reads its F columns of a gathered x
// row as adjacent runs and needs no other lane's value (attend_common.cuh);
// a head wider than the group's 32 columns a lane is walked in windows of
// that width, one warp a (row, window), each a walk of the row's edges (p
// recomputed, den written once); float32 sums in registers, no atomics, a
// fixed edge order, deterministic. A hub row serialises on its warp;
// tensor cores, TMA and hub-row splitting are later work.

#include "attend_common.cuh"

namespace gnn_attend {
namespace {

enum Mode { kRem = 0, kTiles = 1 };

struct PartsArgs {
  const void* x;           // [n, hf] XT
  const float* fs;         // [n, heads]
  const float* fd;         // [n, heads]
  const float* m;          // [n, heads]
  const void* tiles;       // [T, 128, 128] float or bf16 (K9)
  const int* bits;         // [T, 128, 128] uint32 lattice, or null
  const int* col_ids;      // [T]
  const int* tile_off;     // [n_row_blocks]
  const int* tile_cnt;     // [n_row_blocks]
  const int* rem_senders;  // [E_pad] receiver-sorted remainder (K8)
  const int* rem_row_ptr;  // [n + 1]
  const float* rem_w;      // [E_pad]
  const float* keep_mul;   // [E_pad, heads], or null
  float* num;              // [n, hf]
  float* den;              // [n, heads]
  int n, heads, feat, tile_bf16, dropping;
  float slope, inv_keep;
  uint32_t thresh;
  int windows;             // windows of a head (kWindows), else 1
};

// acc[j] += pn * x_s[f] for this lane's columns f of its head (of its
// window, below feat).
template <typename XT, int CPL>
__device__ __forceinline__ void accumulate(float (&acc)[CPL], float pn,
                                           const XT* xs, const Lanes& L,
                                           int feat) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int f = L.sub + L.group * j;
    if (L.active && f < feat) acc[j] += pn * to_float(xs[f]);
  }
}

// kWindows: a head wider than the lane group's CPL columns a lane (then
// CPL == 32) is walked in a.windows windows of that width, one warp a
// (row, window), each recomputing p; the window at c0 = 0 writes den. A
// template switch, so that the one-window instances keep their code
// (c0 is 0 there).
template <typename XT, int CPL, int MODE, bool kWindows>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    attend_parts_kernel(PartsArgs a) {
  const int warp_id = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int row = kWindows ? warp_id / a.windows : warp_id;
  if (row >= a.n) return;   // uniform per warp
  const Lanes L = lane_layout(threadIdx.x & 31, a.heads);
  const int heads = a.heads, feat = a.feat, h = L.head;
  const int c0 = kWindows ? warp_id % a.windows * L.group * CPL : 0;
  const int wfeat = feat - c0;   // the head's columns from the window's
  const long long hf = static_cast<long long>(heads) * feat;
  // head h's columns, from the window's first
  const XT* x = static_cast<const XT*>(a.x) + h * feat + c0;
  const long long out_base = row * hf + h * feat + c0;
  const float fd = a.fd[row * heads + h];
  const float m = a.m[row * heads + h];

  float acc[CPL];
  float den = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;

  if (MODE == kRem) {
    const int e0 = a.rem_row_ptr[row], e1 = a.rem_row_ptr[row + 1];
    for (int e = e0; e < e1; ++e) {
      const int s = a.rem_senders[e];
      const float sc = leaky(fd + a.fs[s * heads + h], a.slope);
      const float p = a.rem_w[e] * expf(fminf(sc - m, 0.f));
      den += p;
      const float pn =
          a.dropping ? p * a.keep_mul[static_cast<long long>(e) * heads + h]
                     : p;
      accumulate<XT, CPL>(acc, pn, x + s * hf, L, wfeat);
    }
  } else {
    // a row block without tiles runs no iteration
    const int rb = row / kRowBlock, ri = row % kRowBlock;
    const int t0 = a.tile_off[rb], t1 = t0 + a.tile_cnt[rb];
    for (int t = t0; t < t1; ++t) {
      const int cb = a.col_ids[t];
      const long long base = (static_cast<long long>(t) * kRowBlock + ri) *
                             kColBlock;
#pragma unroll
      for (int q = 0; q < kColBlock / 32; ++q) {
        const long long slot = base + q * 32 + (threadIdx.x & 31);
        const float wv = tile_val(a.tiles, a.tile_bf16, slot);
        const uint32_t bv =
            a.dropping && wv != 0.f ? static_cast<uint32_t>(a.bits[slot])
                                    : 0u;
        unsigned nz = __ballot_sync(kFull, wv != 0.f);
        while (nz) {
          const int l = __ffs(nz) - 1;
          nz &= nz - 1;
          const float w = __shfl_sync(kFull, wv, l);
          const uint32_t b = __shfl_sync(kFull, bv, l);
          const int s = cb * kColBlock + q * 32 + l;
          const float sc = leaky(fd + a.fs[s * heads + h], a.slope);
          const float p = w * expf(fminf(sc - m, 0.f));
          den += p;
          const float pn = !a.dropping ? p
                           : head_keep(b, h, a.thresh) ? p * a.inv_keep
                                                       : 0.f;
          accumulate<XT, CPL>(acc, pn, x + s * hf, L, wfeat);
        }
      }
    }
  }

  if (!L.active) return;
  if (L.sub == 0 && c0 == 0) a.den[row * heads + h] = den;
  float* out = a.num + out_base;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int f = L.sub + L.group * j;
    if (f < wfeat) out[f] = acc[j];
  }
}

template <typename XT, int MODE>
cudaError_t launch_typed(const PartsArgs& a, int cpl, cudaStream_t stream) {
  const dim3 grid((a.n * a.windows + kWarps - 1) / kWarps),
      block(kWarps * 32);
  switch (cpl) {
    case 1:
      attend_parts_kernel<XT, 1, MODE, false><<<grid, block, 0, stream>>>(a);
      break;
    case 2:
      attend_parts_kernel<XT, 2, MODE, false><<<grid, block, 0, stream>>>(a);
      break;
    case 4:
      attend_parts_kernel<XT, 4, MODE, false><<<grid, block, 0, stream>>>(a);
      break;
    case 8:
      attend_parts_kernel<XT, 8, MODE, false><<<grid, block, 0, stream>>>(a);
      break;
    case 16:
      attend_parts_kernel<XT, 16, MODE, false><<<grid, block, 0, stream>>>(a);
      break;
    case 32:
      if (a.windows > 1)
        attend_parts_kernel<XT, 32, MODE, true><<<grid, block, 0, stream>>>(a);
      else
        attend_parts_kernel<XT, 32, MODE, false>
            <<<grid, block, 0, stream>>>(a);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int MODE>
int launch(PartsArgs a, int x_bf16, int cpl, void* stream) {
  if (a.n <= 0) return 0;
  a.windows = windows(a.heads, a.feat, cpl);
  if (a.windows < 1 || (a.windows > 1 && cpl != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(x_bf16 ? launch_typed<__nv_bfloat16, MODE>(a, cpl, s)
                                 : launch_typed<float, MODE>(a, cpl, s));
}

// The fields every entry sets the same way.
PartsArgs common_args(const void* x, const void* fs, const void* fd,
                      const void* m, int n, int heads, int feat,
                      int tile_bf16, float slope, float inv_keep,
                      unsigned thresh, int dropping) {
  PartsArgs a{};
  a.x = x;
  a.fs = static_cast<const float*>(fs);
  a.fd = static_cast<const float*>(fd);
  a.m = static_cast<const float*>(m);
  a.n = n;
  a.heads = heads;
  a.feat = feat;
  a.tile_bf16 = tile_bf16;
  a.dropping = dropping;
  a.slope = slope;
  a.inv_keep = inv_keep;
  a.thresh = thresh;
  return a;
}

}  // namespace
}  // namespace gnn_attend

// The trailing scalars of every entry: x_bf16 / tile_bf16: 0 = float32,
// 1 = bfloat16; cpl: columns per lane, one of 1, 2, 4, 8, 16, 32, with
// cpl * (lanes per head) >= feat, or 32 for a head wider than that, which
// is walked in windows; heads <= 32. keep_mul (K8) and bits (K9) are read
// only when dropping. Each returns the launch's cudaError_t.

extern "C" int gnn_rem_attend(
    const void* x, const void* fs, const void* fd, const void* m,
    const void* rem_senders, const void* rem_row_ptr, const void* rem_w,
    const void* keep_mul, void* num, void* den,
    int n, int heads, int feat, int x_bf16, int tile_bf16, int cpl,
    float slope, float inv_keep, unsigned thresh, int dropping,
    void* stream) {
  using namespace gnn_attend;
  PartsArgs a = common_args(x, fs, fd, m, n, heads, feat, tile_bf16, slope,
                            inv_keep, thresh, dropping);
  a.rem_senders = static_cast<const int*>(rem_senders);
  a.rem_row_ptr = static_cast<const int*>(rem_row_ptr);
  a.rem_w = static_cast<const float*>(rem_w);
  a.keep_mul = static_cast<const float*>(keep_mul);
  a.num = static_cast<float*>(num);
  a.den = static_cast<float*>(den);
  return launch<kRem>(a, x_bf16, cpl, stream);
}

extern "C" int gnn_tile_parts(
    const void* x, const void* fs, const void* fd, const void* m,
    const void* tiles, const void* bits, const void* col_ids,
    const void* tile_off, const void* tile_cnt, void* num, void* den,
    int n, int heads, int feat, int x_bf16, int tile_bf16, int cpl,
    float slope, float inv_keep, unsigned thresh, int dropping,
    void* stream) {
  using namespace gnn_attend;
  PartsArgs a = common_args(x, fs, fd, m, n, heads, feat, tile_bf16, slope,
                            inv_keep, thresh, dropping);
  a.tiles = tiles;
  a.bits = static_cast<const int*>(bits);
  a.col_ids = static_cast<const int*>(col_ids);
  a.tile_off = static_cast<const int*>(tile_off);
  a.tile_cnt = static_cast<const int*>(tile_cnt);
  a.num = static_cast<float*>(num);
  a.den = static_cast<float*>(den);
  return launch<kTiles>(a, x_bf16, cpl, stream);
}
