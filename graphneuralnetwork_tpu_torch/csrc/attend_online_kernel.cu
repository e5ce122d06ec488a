// K4: hybrid GAT softmax attention (forward), for Hopper (sm_90a).
//
// For every receiver row r and head h, over the in-edges s -> r of the
// hybrid layout (the row's slots in its row block's dense tiles, then its
// COO remainder edges):
//
//   score  = LeakyReLU(f_dst[r,h] + f_src[s,h])
//   m[r,h] = max score over the live edges (tile slot != 0, remainder w > 0)
//   p      = w * exp(min(score - m, 0))            (w: tile count / weight)
//   den    = sum p;   num = sum p * keep * x[s, h, :]
//   out    = num / max(den, 1e-16)                 (in x's type)
//
// keep is the attention-dropout multiplier of the numerator only: for a tile
// slot head_keep(bits[t,i,j], h) / keep_prob from the tile's uint32 lattice,
// for a remainder edge keep_mul[e,h]. Rows without edges get out = 0,
// den = 0 and m = -1e30.
//
// Replaces the TPU kernels _attend_unrolled_kernel and _attend_2d_kernel of
// graphneuralnetwork_tpu/ops/pallas/attend_online_kernel.py
// (attend_online_pallas). The TPU kernel processes a 128-row block per grid
// step: it fetches receiver values with one-hot matmuls on its matrix unit,
// keeps an online softmax across 256-edge remainder chunks and tiles, and
// splits into a 2-D grid when a block's slots overflow its VMEM. None of
// that carries over: here one warp owns one receiver row and reads its
// values directly, so the softmax max is exact from a first pass over the
// row (LeakyReLU is monotone: max score = LeakyReLU(f_dst + max f_src)),
// and a row block with many tiles or chunks is just a longer loop.
//
// Bound: bytes, once per edge a gathered x row ([H*F] values) and once per
// tile the 128x128 store (and lattice); one exp per (edge, head), 2 flops
// per (edge, column). Design for it: each head's lane group reads its F
// columns of a gathered x row as adjacent runs and needs no other lane's
// value (attend_common.cuh); the tile row of the receiver is read as 4
// coalesced 32-slot words and walked by ballot, so empty slots cost no x
// read; no atomics, a fixed edge order, deterministic. A warp walks its
// row's edges in turn, so a hub row serialises (timed by chip_smoke.py's
// hub case); tensor cores and TMA are later work.

#include "attend_common.cuh"

namespace gnn_attend {
namespace {

struct OnlineArgs {
  const void* x;           // [n, hf] XT
  const float* fs;         // [n, heads]
  const float* fd;         // [n, heads]
  const void* tiles;       // [T, 128, 128] float or bf16
  const int* bits;         // [T, 128, 128] uint32 lattice, or null
  const int* col_ids;      // [T]
  const int* tile_off;     // [n_row_blocks]
  const int* tile_cnt;     // [n_row_blocks]
  const int* rem_senders;  // [E_pad] receiver-sorted remainder
  const int* rem_row_ptr;  // [n + 1]
  const float* rem_w;      // [E_pad]
  const float* keep_mul;   // [E_pad, heads], or null
  void* out;               // [n, hf] XT
  float* den;              // [n, heads]
  float* m;                // [n, heads]
  int n, heads, feat, tile_bf16, dropping;
  float slope, inv_keep;
  uint32_t thresh;
};

// acc[j] += pn * x_s[f] for this lane's columns f of its head.
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

template <typename XT, int CPL>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    attend_online_kernel(OnlineArgs a) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.n) return;   // uniform per warp
  const Lanes L = lane_layout(threadIdx.x & 31, a.heads);
  const int heads = a.heads, feat = a.feat, h = L.head;
  const long long hf = static_cast<long long>(heads) * feat;
  const XT* x = static_cast<const XT*>(a.x) + h * feat;   // head h's columns
  const float fd = a.fd[row * heads + h];
  const int rb = row / kRowBlock, ri = row % kRowBlock;
  const int t0 = a.tile_off[rb], t1 = t0 + a.tile_cnt[rb];
  const int e0 = a.rem_row_ptr[row], e1 = a.rem_row_ptr[row + 1];

  // pass 1: the exact shift, from the max f_src over live neighbours
  float mx = kNeg;
  for (int e = e0; e < e1; ++e) {
    if (a.rem_w[e] > 0.f) mx = fmaxf(mx, a.fs[a.rem_senders[e] * heads + h]);
  }
  for (int t = t0; t < t1; ++t) {
    const int cb = a.col_ids[t];
    const long long base = (static_cast<long long>(t) * kRowBlock + ri) *
                           kColBlock;
#pragma unroll
    for (int q = 0; q < kColBlock / 32; ++q) {
      const float wv = tile_val(a.tiles, a.tile_bf16,
                                base + q * 32 + (threadIdx.x & 31));
      unsigned nz = __ballot_sync(kFull, wv != 0.f);
      while (nz) {
        const int s = cb * kColBlock + q * 32 + __ffs(nz) - 1;
        nz &= nz - 1;
        mx = fmaxf(mx, a.fs[s * heads + h]);
      }
    }
  }
  const float m = mx > 0.5f * kNeg ? leaky(fd + mx, a.slope) : kNeg;

  // pass 2: softmax weights, denominator and dropped-out numerator
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  float den = 0.f;
  for (int e = e0; e < e1; ++e) {
    const int s = a.rem_senders[e];
    const float sc = leaky(fd + a.fs[s * heads + h], a.slope);
    const float p = a.rem_w[e] * expf(fminf(sc - m, 0.f));
    den += p;
    const float pn =
        a.dropping ? p * a.keep_mul[static_cast<long long>(e) * heads + h]
                   : p;
    accumulate<XT, CPL>(acc, pn, x + s * hf, L, feat);
  }
  for (int t = t0; t < t1; ++t) {
    const int cb = a.col_ids[t];
    const long long base = (static_cast<long long>(t) * kRowBlock + ri) *
                           kColBlock;
#pragma unroll
    for (int q = 0; q < kColBlock / 32; ++q) {
      const long long slot = base + q * 32 + (threadIdx.x & 31);
      const float wv = tile_val(a.tiles, a.tile_bf16, slot);
      const uint32_t bv =
          a.dropping && wv != 0.f ? static_cast<uint32_t>(a.bits[slot]) : 0u;
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
        accumulate<XT, CPL>(acc, pn, x + s * hf, L, feat);
      }
    }
  }

  if (!L.active) return;
  if (L.sub == 0) {
    a.den[row * heads + h] = den;
    a.m[row * heads + h] = m;
  }
  XT* out = static_cast<XT*>(a.out) + row * hf + h * feat;
  const float d = fmaxf(den, 1e-16f);
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int f = L.sub + L.group * j;
    if (f < feat) out[f] = from_float<XT>(acc[j] / d);
  }
}

template <typename XT>
cudaError_t launch(const OnlineArgs& a, int cpl, cudaStream_t stream) {
  const dim3 grid((a.n + kWarps - 1) / kWarps), block(kWarps * 32);
  switch (cpl) {
    case 1: attend_online_kernel<XT, 1><<<grid, block, 0, stream>>>(a); break;
    case 2: attend_online_kernel<XT, 2><<<grid, block, 0, stream>>>(a); break;
    case 4: attend_online_kernel<XT, 4><<<grid, block, 0, stream>>>(a); break;
    case 8: attend_online_kernel<XT, 8><<<grid, block, 0, stream>>>(a); break;
    case 16:
      attend_online_kernel<XT, 16><<<grid, block, 0, stream>>>(a);
      break;
    case 32:
      attend_online_kernel<XT, 32><<<grid, block, 0, stream>>>(a);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace gnn_attend

// x_bf16 / tile_bf16: 0 = float32, 1 = bfloat16. cpl: columns per lane,
// one of 1, 2, 4, 8, 16, 32, with cpl * (lanes per head) >= feat;
// heads <= 32.
// bits and keep_mul are read only when dropping. Returns the launch's
// cudaError_t.
extern "C" int gnn_attend_online(
    const void* x, const void* fs, const void* fd, const void* tiles,
    const void* bits, const void* col_ids, const void* tile_off,
    const void* tile_cnt, const void* rem_senders, const void* rem_row_ptr,
    const void* rem_w, const void* keep_mul, void* out, void* den, void* m,
    int n, int heads, int feat, int x_bf16, int tile_bf16, int cpl,
    float slope, float inv_keep, unsigned thresh, int dropping,
    void* stream) {
  using namespace gnn_attend;
  OnlineArgs a{x,
               static_cast<const float*>(fs),
               static_cast<const float*>(fd),
               tiles,
               static_cast<const int*>(bits),
               static_cast<const int*>(col_ids),
               static_cast<const int*>(tile_off),
               static_cast<const int*>(tile_cnt),
               static_cast<const int*>(rem_senders),
               static_cast<const int*>(rem_row_ptr),
               static_cast<const float*>(rem_w),
               static_cast<const float*>(keep_mul),
               out,
               static_cast<float*>(den),
               static_cast<float*>(m),
               n, heads, feat, tile_bf16, dropping,
               slope, inv_keep, thresh};
  if (n <= 0) return 0;
  if (!layout_ok(heads, feat, cpl))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(x_bf16 ? launch<__nv_bfloat16>(a, cpl, s)
                                 : launch<float>(a, cpl, s));
}
