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
// Replaces the TPU kernels _bwd_a_kernel (pass A) and _bwd_b_kernel (pass
// B) of graphneuralnetwork_tpu/ops/pallas/attend_bwd_kernel.py
// (attend_bwd_a_pallas, attend_bwd_b_pallas). There each 128-row block
// contracts q and dx on the matrix unit and fetches row-side values with
// one-hot matmuls. Here, as in K4, one warp owns one row and walks its
// edges: q is a sum over each head's lane group of the lanes' column
// products, and every output element has one owner, so there are no
// atomics and the result is deterministic.
//
// Bound: bytes, once per edge two gathered [H*F] rows (x and gn in pass A;
// gn in pass B, whose x row is the owner's) and once per tile its store and
// lattice; one exp per (edge, head) and 2 (A) or 4 (B) flops per
// (edge, column). A hub row serialises in one warp, as in K4.

#include "attend_common.cuh"

namespace gnn_attend {
namespace {

struct BwdArgs {
  const void* x;           // [n, hf] XT
  const void* gn;          // [n, hf] XT
  const float* fs;         // [n, heads]
  const float* fdm3;       // [n, 3 * heads]
  const void* tiles;       // [T, 128, 128] (pass B: transpose tiles)
  const int* bits;         // forward lattice [T_fwd, 128, 128], or null
  const int* bits_tmap;    // pass B: forward tile of each transpose tile
  const int* col_ids;      // [T]
  const int* tile_off;     // [n_row_blocks]
  const int* tile_cnt;     // [n_row_blocks]
  const int* rem_cols;     // [E_pad] the other endpoint of each edge
  const int* rem_row_ptr;  // [n + 1]
  const float* rem_w;      // [E_pad]
  const int* rem_eperm;    // pass B: keep_mul row of each edge
  const float* keep_mul;   // [E_pad_fwd, heads], or null
  void* dx;                // pass B: [n, hf] XT
  float* dhead;            // pass A: dfd, pass B: dfs; [n, heads]
  int n, heads, feat, tile_bf16, dropping;
  float slope, inv_keep;
  uint32_t thresh;
};

// Pass A (TRANSPOSE = false) or pass B (TRANSPOSE = true) for one row.
template <typename XT, int CPL, bool TRANSPOSE>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks) attend_bwd_kernel(BwdArgs a) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.n) return;   // uniform per warp
  const Lanes L = lane_layout(threadIdx.x & 31, a.heads);
  const int heads = a.heads, feat = a.feat, h = L.head;
  const long long hf = static_cast<long long>(heads) * feat;
  // head h's columns of x and gn
  const XT* x = static_cast<const XT*>(a.x) + h * feat;
  const XT* gn = static_cast<const XT*>(a.gn) + h * feat;

  // the row's own values: pass A the receiver's gn and f_dst/m/dden, pass
  // B the sender's x and f_src
  float own[CPL];
  const XT* own_row = (TRANSPOSE ? x : gn) + row * hf;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int f = L.sub + L.group * j;
    own[j] = L.active && f < feat ? to_float(own_row[f]) : 0.f;
  }
  const float* r3 = a.fdm3 + static_cast<long long>(row) * 3 * heads;
  const float fd = r3[h], m = r3[heads + h], dd = r3[2 * heads + h];
  const float fs = a.fs[row * heads + h];
  float acc[CPL];   // pass B: dx
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  float dhead = 0.f;

  // one edge between this row and node `col` with weight w and numerator
  // multiplier keep (1 without dropout)
  auto edge = [&](int col, float w, float keep) {
    const XT* other = (TRANSPOSE ? gn : x) + col * hf;
    float oth[CPL];
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int f = L.sub + L.group * j;
      oth[j] = L.active && f < feat ? to_float(other[f]) : 0.f;
      part += own[j] * oth[j];
    }
    const float q = group_sum(part, L.group);   // gn_r . x_s of head h
    float pre, em, edd;
    if (TRANSPOSE) {
      const float* c3 = a.fdm3 + static_cast<long long>(col) * 3 * heads;
      pre = fs + c3[h];
      em = c3[heads + h];
      edd = c3[2 * heads + h];
    } else {
      pre = fd + a.fs[col * heads + h];
      em = m;
      edd = dd;
    }
    const float p = w * expf(fminf(leaky(pre, a.slope) - em, 0.f));
    dhead += p * (q * keep + edd) * leaky_grad(pre, a.slope);
    if (TRANSPOSE) {
      const float pn = p * keep;
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[j] += pn * oth[j];
    }
  };

  const int e0 = a.rem_row_ptr[row], e1 = a.rem_row_ptr[row + 1];
  for (int e = e0; e < e1; ++e) {
    float keep = 1.f;
    if (a.dropping) {
      const long long ke = TRANSPOSE ? a.rem_eperm[e] : e;
      keep = a.keep_mul[ke * heads + h];
    }
    edge(a.rem_cols[e], a.rem_w[e], keep);
  }
  const int rb = row / kRowBlock, ri = row % kRowBlock;
  const int t0 = a.tile_off[rb], t1 = t0 + a.tile_cnt[rb];
  for (int t = t0; t < t1; ++t) {
    const int cb = a.col_ids[t];
    const long long base = (static_cast<long long>(t) * kRowBlock + ri) *
                           kColBlock;
    const long long tf = TRANSPOSE && a.dropping ? a.bits_tmap[t] : t;
#pragma unroll
    for (int q = 0; q < kColBlock / 32; ++q) {
      const int j = q * 32 + (threadIdx.x & 31);
      const float wv = tile_val(a.tiles, a.tile_bf16, base + j);
      uint32_t bv = 0u;
      if (a.dropping && wv != 0.f) {
        // pass B reads the forward tile's lattice transposed
        const long long slot =
            TRANSPOSE ? (tf * kRowBlock + j) * kColBlock + ri : base + j;
        bv = static_cast<uint32_t>(a.bits[slot]);
      }
      unsigned nz = __ballot_sync(kFull, wv != 0.f);
      while (nz) {
        const int l = __ffs(nz) - 1;
        nz &= nz - 1;
        const float w = __shfl_sync(kFull, wv, l);
        const uint32_t b = __shfl_sync(kFull, bv, l);
        const float keep = !a.dropping ? 1.f
                           : head_keep(b, h, a.thresh) ? a.inv_keep
                                                       : 0.f;
        edge(cb * kColBlock + q * 32 + l, w, keep);
      }
    }
  }

  if (!L.active) return;
  if (L.sub == 0) a.dhead[row * heads + h] = dhead;
  if (TRANSPOSE) {
    XT* dx = static_cast<XT*>(a.dx) + row * hf + h * feat;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int f = L.sub + L.group * j;
      if (f < feat) dx[f] = from_float<XT>(acc[j]);
    }
  }
}

template <typename XT, bool TRANSPOSE>
cudaError_t launch(const BwdArgs& a, int cpl, cudaStream_t stream) {
  const dim3 grid((a.n + kWarps - 1) / kWarps), block(kWarps * 32);
  switch (cpl) {
    case 1:
      attend_bwd_kernel<XT, 1, TRANSPOSE><<<grid, block, 0, stream>>>(a);
      break;
    case 2:
      attend_bwd_kernel<XT, 2, TRANSPOSE><<<grid, block, 0, stream>>>(a);
      break;
    case 4:
      attend_bwd_kernel<XT, 4, TRANSPOSE><<<grid, block, 0, stream>>>(a);
      break;
    case 8:
      attend_bwd_kernel<XT, 8, TRANSPOSE><<<grid, block, 0, stream>>>(a);
      break;
    case 16:
      attend_bwd_kernel<XT, 16, TRANSPOSE><<<grid, block, 0, stream>>>(a);
      break;
    case 32:
      attend_bwd_kernel<XT, 32, TRANSPOSE><<<grid, block, 0, stream>>>(a);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int dispatch(const BwdArgs& a, int x_bf16, int cpl, bool transpose,
             void* stream) {
  if (a.n <= 0) return 0;
  if (!layout_ok(a.heads, a.feat, cpl))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (transpose)
    err = x_bf16 ? launch<__nv_bfloat16, true>(a, cpl, s)
                 : launch<float, true>(a, cpl, s);
  else
    err = x_bf16 ? launch<__nv_bfloat16, false>(a, cpl, s)
                 : launch<float, false>(a, cpl, s);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace gnn_attend

// Pass A: dfd [n, heads] over the forward tiles and the receiver-sorted
// remainder (rem_senders, rem_row_ptr, rem_w). x_bf16 / tile_bf16: 0 =
// float32, 1 = bfloat16; cpl as in gnn_attend_online. Returns the launch's
// cudaError_t.
extern "C" int gnn_attend_bwd_a(
    const void* x, const void* gn, const void* fs, const void* fdm3,
    const void* tiles, const void* bits, const void* col_ids,
    const void* tile_off, const void* tile_cnt, const void* rem_senders,
    const void* rem_row_ptr, const void* rem_w, const void* keep_mul,
    void* dfd, int n, int heads, int feat, int x_bf16, int tile_bf16,
    int cpl, float slope, float inv_keep, unsigned thresh, int dropping,
    void* stream) {
  using namespace gnn_attend;
  BwdArgs a{x, gn,
            static_cast<const float*>(fs),
            static_cast<const float*>(fdm3),
            tiles,
            static_cast<const int*>(bits),
            nullptr,
            static_cast<const int*>(col_ids),
            static_cast<const int*>(tile_off),
            static_cast<const int*>(tile_cnt),
            static_cast<const int*>(rem_senders),
            static_cast<const int*>(rem_row_ptr),
            static_cast<const float*>(rem_w),
            nullptr,
            static_cast<const float*>(keep_mul),
            nullptr,
            static_cast<float*>(dfd),
            n, heads, feat, tile_bf16, dropping, slope, inv_keep, thresh};
  return dispatch(a, x_bf16, cpl, false, stream);
}

// Pass B: dx [n, heads*feat] (x's type) and dfs [n, heads] over the
// transpose tiles (tiles_t, col_ids_t, tile_off_t, tile_cnt_t) and the
// sender-sorted remainder (remt_receivers: each edge's receiver,
// remt_row_ptr over senders, remt_w, remt_eperm). bits is the FORWARD
// lattice, read through bits_tmap; keep_mul the forward multiplier, read
// through remt_eperm.
extern "C" int gnn_attend_bwd_b(
    const void* x, const void* gn, const void* fs, const void* fdm3,
    const void* tiles_t, const void* bits, const void* bits_tmap,
    const void* col_ids_t, const void* tile_off_t, const void* tile_cnt_t,
    const void* remt_receivers, const void* remt_row_ptr,
    const void* remt_w, const void* remt_eperm, const void* keep_mul,
    void* dx, void* dfs, int n, int heads, int feat, int x_bf16,
    int tile_bf16, int cpl, float slope, float inv_keep, unsigned thresh,
    int dropping, void* stream) {
  using namespace gnn_attend;
  BwdArgs a{x, gn,
            static_cast<const float*>(fs),
            static_cast<const float*>(fdm3),
            tiles_t,
            static_cast<const int*>(bits),
            static_cast<const int*>(bits_tmap),
            static_cast<const int*>(col_ids_t),
            static_cast<const int*>(tile_off_t),
            static_cast<const int*>(tile_cnt_t),
            static_cast<const int*>(remt_receivers),
            static_cast<const int*>(remt_row_ptr),
            static_cast<const float*>(remt_w),
            static_cast<const int*>(remt_eperm),
            static_cast<const float*>(keep_mul),
            dx,
            static_cast<float*>(dfs),
            n, heads, feat, tile_bf16, dropping, slope, inv_keep, thresh};
  return dispatch(a, x_bf16, cpl, true, stream);
}
