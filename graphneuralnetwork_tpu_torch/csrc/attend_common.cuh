// Helpers shared by the hybrid GAT attend kernels (attend_online_kernel.cu,
// attend_bwd_kernel.cu, attend_parts_kernel.cu, attend_fused_kernel.cu),
// for Hopper (sm_90a).
//
// The lane groups (Lanes, lane_layout, windows) are the layout of K8 and
// K9, which give one warp to one receiver row of the hybrid layout
// (core/bcsr.py); K4-K6 and K10 walk rows in slabs (attend_walk.cuh). The
// warp's lanes split into one group per head: G = 32 / Hp lanes each, Hp
// the head count rounded up to a power of two. Lane g of head h's group
// owns the feature columns f = c0 + g + G*j (j < CPL) of that head, c0 its
// warp's window (0, unless the head is wider than G * 32 columns: then each
// window of G * 32 takes a warp), and computes the head's per-edge scalars
// (score, softmax weight, dropout mask) itself. No column needs another
// lane's value, so no shuffle runs per column.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gnn_attend {

constexpr int kRowBlock = 128;   // receiver rows per tile
constexpr int kColBlock = 128;   // sender columns per tile
constexpr int kWarps = 8;        // warps (rows) per thread block
// Blocks per SM the register budget must allow: the kernels wait on
// dependent loads, so resident warps set their speed.
constexpr int kMinBlocks = 2;
constexpr float kNeg = -1e30f;   // "-inf" that survives float arithmetic
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v > 0.f ? v : slope * v;
}

__device__ __forceinline__ float leaky_grad(float v, float slope) {
  return v > 0.f ? 1.f : slope;
}

// Tile slot value as float; tile_bf16 selects the store's type.
__device__ __forceinline__ float tile_val(const void* tiles, int tile_bf16,
                                          long long idx) {
  return tile_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(tiles)[idx])
             : static_cast<const float*>(tiles)[idx];
}

// Per-head Bernoulli(keep) from the tile's shared uint32 lattice: the exact
// hash of ops/bcsr_attention.py:_head_keep (odd per-head multiplier, then
// xorshift-multiply rounds), in native wrapping uint32 arithmetic.
__device__ __forceinline__ bool head_keep(uint32_t bits, int h,
                                          uint32_t thresh) {
  uint32_t v = bits * (0x9E3779B1u * (2u * static_cast<uint32_t>(h) + 1u));
  v ^= v >> 13;
  v *= 0x5BD1E995u;
  v ^= v >> 15;
  return v < thresh;
}

// This lane's place in the per-head lane groups.
struct Lanes {
  int head;     // the head this lane works for (0 on idle lanes)
  int sub;      // its index in the head's group
  int group;    // lanes per head: 32 / (heads rounded up to a power of 2)
  bool active;  // false on the lanes past the last head
};

__device__ __forceinline__ Lanes lane_layout(int lane, int heads) {
  int padded = 1;
  while (padded < heads) padded <<= 1;
  const int group = 32 / padded;
  const int head = lane / group;
  return {head < heads ? head : 0, lane % group, group, head < heads};
}

// Windows of (32 / Hp) * cpl columns that cover a head of feat columns
// (Hp: heads rounded up to a power of two); 0 where heads or cpl is not
// one the kernels take.
__host__ __forceinline__ int windows(int heads, int feat, int cpl) {
  if (heads < 1 || heads > 32 || feat < 1 || cpl < 1 || cpl > 32) return 0;
  int padded = 1;
  while (padded < heads) padded <<= 1;
  const int width = (32 / padded) * cpl;
  return (feat + width - 1) / width;
}

}  // namespace gnn_attend

extern "C" const char* gnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
