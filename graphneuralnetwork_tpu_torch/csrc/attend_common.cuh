// Helpers shared by the hybrid GAT attend kernels (attend_online_kernel.cu,
// attend_bwd_kernel.cu, attend_fused_kernel.cu), for Hopper (sm_90a): the
// tile and block sizes, LeakyReLU and its derivative, the tile store's
// values and the dropout hash. The row walk they share is attend_walk.cuh.

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

}  // namespace gnn_attend

extern "C" const char* gnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
