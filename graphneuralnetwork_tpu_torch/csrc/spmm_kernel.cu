// K1: receiver-sorted CSR segment sum, for Hopper (sm_90a).
//
//   out[r, :] = sum over e in [row_ptr[r], row_ptr[r+1]) of values[e, :]
//
// values [E_pad, F] in float32 or bfloat16, row_ptr int32 [N+1]; out [N, F]
// in the input type, accumulated in float32. Edges past row_ptr[N] (a
// graph's padding, zero-valued) are not read.
//
// Replaces the TPU kernels _spmm_kernel_hilo and _spmm_kernel_bf16 of
// graphneuralnetwork_tpu/ops/pallas/spmm_kernel.py (launched by
// _spmm_pallas_call). The TPU kernel turned the scatter into a one-hot
// matmul on its matrix unit, and split float32 into two bfloat16 halves to
// keep precision. Here every output element has one owner, so neither is
// needed: the sum is a plain float32 loop over the row's edges.
//
// Bound: bytes. Each edge value is read once and each output written once,
// one add per value read. Design for that:
//   * one thread per (row, vector of VEC columns); a row's F/VEC threads
//     are neighbours in a warp, so each edge row is read as one contiguous,
//     coalesced run of 16-byte loads (F = 128 float32: one warp per row);
//   * narrow F (7, 8, 1) packs several rows into one warp with VEC = 1;
//   * no atomics and a fixed edge order: the result is deterministic.
// Fusing the gather x[senders] * w into the loop is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int VEC>
__global__ void segment_sum_kernel(const T* __restrict__ values,
                                   const int* __restrict__ row_ptr,
                                   T* __restrict__ out, int n_rows,
                                   int n_cols) {
  const int chunks = n_cols / VEC;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(n_rows) * chunks) return;
  const int row = static_cast<int>(t / chunks);
  const int col = static_cast<int>(t - static_cast<long long>(row) * chunks) *
                  VEC;
  const int lo = __ldg(row_ptr + row);
  const int hi = __ldg(row_ptr + row + 1);

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  const T* p = values + static_cast<long long>(lo) * n_cols + col;
  for (int e = lo; e < hi; ++e, p += n_cols) {
    const Pack<T, VEC> v = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += to_float(v.v[k]);
  }
  Pack<T, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) o.v[k] = from_float<T>(acc[k]);
  *reinterpret_cast<Pack<T, VEC>*>(
      out + static_cast<long long>(row) * n_cols + col) = o;
}

template <typename T, int VEC>
cudaError_t launch(const void* values, const int* row_ptr, void* out,
                   int n_rows, int n_cols, cudaStream_t stream) {
  constexpr int kBlock = 256;
  const long long threads = static_cast<long long>(n_rows) * (n_cols / VEC);
  const long long grid = (threads + kBlock - 1) / kBlock;
  segment_sum_kernel<T, VEC><<<static_cast<unsigned>(grid), kBlock, 0,
                               stream>>>(static_cast<const T*>(values),
                                         row_ptr, static_cast<T*>(out),
                                         n_rows, n_cols);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec: columns per thread; the caller
// guarantees that n_cols % vec == 0 and that both base pointers are aligned
// to vec elements. Returns the launch's cudaError_t.
extern "C" int gnn_segment_sum(const void* values, const void* row_ptr,
                               void* out, int n_rows, int n_cols, int dtype,
                               int vec, void* stream) {
  const int* rp = static_cast<const int*>(row_ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (vec) {
      case 1: return launch<float, 1>(values, rp, out, n_rows, n_cols, s);
      case 2: return launch<float, 2>(values, rp, out, n_rows, n_cols, s);
      case 4: return launch<float, 4>(values, rp, out, n_rows, n_cols, s);
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 1:
        return launch<__nv_bfloat16, 1>(values, rp, out, n_rows, n_cols, s);
      case 2:
        return launch<__nv_bfloat16, 2>(values, rp, out, n_rows, n_cols, s);
      case 4:
        return launch<__nv_bfloat16, 4>(values, rp, out, n_rows, n_cols, s);
      case 8:
        return launch<__nv_bfloat16, 8>(values, rp, out, n_rows, n_cols, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
