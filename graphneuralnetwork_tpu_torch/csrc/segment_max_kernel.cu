// K2: receiver-sorted CSR segment max of edge scores, for Hopper (sm_90a).
//
//   out[r, h] = max(empty, max over e in [row_ptr[r], row_ptr[r+1]) of
//                          scores[e, h])
//
// scores float32 [E_pad, H], row_ptr int32 [N+1]; out float32 [N, H]. A row
// with no edges gets the sentinel `empty` (-3e38 from the caller). Edges
// past row_ptr[N] (a graph's padding, masked) are not read.
//
// Replaces the TPU kernel _segmax_kernel of
// graphneuralnetwork_tpu/ops/pallas/segment_max_kernel.py (launched by
// segment_max_pallas), which masked every 1024-edge chunk against every row
// of its 128-row block. Here each output element has one owner and reads
// only its row's edges.
//
// Bound: bytes (one compare per score read). One thread per (row, head):
// the H threads of a row are neighbours, so an edge's H scores are one
// contiguous read, and H = 8 puts four rows in a warp. No atomics; a NaN
// score propagates, as jnp.maximum does.

#include <cuda_runtime.h>

namespace {

__global__ void segment_max_kernel(const float* __restrict__ scores,
                                   const int* __restrict__ row_ptr,
                                   float* __restrict__ out, int n_rows,
                                   int n_cols, float empty) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(n_rows) * n_cols) return;
  const int row = static_cast<int>(t / n_cols);
  const int col = static_cast<int>(t - static_cast<long long>(row) * n_cols);
  const int lo = __ldg(row_ptr + row);
  const int hi = __ldg(row_ptr + row + 1);
  float m = empty;
  const float* p = scores + static_cast<long long>(lo) * n_cols + col;
  for (int e = lo; e < hi; ++e, p += n_cols) {
    const float s = __ldg(p);
    m = (s > m || s != s) ? s : m;
  }
  out[t] = m;
}

}  // namespace

// Returns the launch's cudaError_t.
extern "C" int gnn_segment_max(const void* scores, const void* row_ptr,
                               void* out, int n_rows, int n_cols, float empty,
                               void* stream) {
  constexpr int kBlock = 256;
  const long long threads = static_cast<long long>(n_rows) * n_cols;
  const long long grid = (threads + kBlock - 1) / kBlock;
  segment_max_kernel<<<static_cast<unsigned>(grid), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const int*>(row_ptr),
      static_cast<float*>(out), n_rows, n_cols, empty);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
