// Column sums of a float32 [M, F] array, the device-memory read-bandwidth
// probe of the port, for Hopper (sm_90a).
//
//   out[k, c] = sum over r of x[r, c]     for k = 0 ... 7
//
// x float32 [M, F], contiguous, F a multiple of 4 up to 1,024, 16-byte
// aligned; out float32 [8, F] (every row the same column sums, as the TPU
// kernels write them); partials float32 [n_ctas, F], scratch.
//
// Replaces the TPU kernels of tools/bench_dma.py: reduce_auto (a grid over
// 1,024-row chunks through the automatic BlockSpec pipeline, the sum
// carried in the output block from one grid step to the next) and
// reduce_manual (one program keeping n_buffers chunk DMAs in flight into a
// VMEM ring). Neither carries over as written: CTAs run in parallel and in
// no order, so nothing is carried between them, and a CTA has at most
// 227 KB of shared memory, not the TPU's megabytes of VMEM.
//
// Bound: bytes. Each input byte is read once and one add is done per value
// read; the output is 32 F bytes. Two designs, the counterparts of the two
// TPU kernels:
//   * row_sum_stream_kernel: a grid of CTAs over contiguous row ranges,
//     (F/4) x R threads (R rows a step, 256 threads); each thread keeps
//     kUnroll 16-byte loads of its column vector in flight and sums them
//     into kUnroll float4 accumulators. The loads bypass L1 and are marked
//     evict-first (__ldcs): nothing is read twice.
//   * row_sum_ring_kernel<kSlots>: persistent CTAs (one or two an SM, as
//     the host decides), each walking its contiguous chunks of slot_rows
//     rows through a ring of kSlots shared-memory slots. Thread 0 fills a
//     slot with one bulk copy of the Tensor Memory Accelerator
//     (cp.async.bulk) that completes on the slot's mbarrier, keeping kSlots
//     copies in flight; every thread folds a landed slot from shared
//     memory; after a barrier the slot takes the chunk kSlots ahead. The
//     helpers are tile_walk.cuh's (mbar_init, mbar_expect_tx, mbar_wait,
//     bulk_copy).
// Both end with the CTA's rows folded in a fixed order into one partial
// row of F sums, and row_sum_finish_kernel adds the partial rows in order
// (a thread per column) and writes the 8 output rows. No atomics: the
// result is the same from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_walk.cuh"

namespace {

using gnn_tiles::bulk_copy;
using gnn_tiles::kBarBytes;
using gnn_tiles::kMaxSmem;
using gnn_tiles::mbar_expect_tx;
using gnn_tiles::mbar_init;
using gnn_tiles::mbar_wait;

constexpr int kThreads = 256;   // a CTA: (F/4) x R threads
constexpr int kUnroll = 4;      // the stream kernel's loads in flight
constexpr int kOutRows = 8;     // the TPU kernels' [8, F] output
constexpr int kFinishThreads = 128;
// fold_cta's static shared memory, beside a ring's dynamic slots
constexpr int kStaticSmem = kThreads * 16;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// The CTA's (F/4) x R accumulators folded over its R rows in order into
// partials[blockIdx.x, :].
__device__ __forceinline__ void fold_cta(float4 acc, float* partials,
                                         int lanes) {
  __shared__ float4 red[kThreads];
  const int tx = threadIdx.x, ty = threadIdx.y;
  red[ty * lanes + tx] = acc;
  __syncthreads();
  if (ty == 0) {
    float4 s = red[tx];
    for (int r = 1; r < blockDim.y; ++r) add4(s, red[r * lanes + tx]);
    reinterpret_cast<float4*>(partials)[
        static_cast<long long>(blockIdx.x) * lanes + tx] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    row_sum_stream_kernel(const float4* __restrict__ x,
                          float* __restrict__ partials, int m,
                          int rows_per_cta) {
  const int lanes = blockDim.x, rows_step = blockDim.y;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long r1 = r0 + rows_per_cta < m ? r0 + rows_per_cta : m;
  float4 acc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  long long r = r0 + threadIdx.y;
  const float4* p = x + r * lanes + threadIdx.x;
  const long long step = static_cast<long long>(rows_step) * lanes;
  for (; r + (kUnroll - 1) * rows_step < r1; r += kUnroll * rows_step) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(p + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add4(acc[u], v[u]);
    p += kUnroll * step;
  }
  for (; r < r1; r += rows_step, p += step) add4(acc[0], __ldcs(p));
#pragma unroll
  for (int u = 1; u < kUnroll; ++u) add4(acc[0], acc[u]);
  fold_cta(acc[0], partials, lanes);
}

// Shared memory: kBarBytes of mbarriers, then kSlots slots of slot_rows
// rows of F floats.
template <int kSlots>
__global__ void __launch_bounds__(kThreads)
    row_sum_ring_kernel(const float* __restrict__ x,
                        float* __restrict__ partials, int m, int f,
                        int slot_rows, int chunks_per_cta) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float4* slots = reinterpret_cast<float4*>(smem + kBarBytes);
  const int lanes = blockDim.x, rows_step = blockDim.y;
  const int tid = threadIdx.y * lanes + threadIdx.x;
  const int slot_vecs = slot_rows * lanes;
  const long long n_chunks = (m + slot_rows - 1) / slot_rows;
  const long long c0 = static_cast<long long>(blockIdx.x) * chunks_per_cta;
  const int n = static_cast<int>(
      c0 + chunks_per_cta < n_chunks ? chunks_per_cta : n_chunks - c0);
  // rows of the CTA's i-th chunk (the last chunk of x may be short)
  auto chunk_rows = [&](int i) {
    const long long left = m - (c0 + i) * slot_rows;
    return static_cast<int>(left < slot_rows ? left : slot_rows);
  };
  // chunk i into slot i % kSlots: one bulk copy, its bytes expected on the
  // slot's barrier by the same arrival (thread 0 only)
  auto issue = [&](int i) {
    const unsigned bytes =
        static_cast<unsigned>(chunk_rows(i)) * static_cast<unsigned>(f) * 4u;
    uint64_t* bar = bars + i % kSlots;
    mbar_expect_tx(bar, bytes);
    bulk_copy(slots + (i % kSlots) * slot_vecs,
              x + (c0 + i) * slot_rows * static_cast<long long>(f), bytes,
              bar);
  };
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < kSlots && i < n; ++i) issue(i);
  float4 acc0 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc1 = acc0;
  for (int i = 0; i < n; ++i) {
    mbar_wait(bars + i % kSlots, (i / kSlots) & 1);
    const float4* slot = slots + (i % kSlots) * slot_vecs;
    const int rows = chunk_rows(i);
    int r = threadIdx.y;
    for (; r + rows_step < rows; r += 2 * rows_step) {
      const float4 a = slot[r * lanes + threadIdx.x];
      const float4 b = slot[(r + rows_step) * lanes + threadIdx.x];
      add4(acc0, a);
      add4(acc1, b);
    }
    if (r < rows) add4(acc0, slot[r * lanes + threadIdx.x]);
    __syncthreads();   // every thread is done with the slot
    if (tid == 0 && i + kSlots < n) issue(i + kSlots);
  }
  add4(acc0, acc1);
  fold_cta(acc0, partials, lanes);
}

__global__ void row_sum_finish_kernel(const float* __restrict__ partials,
                                      float* __restrict__ out, int n_parts,
                                      int f) {
  const int c = blockIdx.x * kFinishThreads + threadIdx.x;
  if (c >= f) return;
  float s = 0.f;
#pragma unroll 8
  for (int p = 0; p < n_parts; ++p) s += partials[static_cast<long long>(p) * f + c];
#pragma unroll
  for (int k = 0; k < kOutRows; ++k) out[k * f + c] = s;
}

// The block (F/4 lanes x R rows) of both kernels; false where F is not
// supported (the host raises first).
bool block_of(int f, dim3* block) {
  if (f < 4 || f % 4 || f / 4 > kThreads) return false;
  const int lanes = f / 4;
  *block = dim3(lanes, kThreads / lanes);
  return true;
}

cudaError_t finish(const float* partials, float* out, int n_parts, int f,
                   cudaStream_t s) {
  row_sum_finish_kernel<<<(f + kFinishThreads - 1) / kFinishThreads,
                          kFinishThreads, 0, s>>>(partials, out, n_parts, f);
  return cudaGetLastError();
}

template <int kSlots>
cudaError_t launch_ring(const float* x, float* partials, float* out, int m,
                        int f, int slot_rows, int chunks_per_cta, int n_ctas,
                        int smem_bytes, dim3 block, cudaStream_t s) {
  // the host's shared-memory count must be this kernel's own
  const long long want =
      kBarBytes + static_cast<long long>(kSlots) * slot_rows * f * 4;
  if (want != smem_bytes || smem_bytes > kMaxSmem - kStaticSmem ||
      static_cast<long long>(slot_rows) * f * 4 % 16)
    return cudaErrorInvalidValue;
  // once per instance: allow the kernel the most dynamic shared memory
  static const cudaError_t allowed = cudaFuncSetAttribute(
      row_sum_ring_kernel<kSlots>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem - kStaticSmem);
  if (allowed != cudaSuccess) return allowed;
  row_sum_ring_kernel<kSlots><<<n_ctas, block, smem_bytes, s>>>(
      x, partials, m, f, slot_rows, chunks_per_cta);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return finish(partials, out, n_ctas, f, s);
}

}  // namespace

extern "C" int gnn_row_sum_stream(const void* x, void* partials, void* out,
                                  int m, int f, int rows_per_cta, int n_ctas,
                                  void* stream) {
  dim3 block;
  if (!block_of(f, &block) || m < 1 || rows_per_cta < 1 || n_ctas < 1 ||
      static_cast<long long>(rows_per_cta) * (n_ctas - 1) >= m ||
      static_cast<long long>(rows_per_cta) * n_ctas < m)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_sum_stream_kernel<<<n_ctas, block, 0, s>>>(
      static_cast<const float4*>(x), static_cast<float*>(partials), m,
      rows_per_cta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(static_cast<const float*>(partials),
                                 static_cast<float*>(out), n_ctas, f, s));
}

extern "C" int gnn_row_sum_ring(const void* x, void* partials, void* out,
                                int m, int f, int n_slots, int slot_rows,
                                int chunks_per_cta, int n_ctas,
                                int smem_bytes, void* stream) {
  dim3 block;
  const long long n_chunks = slot_rows > 0 ? (m + slot_rows - 1LL) / slot_rows
                                           : 0;
  if (!block_of(f, &block) || m < 1 || slot_rows < 1 ||
      chunks_per_cta < 1 || n_ctas < 1 ||
      static_cast<long long>(chunks_per_cta) * (n_ctas - 1) >= n_chunks ||
      static_cast<long long>(chunks_per_cta) * n_ctas < n_chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  float* pf = static_cast<float*>(partials);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_slots) {
    case 2:
      return static_cast<int>(launch_ring<2>(xf, pf, of, m, f, slot_rows,
                                             chunks_per_cta, n_ctas,
                                             smem_bytes, block, s));
    case 4:
      return static_cast<int>(launch_ring<4>(xf, pf, of, m, f, slot_rows,
                                             chunks_per_cta, n_ctas,
                                             smem_bytes, block, s));
    case 8:
      return static_cast<int>(launch_ring<8>(xf, pf, of, m, f, slot_rows,
                                             chunks_per_cta, n_ctas,
                                             smem_bytes, block, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
