// Batched segment sum: out[b, j, :] = sum of vals[b, i, :] over the i with
// idx[b, i] == j, for the Chamfer backward's push of point cotangents onto
// their nearest neighbours.
//
// Replaces fpsg_tpu/ops/scatter.py:_segment_sum_pallas (kernel
// _segsum_kernel_factory), which builds a dense one-hot (rows x size) mask
// per tile on the TPU's vector unit.
//
// Deterministic, no atomics: each output row j is one thread that scans
// the batch's indices in increasing i and adds the matching values in
// that order, starting from 0. The sum therefore has one fixed order, the
// order of a sequential CPU index_add_. Like the TPU kernel it compares
// every index with every output (N x size compares per batch): a block
// owns 128 outputs and stages the batch's indices through shared memory
// in tiles of 2048, each read by all threads as a broadcast. Indices
// outside [0, size) match no output and are dropped, as in the mask
// kernel.
//
// Bound: at the Chamfer shapes (B <= 32, N = size = 2048, D = 3) the
// bytes are under 2 MB (< 1 us at 3.35 TB/s), so launch latency and the
// N x size compare loop set the time.
//
// C interface (loaded with ctypes): every entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ST = 128;         // outputs per block (one per thread)
constexpr int IT = 2048;        // indices per shared-memory tile
constexpr int MAX_D = 8;        // value width held in registers

__global__ void __launch_bounds__(ST)
segment_sum_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                   float* __restrict__ out, int N, int size, int D) {
  __shared__ int sidx[IT];
  const long long b = blockIdx.y;
  const int j = blockIdx.x * ST + threadIdx.x;
  const int* ib = idx + b * N;
  const float* vb = vals + b * N * D;
  float acc[MAX_D];
#pragma unroll
  for (int d = 0; d < MAX_D; ++d) acc[d] = 0.f;
  for (int base = 0; base < N; base += IT) {
    const int cnt = min(IT, N - base);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += ST) sidx[t] = ib[base + t];
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      if (sidx[t] == j) {
        const float* v = vb + (long long)(base + t) * D;
#pragma unroll
        for (int d = 0; d < MAX_D; ++d)
          if (d < D) acc[d] = __fadd_rn(acc[d], v[d]);
      }
    }
  }
  if (j < size) {
    float* o = out + (b * size + j) * D;
#pragma unroll
    for (int d = 0; d < MAX_D; ++d)
      if (d < D) o[d] = acc[d];
  }
}

}  // namespace

extern "C" {

// vals: (B, N, D) f32, idx: (B, N) int32, out: (B, size, D) f32, all
// contiguous; D <= 8. Every element of out is written.
int fpsg_segment_sum(const void* vals, const void* idx, void* out, int B,
                     int N, int size, int D, void* stream) {
  if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  if (B == 0 || size == 0) return (int)cudaGetLastError();
  const dim3 grid((size + ST - 1) / ST, B);
  segment_sum_kernel<<<grid, ST, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx),
      static_cast<float*>(out), N, size, D);
  return (int)cudaGetLastError();
}

const char* fpsg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
