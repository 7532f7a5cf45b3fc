// 2x2/stride-2 max-pool of an NHWC tensor with the int8 first-match code.
//
// Replaces fpsg_tpu/nn/vgg.py:_pool_pallas_fwd (kernel _pool_fwd_kernel),
// which pools VGG block 1's width-packed (B, H, W/2, 2C) layout on the TPU.
// The NHWC tensor here IS that layout viewed unpacked, so one kernel serves
// every VGG pool site.
//
// Semantics: window elements in torch's row-major (dh, dw) order; y is the
// maximum; code is the first window index whose value equals y, compared in
// f32 (a strict '>' scan keeps the first maximal element on ties).
//
// Bound: bytes. Each input byte is read once, each output byte written once;
// there is no arithmetic to speak of. Design: one thread owns 16 bytes of
// channels (4 f32 or 8 bf16) of one output pixel, so every load and store is
// a 16-byte vector access and neighbouring threads touch neighbouring
// addresses. A grid-stride loop covers any size. Tensors whose channel count
// or base address does not allow 16-byte vectors take the scalar instance.
//
// C interface (loaded with ctypes): every entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int N>
__global__ void __launch_bounds__(256)
maxpool2x2_kernel(const T* __restrict__ x, T* __restrict__ y,
                  int8_t* __restrict__ idx, int H2, int W2, int C,
                  long long total) {
  const int cv = C / N;
  const long long W = 2LL * W2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < total; v += stride) {
    const int c0 = (int)(v % cv) * N;
    const long long p = v / cv;  // output pixel index (b, i, j)
    const long long j = p % W2;
    const long long q = p / W2;
    const long long i = q % H2;
    const long long b = q / H2;
    const T* base = x + ((b * 2 * H2 + 2 * i) * W + 2 * j) * C + c0;
    alignas(16) T e[4][N];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const T* src = base + ((long long)(t >> 1) * W + (t & 1)) * C;
      if constexpr (N * sizeof(T) == 16) {
        *reinterpret_cast<uint4*>(e[t]) =
            __ldg(reinterpret_cast<const uint4*>(src));
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) e[t][k] = src[k];
      }
    }
    alignas(16) T out[N];
    int8_t code[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      T bestv = e[0][k];
      float best = to_f32(bestv);
      int bi = 0;
#pragma unroll
      for (int t = 1; t < 4; ++t) {
        const float f = to_f32(e[t][k]);
        if (f > best) {
          best = f;
          bestv = e[t][k];
          bi = t;
        }
      }
      out[k] = bestv;
      code[k] = (int8_t)bi;
    }
    T* dst = y + p * C + c0;
    if constexpr (N * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) dst[k] = out[k];
    }
    if (idx != nullptr) {
      int8_t* di = idx + p * C + c0;
#pragma unroll
      for (int k = 0; k < N; ++k) di[k] = code[k];
    }
  }
}

template <typename T, int N>
void launch(const void* x, void* y, void* idx, int B, int H, int W, int C,
            cudaStream_t stream) {
  const long long total = (long long)B * (H / 2) * (W / 2) * (C / N);
  if (total == 0) return;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  maxpool2x2_kernel<T, N><<<(int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<int8_t*>(idx), H / 2, W / 2, C, total);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16. x: (B, H, W, C) contiguous; y: (B, H/2, W/2, C);
// idx: int8 of y's shape, or null when the code is not wanted.
int fpsg_maxpool2x2(int dtype, const void* x, void* y, void* idx, int B,
                    int H, int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  if (dtype == 0) {
    if (aligned && C % 4 == 0)
      launch<float, 4>(x, y, idx, B, H, W, C, s);
    else
      launch<float, 1>(x, y, idx, B, H, W, C, s);
  } else if (dtype == 1) {
    if (aligned && C % 8 == 0)
      launch<__nv_bfloat16, 8>(x, y, idx, B, H, W, C, s);
    else
      launch<__nv_bfloat16, 1>(x, y, idx, B, H, W, C, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* fpsg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
