// 2x2/stride-2 max-pool of an NHWC tensor with the int8 first-match code,
// and its backward.
//
// Forward replaces fpsg_tpu/nn/vgg.py:_pool_pallas_fwd (kernel
// _pool_fwd_kernel), which pools VGG block 1's width-packed (B, H, W/2, 2C)
// layout on the TPU. The NHWC tensor here IS that layout viewed unpacked, so
// one kernel serves every VGG pool site.
//
// Semantics: window elements in torch's row-major (dh, dw) order; y is the
// maximum; code is the first window index whose value equals y, compared in
// f32 (a strict '>' scan keeps the first maximal element on ties).
//
// Backward replaces fpsg_tpu/nn/vgg.py:_pool_pallas_bwd (kernel
// _pool_bwd_kernel): gx at window position code is g, the other three are
// 0 (the plain formula of vgg.py:460-477).
//
// Bound: bytes. Each input byte is read once, each output byte written once;
// there is no arithmetic to speak of. Design: one thread owns 16 bytes of
// channels (4 f32 or 8 bf16) of one pooled pixel, so every load and store of
// x, y, g and gx is a 16-byte vector access and neighbouring threads touch
// neighbouring addresses (the codes move as 4- or 8-byte words). A
// grid-stride loop covers any size. Tensors whose channel count or base
// address does not allow vectors take the scalar instance.
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

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename T, int N>
__global__ void __launch_bounds__(256)
maxpool2x2_bwd_kernel(const T* __restrict__ g, const int8_t* __restrict__ idx,
                      T* __restrict__ gx, int H2, int W2, int C,
                      long long total) {
  const int cv = C / N;
  const long long W = 2LL * W2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < total; v += stride) {
    const int c0 = (int)(v % cv) * N;
    const long long p = v / cv;  // pooled pixel index (b, i, j)
    const long long j = p % W2;
    const long long q = p / W2;
    const long long i = q % H2;
    const long long b = q / H2;
    alignas(16) T gv[N];
    alignas(8) int8_t code[N];
    const T* gs = g + p * C + c0;
    const int8_t* cs = idx + p * C + c0;
    if constexpr (N * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(gv) = __ldg(reinterpret_cast<const uint4*>(gs));
      if constexpr (N == 4) {
        *reinterpret_cast<int*>(code) = __ldg(reinterpret_cast<const int*>(cs));
      } else {
        *reinterpret_cast<int2*>(code) =
            __ldg(reinterpret_cast<const int2*>(cs));
      }
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        gv[k] = gs[k];
        code[k] = cs[k];
      }
    }
    T* base = gx + ((b * 2 * H2 + 2 * i) * W + 2 * j) * C + c0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      alignas(16) T out[N];
#pragma unroll
      for (int k = 0; k < N; ++k) out[k] = code[k] == t ? gv[k] : zero<T>();
      T* dst = base + ((long long)(t >> 1) * W + (t & 1)) * C;
      if constexpr (N * sizeof(T) == 16) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) dst[k] = out[k];
      }
    }
  }
}

template <typename T, int N>
void launch_bwd(const void* g, const void* idx, void* gx, int B, int H, int W,
                int C, cudaStream_t stream) {
  const long long total = (long long)B * (H / 2) * (W / 2) * (C / N);
  if (total == 0) return;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  maxpool2x2_bwd_kernel<T, N><<<(int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int8_t*>(idx),
      static_cast<T*>(gx), H / 2, W / 2, C, total);
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

// dtype: 0 = f32, 1 = bf16. g: (B, H/2, W/2, C) contiguous; idx: int8 codes
// of g's shape (from fpsg_maxpool2x2); gx: (B, H, W, C), fully written.
int fpsg_maxpool2x2_bwd(int dtype, const void* g, const void* idx, void* gx,
                        int B, int H, int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t gp = reinterpret_cast<uintptr_t>(g);
  const uintptr_t xp = reinterpret_cast<uintptr_t>(gx);
  const uintptr_t ip = reinterpret_cast<uintptr_t>(idx);
  if (dtype == 0) {
    if (((gp | xp) & 15) == 0 && (ip & 3) == 0 && C % 4 == 0)
      launch_bwd<float, 4>(g, idx, gx, B, H, W, C, s);
    else
      launch_bwd<float, 1>(g, idx, gx, B, H, W, C, s);
  } else if (dtype == 1) {
    if (((gp | xp) & 15) == 0 && (ip & 7) == 0 && C % 8 == 0)
      launch_bwd<__nv_bfloat16, 8>(g, idx, gx, B, H, W, C, s);
    else
      launch_bwd<__nv_bfloat16, 1>(g, idx, gx, B, H, W, C, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* fpsg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
