// Fused layers of the primitive decoder's node chain, eval form.
//
// Replace the forward Pallas kernels of fpsg_tpu/nn/fused_stack.py with
// with_stats=False:
//   fused_l1   <- _fused_l1_fwd  (kernel _l1_fwd_kernel_factory)
//   fused_mid  <- _fused_mid_fwd (kernel _mid_fwd_kernel_factory)
//   fused_out  <- _fused_out_fwd (kernel _out_fwd_kernel_factory)
//
// Layout (as in the JAX package): activations group-major (G = C*Nn, R, D)
// row-major, weights (G, Din, Dout), per-channel affine k, b (G, Din) f32.
// T is float or __nv_bfloat16. The previous BN's affine is applied in T:
// k and b round to T, then one rounding after the multiply and one after
// the add (the TPU kernels compute `yp * k.astype(dt) + b.astype(dt)` in
// dt), then relu. Products accumulate in f32; each output rounds once.
//
// Bounds on the card (at the serving shapes, Q = 8, G = 16, R = 1024):
//   fused_l1:  bytes (writes y, 16 x 1024 x 1539 x 4 B ~ 101 MB in f32).
//              Each block owns ROWS rows; each thread owns columns and
//              keeps its Din (<= 8) weights in registers, so the writes
//              are coalesced along the row.
//   fused_mid: operations (2 x 16 x 1024 x 1539 x 769 ~ 38.8 GFLOP). A
//              shared-memory tiled SIMT GEMM, 128 x 128 x 16 tiles,
//              256 threads each computing an 8 x 8 sub-tile from 16-byte
//              shared-memory reads; the affine + relu runs in the A-tile
//              load (the prologue), so the normalized activation never
//              exists in device memory. Ragged edges are masked. No
//              tensor cores, TMA or wgmma yet.
//   fused_out: bytes (reads yp, 16 x 1024 x 384 x 4 B ~ 25 MB). One warp
//              per row: coalesced reads of the row, Dout (<= 8) dot
//              products reduced with shuffles, tanh in f32.
//
// C interface (loaded with ctypes): dtype 0 = f32, 1 = bf16; every entry
// point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Round an f32 value to T's precision (and back to f32).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// relu(yp * k + b) in T; k and b already rounded to T. No FMA contraction:
// the multiply and the add round separately, as in the plain version.
template <typename T>
__device__ __forceinline__ float affine_relu(float yp, float k, float b) {
  const float t = round_to<T>(__fmul_rn(yp, k));
  return fmaxf(round_to<T>(__fadd_rn(t, b)), 0.0f);
}

// ---------------------------------------------------------------------------
// Layer 1: y[g, r, :] = d[g, r, :] @ wd[g] + yc[g, r / P, :]
// ---------------------------------------------------------------------------

constexpr int L1_ROWS = 16;
constexpr int L1_MAX_DIN = 8;

template <typename T>
__global__ void __launch_bounds__(256)
fused_l1_kernel(const T* __restrict__ d, const T* __restrict__ wd,
                const float* __restrict__ yc, T* __restrict__ y, int R,
                int P, int Din, int Dout) {
  const int g = blockIdx.y;
  const int r0 = blockIdx.x * L1_ROWS;
  const int nb = R / P;
  __shared__ float ds[L1_ROWS * L1_MAX_DIN];
  for (int e = threadIdx.x; e < L1_ROWS * Din; e += blockDim.x) {
    const int r = r0 + e / Din;
    ds[e] = r < R ? ld(d + ((long long)g * R + r) * Din + e % Din) : 0.0f;
  }
  __syncthreads();
  const T* wg = wd + (long long)g * Din * Dout;
  const float* ycg = yc + (long long)g * nb * Dout;
  T* yg = y + (long long)g * R * Dout;
  const int rows = min(L1_ROWS, R - r0);
  for (int j = threadIdx.x; j < Dout; j += blockDim.x) {
    float w[L1_MAX_DIN];
#pragma unroll
    for (int k = 0; k < L1_MAX_DIN; ++k)
      w[k] = k < Din ? ld(wg + (long long)k * Dout + j) : 0.0f;
    for (int r = 0; r < rows; ++r) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < L1_MAX_DIN; ++k)
        if (k < Din) acc = fmaf(ds[r * Din + k], w[k], acc);
      const int row = r0 + r;
      acc += ycg[(long long)(row / P) * Dout + j];
      st(yg + (long long)row * Dout + j, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// Mid layers: y[g] = relu(k[g] * yp[g] + b[g]) @ w[g]
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 16;
constexpr int PAD = 4;  // keeps 16-byte alignment of the smem rows

template <typename T>
__global__ void __launch_bounds__(256)
fused_mid_kernel(const T* __restrict__ yp, const float* __restrict__ kk,
                 const float* __restrict__ bb, const T* __restrict__ w,
                 T* __restrict__ y, int R, int Din, int Dout) {
  __shared__ __align__(16) float As[BK][BM + PAD];  // A tile, k-major
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* ypg = yp + (long long)g * R * Din;
  const T* wg = w + (long long)g * Din * Dout;
  const float* kg = kk + (long long)g * Din;
  const float* bg = bb + (long long)g * Din;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < Din; k0 += BK) {
    // A tile (BM x BK): the prologue applies the affine + relu on load.
#pragma unroll
    for (int i = 0; i < (BM * BK) / 256; ++i) {
      const int e = tid + i * 256;
      const int r = e / BK, kc = e % BK;
      const int gr = m0 + r, gk = k0 + kc;
      float a = 0.0f;
      if (gr < R && gk < Din)
        a = affine_relu<T>(ld(ypg + (long long)gr * Din + gk),
                           round_to<T>(kg[gk]), round_to<T>(bg[gk]));
      As[kc][r] = a;
    }
    // B tile (BK x BN).
#pragma unroll
    for (int i = 0; i < (BK * BN) / 256; ++i) {
      const int e = tid + i * 256;
      const int kc = e / BN, n = e % BN;
      const int gk = k0 + kc, gn = n0 + n;
      Bs[kc][n] = (gk < Din && gn < Dout)
                      ? ld(wg + (long long)gk * Dout + gn) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < BK; ++kc) {
      float a[8], b[8];
      // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise by tx
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kc][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kc][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kc][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kc][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* yg = y + (long long)g * R * Dout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gr >= R) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (gn < Dout) st(yg + (long long)gr * Dout + gn, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Output layer: y[g] = tanh(relu(k[g] * yp[g] + b[g]) @ w[g] + bias[g]), f32
// ---------------------------------------------------------------------------

constexpr int OUT_ROWS = 32;  // rows per block (8 warps x 4 rows)
constexpr int OUT_MAX_DOUT = 8;

template <typename T>
__global__ void __launch_bounds__(256)
fused_out_kernel(const T* __restrict__ yp, const float* __restrict__ kk,
                 const float* __restrict__ bb, const T* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y,
                 int R, int Din, int Dout) {
  extern __shared__ float sm[];  // w (Din x Dout), then k, b rounded to T
  float* ws = sm;
  float* ks = sm + Din * Dout;
  float* bs = ks + Din;
  const int g = blockIdx.y;
  const T* wg = w + (long long)g * Din * Dout;
  for (int e = threadIdx.x; e < Din * Dout; e += blockDim.x)
    ws[e] = ld(wg + e);
  for (int e = threadIdx.x; e < Din; e += blockDim.x) {
    ks[e] = round_to<T>(kk[(long long)g * Din + e]);
    bs[e] = round_to<T>(bb[(long long)g * Din + e]);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const T* ypg = yp + (long long)g * R * Din;
  const int rend = min(R, (int)(blockIdx.x + 1) * OUT_ROWS);
  for (int r = blockIdx.x * OUT_ROWS + warp; r < rend; r += nwarps) {
    float acc[OUT_MAX_DOUT];
#pragma unroll
    for (int o = 0; o < OUT_MAX_DOUT; ++o) acc[o] = 0.0f;
    const T* row = ypg + (long long)r * Din;
    for (int kc = lane; kc < Din; kc += 32) {
      const float a = affine_relu<T>(ld(row + kc), ks[kc], bs[kc]);
#pragma unroll
      for (int o = 0; o < OUT_MAX_DOUT; ++o)
        if (o < Dout) acc[o] = fmaf(a, ws[kc * Dout + o], acc[o]);
    }
#pragma unroll
    for (int o = 0; o < OUT_MAX_DOUT; ++o) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[o] += __shfl_xor_sync(0xffffffffu, acc[o], off);
    }
    if (lane == 0) {
      float* yr = y + ((long long)g * R + r) * Dout;
#pragma unroll
      for (int o = 0; o < OUT_MAX_DOUT; ++o)
        if (o < Dout) yr[o] = tanhf(acc[o] + bias[(long long)g * Dout + o]);
    }
  }
}

template <typename T>
int l1(const void* d, const void* wd, const void* yc, void* y, int G, int R,
       int P, int Din, int Dout, cudaStream_t s) {
  if (Din > L1_MAX_DIN || P <= 0 || R % P != 0) return cudaErrorInvalidValue;
  dim3 grid((R + L1_ROWS - 1) / L1_ROWS, G);
  fused_l1_kernel<T><<<grid, 256, 0, s>>>(
      static_cast<const T*>(d), static_cast<const T*>(wd),
      static_cast<const float*>(yc), static_cast<T*>(y), R, P, Din, Dout);
  return (int)cudaGetLastError();
}

template <typename T>
int mid(const void* yp, const void* k, const void* b, const void* w, void* y,
        int G, int R, int Din, int Dout, cudaStream_t s) {
  dim3 grid((Dout + BN - 1) / BN, (R + BM - 1) / BM, G);
  fused_mid_kernel<T><<<grid, 256, 0, s>>>(
      static_cast<const T*>(yp), static_cast<const float*>(k),
      static_cast<const float*>(b), static_cast<const T*>(w),
      static_cast<T*>(y), R, Din, Dout);
  return (int)cudaGetLastError();
}

template <typename T>
int out(const void* yp, const void* k, const void* b, const void* w,
        const void* bias, void* y, int G, int R, int Din, int Dout,
        cudaStream_t s) {
  if (Dout > OUT_MAX_DOUT) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)Din * Dout + 2 * Din);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid((R + OUT_ROWS - 1) / OUT_ROWS, G);
  fused_out_kernel<T><<<grid, 256, smem, s>>>(
      static_cast<const T*>(yp), static_cast<const float*>(k),
      static_cast<const float*>(b), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), R, Din, Dout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fpsg_fused_l1_fwd(int dtype, const void* d, const void* wd,
                      const void* yc, void* y, int G, int R, int P, int Din,
                      int Dout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return l1<float>(d, wd, yc, y, G, R, P, Din, Dout, s);
  if (dtype == 1)
    return l1<__nv_bfloat16>(d, wd, yc, y, G, R, P, Din, Dout, s);
  return (int)cudaErrorInvalidValue;
}

int fpsg_fused_mid_fwd(int dtype, const void* yp, const void* k,
                       const void* b, const void* w, void* y, int G, int R,
                       int Din, int Dout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return mid<float>(yp, k, b, w, y, G, R, Din, Dout, s);
  if (dtype == 1)
    return mid<__nv_bfloat16>(yp, k, b, w, y, G, R, Din, Dout, s);
  return (int)cudaErrorInvalidValue;
}

int fpsg_fused_out_fwd(int dtype, const void* yp, const void* k,
                       const void* b, const void* w, const void* bias,
                       void* y, int G, int R, int Din, int Dout,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return out<float>(yp, k, b, w, bias, y, G, R, Din, Dout, s);
  if (dtype == 1)
    return out<__nv_bfloat16>(yp, k, b, w, bias, y, G, R, Din, Dout, s);
  return (int)cudaErrorInvalidValue;
}

const char* fpsg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
