// One-read BatchNorm moments and per-batch max/min of y (B, N, F), and the
// backward, for the PointNet BN -> global max-pool sites.
//
// Forward (K3f) replaces fpsg_tpu/ops/moments.py:_moments_fwd_pallas
// (kernel _fwd_kernel_factory). With z = y - s (s per channel, f32):
//   zsum[f] = sum_{b,n} z,  zsq[f] = sum_{b,n} z*z,
//   ymax[b,f], imax[b,f]: the max over n and the FIRST n attaining it,
//   ymin[b,f], imin[b,f]: the same for the min (values f32, compared in
//   f32; -inf/+inf start values and index 0 for an all-infinite column).
// Backward (K3b) replaces _moments_bwd_pallas (kernel _bwd_kernel_factory):
//   gy = ((A + y*B) + [n == imax] gmax) + [n == imin] gmin
// with A = gzs - 2 s gzq, B = 2 gzq per channel, every operation rounded
// on its own in that order (__fmul_rn / __fadd_rn, no FMA contraction) and
// rounded once to y's dtype, so the plain PyTorch version
// (fpsg_torch/ops/moments.py) gives the same bits.
//
// Bound: bytes. The forward reads y once and writes O(B F); the backward
// reads y and writes gy. Design: the TPU kernel walks N sequentially and
// carries its sums and running max across grid steps; CUDA blocks run in no
// order. Here one block owns one batch row b and a slab of channels and
// walks all N rows itself: a thread holds V channels (one 16-byte vector:
// 8 bf16 or 4 f32) and every TY-th row, keeping sum, sum of squares, max,
// min and their first indices in registers; a strict '>' / '<' scan in
// increasing n keeps the first index within a thread, and a tree over the
// block's row groups breaks equal values by the smaller index, so the
// result is the first index whatever the combining order. The block's
// partial sums go to part[2][B][F] (no float atomics) and a second kernel
// of the same call adds them over b in increasing order: the sums have one
// fixed order and the same bits on every run. The backward gives each
// thread V channels of one batch row, loads its per-channel coefficients,
// indices and cotangents once, and walks rows.
//
// C interface (loaded with ctypes): every entry point returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* src, T (&dst)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) dst[k] = src[k];
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* dst, const T (&src)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) dst[k] = src[k];
  }
}

// (v, i) replaces (bv, bi) if v is larger, or equal with a smaller index.
__device__ __forceinline__ bool wins_max(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}
__device__ __forceinline__ bool wins_min(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// Block (TX, TY), TX * TY == THREADS; block (x, y) = (channel slab, b).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
moments_fwd_kernel(const T* __restrict__ y, const float* __restrict__ s,
                   float* __restrict__ part, float* __restrict__ ymax,
                   int* __restrict__ imax, float* __restrict__ ymin,
                   int* __restrict__ imin, int B, int N, int F) {
  const int TX = blockDim.x, TY = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.y;
  const int c0 = (blockIdx.x * TX + tx) * V;
  const bool live = c0 < F;
  float sum[V], sq[V], mx[V], mn[V], sv[V];
  int imx[V], imn[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sum[k] = 0.f;
    sq[k] = 0.f;
    mx[k] = -INFINITY;
    mn[k] = INFINITY;
    imx[k] = 0x7fffffff;
    imn[k] = 0x7fffffff;
    sv[k] = live ? s[c0 + k] : 0.f;
  }
  if (live) {
    const T* yb = y + (long long)b * N * F + c0;
#pragma unroll 4
    for (int n = ty; n < N; n += TY) {
      T e[V];
      load_vec<T, V>(yb + (long long)n * F, e);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = to_f32(e[k]);
        const float z = f - sv[k];
        sum[k] += z;
        sq[k] += z * z;
        // the first row of this thread always takes the slot, so an
        // all-infinite column still gets its first index
        if (f > mx[k] || imx[k] == 0x7fffffff) {
          mx[k] = f;
          imx[k] = n;
        }
        if (f < mn[k] || imn[k] == 0x7fffffff) {
          mn[k] = f;
          imn[k] = n;
        }
      }
    }
  }
  // tree over the TY row groups, per channel: max/min with the index
  // tie-break, then the two sums in a fixed pairing
  extern __shared__ float smem[];
  float* fa = smem;                                  // [TY][TX*V]
  float* fb = fa + TY * TX * V;
  int* ia = reinterpret_cast<int*>(fb + TY * TX * V);
  int* ib = ia + TY * TX * V;
  const int row = TX * V;
  const int me = ty * row + tx * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    fa[me + k] = mx[k];
    ia[me + k] = imx[k];
    fb[me + k] = mn[k];
    ib[me + k] = imn[k];
  }
  __syncthreads();
  for (int stride = TY / 2; stride > 0; stride >>= 1) {
    if (ty < stride) {
      const int other = me + stride * row;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (wins_max(fa[other + k], ia[other + k], fa[me + k], ia[me + k])) {
          fa[me + k] = fa[other + k];
          ia[me + k] = ia[other + k];
        }
        if (wins_min(fb[other + k], ib[other + k], fb[me + k], ib[me + k])) {
          fb[me + k] = fb[other + k];
          ib[me + k] = ib[other + k];
        }
      }
    }
    __syncthreads();
  }
  if (ty == 0 && live) {
    const long long o = (long long)b * F + c0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      ymax[o + k] = fa[me + k];
      imax[o + k] = ia[me + k] == 0x7fffffff ? 0 : ia[me + k];
      ymin[o + k] = fb[me + k];
      imin[o + k] = ib[me + k] == 0x7fffffff ? 0 : ib[me + k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < V; ++k) {
    fa[me + k] = sum[k];
    fb[me + k] = sq[k];
  }
  __syncthreads();
  for (int stride = TY / 2; stride > 0; stride >>= 1) {
    if (ty < stride) {
      const int other = me + stride * row;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        fa[me + k] += fa[other + k];
        fb[me + k] += fb[other + k];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && live) {
    const long long o = (long long)b * F + c0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      part[o + k] = fa[me + k];
      part[(long long)B * F + o + k] = fb[me + k];
    }
  }
}

// zsum[f] = sum over b (in increasing b) of part[0][b][f]; zsq likewise.
__global__ void __launch_bounds__(THREADS)
moments_sum_kernel(const float* __restrict__ part, float* __restrict__ zs,
                   float* __restrict__ zq, int B, int F) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  float a = 0.f, q = 0.f;
  for (int b = 0; b < B; ++b) {
    a += part[(long long)b * F + f];
    q += part[(long long)(B + b) * F + f];
  }
  zs[f] = a;
  zq[f] = q;
}

// Block (TX, TY); grid (channel slabs, B, row splits).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
moments_bwd_kernel(const T* __restrict__ y, const float* __restrict__ avec,
                   const float* __restrict__ bvec,
                   const float* __restrict__ gmax, const int* __restrict__ imax,
                   const float* __restrict__ gmin, const int* __restrict__ imin,
                   T* __restrict__ gy, int N, int F) {
  const int TX = blockDim.x, TY = blockDim.y;
  const int c0 = (blockIdx.x * TX + threadIdx.x) * V;
  if (c0 >= F) return;
  const int b = blockIdx.y;
  const long long o = (long long)b * F + c0;
  float a[V], bb[V], gx[V], gn[V];
  int ix[V], in[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a[k] = avec[c0 + k];
    bb[k] = bvec[c0 + k];
    gx[k] = gmax[o + k];
    ix[k] = imax[o + k];
    gn[k] = gmin[o + k];
    in[k] = imin[o + k];
  }
  const T* yb = y + (long long)b * N * F + c0;
  T* gb = gy + (long long)b * N * F + c0;
  const int step = TY * gridDim.z;
#pragma unroll 4
  for (int n = blockIdx.z * TY + threadIdx.y; n < N; n += step) {
    T e[V];
    load_vec<T, V>(yb + (long long)n * F, e);
    alignas(16) T out[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float g = __fadd_rn(a[k], __fmul_rn(to_f32(e[k]), bb[k]));
      g = __fadd_rn(g, n == ix[k] ? gx[k] : 0.f);
      g = __fadd_rn(g, n == in[k] ? gn[k] : 0.f);
      from_f32(g, &out[k]);
    }
    store_vec<T, V>(gb + (long long)n * F, out);
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int V>
int launch_fwd(const void* y, const float* s, float* zs, float* zq,
               float* part, float* ymax, int* imax, float* ymin, int* imin,
               int B, int N, int F, cudaStream_t stream) {
  // 8 vectors (128 bytes of a row) by 32 row groups: B x F / (8 V)
  // blocks, 1024 at the PointNet shapes, each walking N / 32 rows
  const int tx = 8;
  const dim3 block(tx, THREADS / tx);
  const dim3 grid(ceil_div(ceil_div(F, V), tx), B);
  const size_t smem = 4 * (size_t)THREADS * V * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        moments_fwd_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  moments_fwd_kernel<T, V><<<grid, block, smem, stream>>>(
      static_cast<const T*>(y), s, part, ymax, imax, ymin, imin, B, N, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  moments_sum_kernel<<<ceil_div(F, THREADS), THREADS, 0, stream>>>(
      part, zs, zq, B, F);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd(const void* y, const float* avec, const float* bvec,
               const float* gmax, const int* imax, const float* gmin,
               const int* imin, void* gy, int B, int N, int F,
               cudaStream_t stream) {
  const int cv = ceil_div(F, V);
  const int tx = cv >= 32 ? 32 : (cv >= 16 ? 16 : 8);
  const dim3 block(tx, THREADS / tx);
  const int blocks_xy = ceil_div(cv, tx) * B;
  // enough row splits for ~8 blocks on each of the 132 SMs
  int splits = ceil_div(132 * 8, blocks_xy);
  const int max_splits = ceil_div(N, THREADS / tx);
  if (splits > max_splits) splits = max_splits;
  if (splits > 65535) splits = 65535;
  const dim3 grid(ceil_div(cv, tx), B, splits);
  moments_bwd_kernel<T, V><<<grid, block, 0, stream>>>(
      static_cast<const T*>(y), avec, bvec, gmax, imax, gmin, imin,
      static_cast<T*>(gy), N, F);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16. y: (B, N, F) contiguous; s: (F,) f32;
// zs, zq: (F,) f32; part: (2, B, F) f32 scratch; ymax, ymin: (B, F) f32;
// imax, imin: (B, F) int32. Two launches: the block pass and the sum.
int fpsg_moments_fwd(int dtype, const void* y, const void* s, void* zs,
                     void* zq, void* part, void* ymax, void* imax,
                     void* ymin, void* imin, int B, int N, int F,
                     void* stream) {
  if (B <= 0 || N <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  float *zsf = static_cast<float*>(zs), *zqf = static_cast<float*>(zq);
  float* pf = static_cast<float*>(part);
  float *mx = static_cast<float*>(ymax), *mn = static_cast<float*>(ymin);
  int *ix = static_cast<int*>(imax), *in = static_cast<int*>(imin);
  if (dtype == 0) {
    if (aligned16(y) && F % 4 == 0)
      return launch_fwd<float, 4>(y, sf, zsf, zqf, pf, mx, ix, mn, in, B, N,
                                  F, st);
    return launch_fwd<float, 1>(y, sf, zsf, zqf, pf, mx, ix, mn, in, B, N, F,
                                st);
  }
  if (dtype == 1) {
    if (aligned16(y) && F % 8 == 0)
      return launch_fwd<__nv_bfloat16, 8>(y, sf, zsf, zqf, pf, mx, ix, mn, in,
                                          B, N, F, st);
    return launch_fwd<__nv_bfloat16, 1>(y, sf, zsf, zqf, pf, mx, ix, mn, in,
                                        B, N, F, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = f32, 1 = bf16. y, gy: (B, N, F) contiguous, gy fully written;
// avec, bvec: (F,) f32; gmax, gmin: (B, F) f32; imax, imin: (B, F) int32.
int fpsg_moments_bwd(int dtype, const void* y, const void* avec,
                     const void* bvec, const void* gmax, const void* imax,
                     const void* gmin, const void* imin, void* gy, int B,
                     int N, int F, void* stream) {
  if (B <= 0 || N <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *a = static_cast<const float*>(avec),
              *b = static_cast<const float*>(bvec);
  const float *gx = static_cast<const float*>(gmax),
              *gn = static_cast<const float*>(gmin);
  const int *ix = static_cast<const int*>(imax),
            *in = static_cast<const int*>(imin);
  const bool al = aligned16(y) && aligned16(gy);
  if (dtype == 0) {
    if (al && F % 4 == 0)
      return launch_bwd<float, 4>(y, a, b, gx, ix, gn, in, gy, B, N, F, st);
    return launch_bwd<float, 1>(y, a, b, gx, ix, gn, in, gy, B, N, F, st);
  }
  if (dtype == 1) {
    if (al && F % 8 == 0)
      return launch_bwd<__nv_bfloat16, 8>(y, a, b, gx, ix, gn, in, gy, B, N,
                                          F, st);
    return launch_bwd<__nv_bfloat16, 1>(y, a, b, gx, ix, gn, in, gy, B, N, F,
                                        st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* fpsg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
