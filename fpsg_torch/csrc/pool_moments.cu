// One-read BatchNorm moments and 2x2 max/min pool of a VGG conv output,
// and the backward, for the VGG BN -> pool sites.
//
// The input is NHWC y (B, H, W, C), which is the TPU kernels' width-packed
// (B, H, W/2, 2C) layout viewed unpacked: the window of pooled pixel
// (b, i, j) is y[b, 2i + dh, 2j + dw, :] in row-major (dh, dw) order, code
// t = 2 dh + dw (the codes of maxpool2x2.cu).
//
// Forward (K4f) replaces fpsg_tpu/ops/pool_moments.py:_fwd_pallas (kernel
// _fwd_kernel_factory). With z = y - s (s per channel, f32):
//   zsum[c] = sum z, zsq[c] = sum z*z over (B, H, W) (both width phases:
//   the JAX kernel returns them per phase and its caller adds the two);
//   ymax, ymin (B, H/2, W/2, C) in y's dtype: the window max and min;
//   imax, imin int8: the FIRST window element equal to each, compared in
//   f32 (a strict '>' / '<' scan in window order).
// Backward (K4b) replaces _bwd_pallas (kernel _bwd_kernel_factory): at
// window position t,
//   gy = (A + y*B) + ([imax == t] gmax + [imin == t] gmin)
// with A = gzs - 2 s gzq, B = 2 gzq per channel, every operation rounded on
// its own in that order (__fmul_rn / __fadd_rn, no FMA contraction) and
// rounded once to y's dtype, so the plain PyTorch version
// (fpsg_torch/ops/pool_moments.py) gives the same bits.
//
// Bound: bytes. The forward reads y once and writes a quarter of it twice
// in y's dtype and twice in int8 codes; the backward reads y, the two
// pooled cotangents and the codes, and writes gy. Design: a block is
// (TX channel vectors) x (TY pooled pixels); a thread owns one 16-byte
// vector of channels (8 bf16 or 4 f32) for its whole life and walks pooled
// pixels with a fixed stride, so every load and store is a 16-byte vector
// and its per-channel sums stay in registers. The TPU kernel carries its
// sums across a sequential grid; here each block row of the grid writes
// partial sums to part[2][groups][C] after a fixed tree over its TY pixel
// rows, and a second kernel of the same call adds the groups in a fixed
// order: no float atomics, the same bits on every run.
//
// C interface (loaded with ctypes): every entry point returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TARGET_BLOCKS = 132 * 8;   // ~8 blocks of 256 on each SM

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

template <int V>
__device__ __forceinline__ void load_codes(const int8_t* src, int8_t (&dst)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(dst) = __ldg(reinterpret_cast<const uint2*>(src));
  } else if constexpr (V == 4) {
    *reinterpret_cast<unsigned*>(dst) =
        __ldg(reinterpret_cast<const unsigned*>(src));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) dst[k] = src[k];
  }
}

template <int V>
__device__ __forceinline__ void store_codes(int8_t* dst, const int8_t (&src)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else if constexpr (V == 4) {
    *reinterpret_cast<unsigned*>(dst) = *reinterpret_cast<const unsigned*>(src);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) dst[k] = src[k];
  }
}

struct Geometry {
  int H2, W2, W, C;
  long long P;          // pooled pixels B * H2 * W2
};

// Pointer to window element t of pooled pixel p, channel c0.
template <typename T>
__device__ __forceinline__ const T* window(const T* y, const Geometry& g,
                                           long long p, int c0, int t) {
  const long long j = p % g.W2;
  const long long q = p / g.W2;
  const long long i = q % g.H2;
  const long long b = q / g.H2;
  const long long row = b * 2 * g.H2 + 2 * i + (t >> 1);
  return y + (row * g.W + 2 * j + (t & 1)) * g.C + c0;
}

// Block (TX, TY); grid (channel-vector slabs, groups).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
pool_moments_fwd_kernel(const T* __restrict__ y, const float* __restrict__ s,
                        float* __restrict__ part, T* __restrict__ ymax,
                        int8_t* __restrict__ imax, T* __restrict__ ymin,
                        int8_t* __restrict__ imin, Geometry g,
                        int max_groups) {
  const int TX = blockDim.x, TY = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = (blockIdx.x * TX + tx) * V;
  const bool live = c0 < g.C;
  float sum[V], sq[V], sv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sum[k] = 0.f;
    sq[k] = 0.f;
    sv[k] = live ? s[c0 + k] : 0.f;
  }
  if (live) {
    const long long step = (long long)gridDim.y * TY;
    for (long long p = (long long)blockIdx.y * TY + ty; p < g.P; p += step) {
      T e[4][V];
#pragma unroll
      for (int t = 0; t < 4; ++t) load_vec<T, V>(window(y, g, p, c0, t), e[t]);
      alignas(16) T mx[V], mn[V];
      alignas(8) int8_t cx[V], cn[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float bx = to_f32(e[0][k]), bn = bx;
        int ix = 0, in = 0;
        mx[k] = e[0][k];
        mn[k] = e[0][k];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float f = to_f32(e[t][k]);
          const float z = f - sv[k];
          sum[k] += z;
          sq[k] += z * z;
          if (f > bx) {
            bx = f;
            mx[k] = e[t][k];
            ix = t;
          }
          if (f < bn) {
            bn = f;
            mn[k] = e[t][k];
            in = t;
          }
        }
        cx[k] = (int8_t)ix;
        cn[k] = (int8_t)in;
      }
      const long long o = p * g.C + c0;
      store_vec<T, V>(ymax + o, mx);
      store_vec<T, V>(ymin + o, mn);
      store_codes<V>(imax + o, cx);
      store_codes<V>(imin + o, cn);
    }
  }
  // fixed tree over the TY pixel rows of the block, per channel
  __shared__ float sa[THREADS * V], sb[THREADS * V];
  const int row = TX * V;
  const int me = ty * row + tx * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sa[me + k] = sum[k];
    sb[me + k] = sq[k];
  }
  __syncthreads();
  for (int stride = TY / 2; stride > 0; stride >>= 1) {
    if (ty < stride) {
      const int other = me + stride * row;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        sa[me + k] += sa[other + k];
        sb[me + k] += sb[other + k];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && live) {
    float* p0 = part + (long long)blockIdx.y * g.C + c0;
    float* p1 = p0 + (long long)max_groups * g.C;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      p0[k] = sa[me + k];
      p1[k] = sb[me + k];
    }
  }
}

// zsum[c] = sum over the groups of part[0][group][c], zsq likewise: block
// (32 channels, 32 group lanes); each lane adds every 32nd group in
// increasing order, then a fixed tree adds the lanes.
__global__ void __launch_bounds__(1024)
pool_moments_sum_kernel(const float* __restrict__ part,
                        float* __restrict__ zs, float* __restrict__ zq,
                        int groups, int max_groups, int C) {
  __shared__ float sa[32][33], sb[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float a = 0.f, q = 0.f;
  if (c < C) {
    for (int gi = ty; gi < groups; gi += 32) {
      a += part[(long long)gi * C + c];
      q += part[(long long)(max_groups + gi) * C + c];
    }
  }
  sa[ty][tx] = a;
  sb[ty][tx] = q;
  __syncthreads();
  for (int stride = 16; stride > 0; stride >>= 1) {
    if (ty < stride) {
      sa[ty][tx] += sa[ty + stride][tx];
      sb[ty][tx] += sb[ty + stride][tx];
    }
    __syncthreads();
  }
  if (ty == 0 && c < C) {
    zs[c] = sa[0][tx];
    zq[c] = sb[0][tx];
  }
}

// Block (TX, TY); grid (channel-vector slabs, groups).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
pool_moments_bwd_kernel(const T* __restrict__ y, const float* __restrict__ avec,
                        const float* __restrict__ bvec,
                        const T* __restrict__ gmax,
                        const int8_t* __restrict__ imax,
                        const T* __restrict__ gmin,
                        const int8_t* __restrict__ imin, T* __restrict__ gy,
                        Geometry g) {
  const int TX = blockDim.x, TY = blockDim.y;
  const int c0 = (blockIdx.x * TX + threadIdx.x) * V;
  if (c0 >= g.C) return;
  float a[V], bb[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a[k] = avec[c0 + k];
    bb[k] = bvec[c0 + k];
  }
  const long long step = (long long)gridDim.y * TY;
  for (long long p = (long long)blockIdx.y * TY + threadIdx.y; p < g.P;
       p += step) {
    const long long o = p * g.C + c0;
    T gx[V], gn[V];
    alignas(8) int8_t cx[V], cn[V];
    load_vec<T, V>(gmax + o, gx);
    load_vec<T, V>(gmin + o, gn);
    load_codes<V>(imax + o, cx);
    load_codes<V>(imin + o, cn);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const T* src = window(y, g, p, c0, t);
      T e[V];
      load_vec<T, V>(src, e);
      alignas(16) T out[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float stat = __fadd_rn(a[k], __fmul_rn(to_f32(e[k]), bb[k]));
        const float routed = __fadd_rn(cx[k] == t ? to_f32(gx[k]) : 0.f,
                                       cn[k] == t ? to_f32(gn[k]) : 0.f);
        from_f32(__fadd_rn(stat, routed), &out[k]);
      }
      store_vec<T, V>(gy + (src - y), out);
    }
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

struct Launch {
  dim3 block, grid;
};

// Thread block (TX channel vectors, 256 / TX pixels) and grid (channel
// slabs, pixel groups), about TARGET_BLOCKS blocks in all.
Launch plan(int cv, long long P, int max_groups) {
  const int tx = cv >= 32 ? 32 : (cv >= 16 ? 16 : 8);
  const int ty = THREADS / tx;
  const int gx = ceil_div(cv, tx);
  int groups = TARGET_BLOCKS / gx;
  if (groups < 1) groups = 1;
  if (groups > ceil_div(P, ty)) groups = ceil_div(P, ty);
  if (groups > max_groups) groups = max_groups;
  if (groups > 65535) groups = 65535;
  return {dim3(tx, ty), dim3(gx, groups)};
}

template <typename T, int V>
int launch_fwd(const void* y, const float* s, float* zs, float* zq,
               float* part, void* ymax, void* imax, void* ymin, void* imin,
               Geometry g, int max_groups, cudaStream_t stream) {
  const Launch l = plan(ceil_div(g.C, V), g.P, max_groups);
  pool_moments_fwd_kernel<T, V><<<l.grid, l.block, 0, stream>>>(
      static_cast<const T*>(y), s, part, static_cast<T*>(ymax),
      static_cast<int8_t*>(imax), static_cast<T*>(ymin),
      static_cast<int8_t*>(imin), g, max_groups);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pool_moments_sum_kernel<<<ceil_div(g.C, 32), dim3(32, 32), 0, stream>>>(
      part, zs, zq, (int)l.grid.y, max_groups, g.C);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd(const void* y, const float* avec, const float* bvec,
               const void* gmax, const void* imax, const void* gmin,
               const void* imin, void* gy, Geometry g, cudaStream_t stream) {
  const Launch l = plan(ceil_div(g.C, V), g.P, 65535);
  pool_moments_bwd_kernel<T, V><<<l.grid, l.block, 0, stream>>>(
      static_cast<const T*>(y), avec, bvec, static_cast<const T*>(gmax),
      static_cast<const int8_t*>(imax), static_cast<const T*>(gmin),
      static_cast<const int8_t*>(imin), static_cast<T*>(gy), g);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

Geometry geometry(int B, int H, int W, int C) {
  return {H / 2, W / 2, W, C, (long long)B * (H / 2) * (W / 2)};
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16. y: (B, H, W, C) contiguous, H and W even;
// s, zs, zq: (C,) f32; part: (2, max_groups, C) f32 scratch; ymax, ymin:
// (B, H/2, W/2, C) in y's dtype; imax, imin: int8 of that shape. Two
// launches: the block pass and the sum over groups.
int fpsg_pool_moments_fwd(int dtype, const void* y, const void* s, void* zs,
                          void* zq, void* part, void* ymax, void* imax,
                          void* ymin, void* imin, int B, int H, int W, int C,
                          int max_groups, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H % 2 || W % 2 ||
      max_groups <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(B, H, W, C);
  const float* sf = static_cast<const float*>(s);
  float *zsf = static_cast<float*>(zs), *zqf = static_cast<float*>(zq);
  float* pf = static_cast<float*>(part);
  const bool vec16 = aligned(y, 16) && aligned(ymax, 16) && aligned(ymin, 16);
  if (dtype == 0) {
    if (vec16 && aligned(imax, 4) && aligned(imin, 4) && C % 4 == 0)
      return launch_fwd<float, 4>(y, sf, zsf, zqf, pf, ymax, imax, ymin,
                                  imin, g, max_groups, st);
    return launch_fwd<float, 1>(y, sf, zsf, zqf, pf, ymax, imax, ymin, imin,
                                g, max_groups, st);
  }
  if (dtype == 1) {
    if (vec16 && aligned(imax, 8) && aligned(imin, 8) && C % 8 == 0)
      return launch_fwd<__nv_bfloat16, 8>(y, sf, zsf, zqf, pf, ymax, imax,
                                          ymin, imin, g, max_groups, st);
    return launch_fwd<__nv_bfloat16, 1>(y, sf, zsf, zqf, pf, ymax, imax, ymin,
                                        imin, g, max_groups, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = f32, 1 = bf16. y, gy: (B, H, W, C) contiguous, gy fully
// written; avec, bvec: (C,) f32; gmax, gmin: (B, H/2, W/2, C) in y's
// dtype; imax, imin: int8 codes of that shape.
int fpsg_pool_moments_bwd(int dtype, const void* y, const void* avec,
                          const void* bvec, const void* gmax,
                          const void* imax, const void* gmin,
                          const void* imin, void* gy, int B, int H, int W,
                          int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(B, H, W, C);
  const float *a = static_cast<const float*>(avec),
              *b = static_cast<const float*>(bvec);
  const bool vec16 = aligned(y, 16) && aligned(gy, 16) &&
                     aligned(gmax, 16) && aligned(gmin, 16);
  if (dtype == 0) {
    if (vec16 && aligned(imax, 4) && aligned(imin, 4) && C % 4 == 0)
      return launch_bwd<float, 4>(y, a, b, gmax, imax, gmin, imin, gy, g, st);
    return launch_bwd<float, 1>(y, a, b, gmax, imax, gmin, imin, gy, g, st);
  }
  if (dtype == 1) {
    if (vec16 && aligned(imax, 8) && aligned(imin, 8) && C % 8 == 0)
      return launch_bwd<__nv_bfloat16, 8>(y, a, b, gmax, imax, gmin, imin, gy,
                                          g, st);
    return launch_bwd<__nv_bfloat16, 1>(y, a, b, gmax, imax, gmin, imin, gy,
                                        g, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* fpsg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
