// Both-direction nearest neighbour of two point clouds, for the Chamfer
// distance: min squared distance and FIRST argmin, x -> y and y -> x.
//
// Replaces fpsg_tpu/ops/chamfer.py:_nn_pallas_both (kernel _nn_kernel).
// Both directions reduce ONE distance matrix
//
//   d[i, j] = max((|x_i|^2 - 2 x_i . y_j) + |y_j|^2, 0)
//
// in f32, every operation rounded on its own in this order (no FMA
// contraction: __fmul_rn / __fadd_rn), with |p|^2 = (p0 p0 + p1 p1) + p2 p2
// and x . y = (x0 y0 + x1 y1) + x2 y2. The plain PyTorch version
// (fpsg_torch/ops/pairwise.py) rounds the same operations in the same
// order, so the two agree bit for bit, ties included. Rows give
// (min_xy, arg_xy), columns (min_yx, arg_yx); ties go to the first index.
//
// Bound: operations (3 products, 5 adds and a compare per pair and
// direction; B x N x M pairs). Design: the TPU kernel carries a running
// column minimum across its sequential row-tile grid, which CUDA blocks
// cannot share. Here each direction is its own set of blocks in one launch
// (blockIdx.z): a block owns 128 query points, one per thread, and streams
// the other cloud through shared memory in tiles of 1024 points stored as
// float4 (x, y, z, |p|^2), so each pair costs one broadcast shared load.
// A strict '<' scan in index order keeps the first minimum. The column
// direction evaluates the very same expression with the roles of the loops
// swapped, so both directions see identical d[i, j].
//
// C interface (loaded with ctypes): every entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 128;    // query points per block (one per thread)
constexpr int RT = 1024;   // reference points per shared-memory tile

__device__ __forceinline__ float sqnorm(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}

// d = max((xsq - 2 x.y) + ysq, 0), rounded op by op.
__device__ __forceinline__ float sqdist(float4 x, float4 y) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(x.x, y.x),
                                        __fmul_rn(x.y, y.y)),
                              __fmul_rn(x.z, y.z));
  const float d = __fadd_rn(__fsub_rn(x.w, __fmul_rn(2.f, dot)), y.w);
  return fmaxf(d, 0.f);
}

// DIR 0: queries are x, references y (rows). DIR 1: queries are y,
// references x (columns). p.w holds |p|^2.
template <int DIR>
__device__ __forceinline__ void nearest(const float* __restrict__ q,
                                        const float* __restrict__ r, int nq,
                                        int nr, float* __restrict__ dmin,
                                        int* __restrict__ amin,
                                        float4* tile) {
  const int i = blockIdx.x * QT + threadIdx.x;
  float4 me = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < nq) {
    me.x = q[3LL * i];
    me.y = q[3LL * i + 1];
    me.z = q[3LL * i + 2];
    me.w = sqnorm(me.x, me.y, me.z);
  }
  float best = INFINITY;
  int bi = 0;
  for (int base = 0; base < nr; base += RT) {
    const int cnt = min(RT, nr - base);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += QT) {
      const float* p = r + 3LL * (base + t);
      float4 v = make_float4(p[0], p[1], p[2], 0.f);
      v.w = sqnorm(v.x, v.y, v.z);
      tile[t] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < cnt; ++t) {
      const float d = DIR == 0 ? sqdist(me, tile[t]) : sqdist(tile[t], me);
      if (d < best) {
        best = d;
        bi = base + t;
      }
    }
  }
  if (i < nq) {
    dmin[i] = best;
    amin[i] = bi;
  }
}

__global__ void __launch_bounds__(QT)
nn_both_kernel(const float* __restrict__ x, const float* __restrict__ y,
               int N, int M, float* __restrict__ min_xy,
               int* __restrict__ arg_xy, float* __restrict__ min_yx,
               int* __restrict__ arg_yx) {
  __shared__ float4 tile[RT];
  const long long b = blockIdx.y;
  const float* xb = x + b * N * 3;
  const float* yb = y + b * M * 3;
  if (blockIdx.z == 0) {
    if (blockIdx.x * QT >= N) return;  // the whole block: no sync skipped
    nearest<0>(xb, yb, N, M, min_xy + b * N, arg_xy + b * N, tile);
  } else {
    if (blockIdx.x * QT >= M) return;
    nearest<1>(yb, xb, M, N, min_yx + b * M, arg_yx + b * M, tile);
  }
}

}  // namespace

extern "C" {

// x: (B, N, 3), y: (B, M, 3) contiguous f32. Outputs: min_xy, arg_xy (B, N)
// f32 / int32 and min_yx, arg_yx (B, M).
int fpsg_chamfer_nn(const void* x, const void* y, int B, int N, int M,
                    void* min_xy, void* arg_xy, void* min_yx, void* arg_yx,
                    void* stream) {
  if (B == 0 || N == 0 || M == 0) return (int)cudaGetLastError();
  const int tiles = ((N > M ? N : M) + QT - 1) / QT;
  const dim3 grid(tiles, B, 2);
  nn_both_kernel<<<grid, QT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), N, M,
      static_cast<float*>(min_xy), static_cast<int*>(arg_xy),
      static_cast<float*>(min_yx), static_cast<int*>(arg_yx));
  return (int)cudaGetLastError();
}

const char* fpsg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
