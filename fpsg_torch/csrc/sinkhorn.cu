// Log-domain Sinkhorn potentials for the EMD of two point clouds, with the
// cost recomputed on the fly (never stored).
//
// Replaces fpsg_tpu/ops/emd.py:_sinkhorn_potentials_pallas (K6) and, with a
// warm-started g, _sinkhorn_potentials_pallas_warm (K11): the same kernel
// body (_sinkhorn_kernel_factory, emd.py:92-206). For clouds x (B, N, 3),
// y (B, M, 3) and the iteration's epsilon e = sched[it]:
//
//   C_ij = max((|x_i|^2 - 2 x_i . y_j) + |y_j|^2, 0)
//   f_i  = -e LSE_j[(g_j - C_ij) / e + log_nu]    (reads the previous g)
//   g_j  = -e LSE_i[(f_i - C_ij) / e + log_mu]    (reads the f just stored)
//
// each stored as old + w (new - old), w = omega once it > t_anneal, else
// 1. C is rounded op by op in the order of fpsg_torch/ops/pairwise.py
// (__fmul_rn / __fadd_rn, as csrc/chamfer.cu), so it is bit for bit the
// plain version's cost matrix in both half-iterations. Full f32 FMAs, no
// TF32, no tensor cores (Precision.HIGHEST in the TPU kernel). The LSE is
// in base 2 with the scale folded in: v2 = (other_j - C_ij) * (log2(e') / e)
// + log_w * log2(e'), summed with exp2f and closed with log2f; compiled
// without --use_fast_math.
//
// Early exit, per cloud as in the Pallas kernel (a while_loop per grid
// program): delta = max_i |f_new - f_old| of the UNRELAXED f step; with
// tol > 0 cloud b runs iteration it while it <= t_anneal + 1 or its delta
// of iteration it - 1 is > tol (tol = 0: every iteration). The state lives
// in device memory: done[b], iters[b], and delta[2][b] (two buffers by the
// parity of it: the f launch of iteration it reads delta[(it - 1) & 1] and
// maxes into delta[it & 1]; the g launch zeroes the next one). delta is a
// per-block max, then an atomicMax on the float's bits (non-negative, so
// the unsigned order is the float order; a max does not depend on the
// order, so the result is the same every run). A finished cloud's blocks
// return at once.
//
// Bound: the exponentials, 2 B N M per iteration (16 MUFU ex2 a clock per
// SM); bytes are negligible. Design: the TPU kernel walks its (b,) grid in
// order with everything in VMEM. Here every half-iteration is one launch
// over the whole card: a block owns 32 rows of one cloud (8 warps, 4 rows
// a warp), streams the other cloud's points (x, y, z, |p|^2) and potential
// through shared memory in tiles of 1024, and each lane keeps an online
// (max, sum) per row over its columns, 8 columns a chunk (one rescale per
// chunk); the warp merges its lanes' pairs by shuffles. The two halves of an
// iteration meet across launches; the whole loop of 1 + 2 n_iters launches
// runs in fpsg_sinkhorn, on one stream, with no host sync.
//
// C interface (loaded with ctypes): returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;                  // rows per warp
constexpr int ROWS = WARPS * RPW;       // rows per block
constexpr int TILE = 1024;              // columns per shared-memory tile
constexpr int CH = 8;                   // columns per lane per chunk
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sqnorm(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}

// C = max((|x|^2 - 2 x.y) + |y|^2, 0); p.w holds |p|^2.
__device__ __forceinline__ float cost(float4 x, float4 y) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(x.x, y.x),
                                        __fmul_rn(x.y, y.y)),
                              __fmul_rn(x.z, y.z));
  return fmaxf(__fadd_rn(__fsub_rn(x.w, __fmul_rn(2.f, dot)), y.w), 0.f);
}

__device__ __forceinline__ float4 load_point(const float* p) {
  float4 v = make_float4(p[0], p[1], p[2], 0.f);
  v.w = sqnorm(v.x, v.y, v.z);
  return v;
}

__global__ void init_kernel(float* __restrict__ f, float* __restrict__ g,
                            const float* __restrict__ g0, int B, int N,
                            int M, int* __restrict__ iters,
                            int* __restrict__ done,
                            unsigned* __restrict__ delta) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t < (long long)B * N) f[t] = 0.f;
  if (t < (long long)B * M) g[t] = g0 ? g0[t] : 0.f;
  if (t < B) {
    iters[t] = 0;
    done[t] = 0;
    delta[t] = 0u;                       // maxed into by iteration 0
    delta[B + t] = __float_as_uint(1e30f);   // "previous" of iteration 0
  }
}

// One half-iteration for the rows of one cloud per blockIdx.y. F_UPDATE:
// rows are x (updating f from g), else rows are y (updating g from f).
template <bool F_UPDATE>
__global__ void __launch_bounds__(THREADS)
half_iter_kernel(const float* __restrict__ rows_pts,
                 const float* __restrict__ cols_pts,
                 const float* __restrict__ other, float* __restrict__ pot,
                 int n_rows, int n_cols, float log_w,
                 const float* __restrict__ sched, int it, int t_anneal,
                 float omega, float tol, int* __restrict__ done,
                 int* __restrict__ iters, unsigned* __restrict__ delta,
                 int B) {
  __shared__ float4 tile[TILE];
  __shared__ float tpot[TILE];
  __shared__ float wmax[WARPS];
  const int b = blockIdx.y;
  if (done[b]) return;
  if (F_UPDATE) {
    const float prev = __uint_as_float(delta[((it + 1) & 1) * B + b]);
    if (tol > 0.f && it > t_anneal + 1 && !(prev > tol)) {
      if (threadIdx.x == 0) done[b] = 1;   // every block decides the same
      return;
    }
  } else if (blockIdx.x == 0 && threadIdx.x == 0) {
    iters[b] = it + 1;
    delta[((it + 1) & 1) * B + b] = 0u;    // the next f launch maxes here
  }

  const float e = sched[it];
  const float w = it > t_anneal ? omega : 1.f;
  const float s2 = LOG2E / e;
  const float lw2 = log_w * LOG2E;
  const float* rp = rows_pts + (long long)b * n_rows * 3;
  const float* cp = cols_pts + (long long)b * n_cols * 3;
  const float* op = other + (long long)b * n_cols;
  float* pp = pot + (long long)b * n_rows;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS + warp * RPW;
  float4 me[RPW];
  float m[RPW], s[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    me[r] = load_point(rp + 3LL * min(row0 + r, n_rows - 1));
    m[r] = -1e30f;
    s[r] = 0.f;
  }

  for (int base = 0; base < n_cols; base += TILE) {
    const int cnt = min(TILE, n_cols - base);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += THREADS) {
      tile[t] = load_point(cp + 3LL * (base + t));
      tpot[t] = op[base + t];
    }
    __syncthreads();
    for (int k0 = lane; k0 < cnt; k0 += 32 * CH) {
      float4 q[CH];
      float o[CH];
      bool ok[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int j = k0 + 32 * c;
        ok[c] = j < cnt;
        q[c] = tile[ok[c] ? j : 0];
        o[c] = tpot[ok[c] ? j : 0];
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        float v[CH];
        float cm = -INFINITY;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float cij = F_UPDATE ? cost(me[r], q[c]) : cost(q[c], me[r]);
          v[c] = ok[c] ? (o[c] - cij) * s2 + lw2 : -INFINITY;
          cm = fmaxf(cm, v[c]);
        }
        if (cm > m[r]) {
          s[r] *= exp2f(m[r] - cm);
          m[r] = cm;
        }
#pragma unroll
        for (int c = 0; c < CH; ++c) s[r] += exp2f(v[c] - m[r]);
      }
    }
  }

  float dmax = 0.f;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(FULL, m[r], off);
      const float so = __shfl_xor_sync(FULL, s[r], off);
      const float mn = fmaxf(m[r], mo);
      s[r] = s[r] * exp2f(m[r] - mn) + so * exp2f(mo - mn);
      m[r] = mn;
    }
    const int i = row0 + r;
    if (lane == r && i < n_rows) {
      const float fresh = -e * ((m[r] + log2f(s[r])) * LN2);
      const float old = pp[i];
      pp[i] = __fadd_rn(old, __fmul_rn(w, __fsub_rn(fresh, old)));
      dmax = fabsf(fresh - old);
    }
  }
  if (F_UPDATE) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dmax = fmaxf(dmax, __shfl_xor_sync(FULL, dmax, off));
    if (lane == 0) wmax[warp] = dmax;
    __syncthreads();
    if (threadIdx.x == 0) {
      float bm = wmax[0];
      for (int k = 1; k < WARPS; ++k) bm = fmaxf(bm, wmax[k]);
      atomicMax(&delta[(it & 1) * B + b], __float_as_uint(bm));
    }
  }
}

}  // namespace

extern "C" {

// x: (B, N, 3), y: (B, M, 3) contiguous f32; g0: (B, M) or NULL (K6: g
// starts at 0); sched: (n_iters,) f32 epsilons on the device. Outputs f
// (B, N), g (B, M) f32 and iters (B,) int32 (iterations each cloud ran);
// scratch: 3 B int32 (done flags and the two delta buffers).
int fpsg_sinkhorn(const void* x, const void* y, const void* g0,
                  const void* sched, int B, int N, int M, int n_iters,
                  int t_anneal, float log_mu, float log_nu, float omega,
                  float tol, void* f, void* g, void* iters, void* scratch,
                  void* stream) {
  if (B == 0 || N == 0 || M == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* yp = static_cast<const float*>(y);
  float* fp = static_cast<float*>(f);
  float* gp = static_cast<float*>(g);
  int* ip = static_cast<int*>(iters);
  int* done = static_cast<int*>(scratch);
  unsigned* delta = reinterpret_cast<unsigned*>(done + B);
  const float* sp = static_cast<const float*>(sched);

  const long long most = (long long)B * (N > M ? N : M);
  init_kernel<<<(unsigned)((most + 255) / 256), 256, 0, st>>>(
      fp, gp, static_cast<const float*>(g0), B, N, M, ip, done, delta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_f((N + ROWS - 1) / ROWS, B), grid_g((M + ROWS - 1) / ROWS, B);
  for (int it = 0; it < n_iters; ++it) {
    half_iter_kernel<true><<<grid_f, THREADS, 0, st>>>(
        xp, yp, gp, fp, N, M, log_nu, sp, it, t_anneal, omega, tol, done,
        ip, delta, B);
    half_iter_kernel<false><<<grid_g, THREADS, 0, st>>>(
        yp, xp, fp, gp, M, N, log_mu, sp, it, t_anneal, omega, tol, done,
        ip, delta, B);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* fpsg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
