// Fused layers of the primitive decoder's node chain: forward (with and
// without the output statistics) and backward.
//
// Replace the Pallas kernels of fpsg_tpu/nn/fused_stack.py:
//   fused_l1[_stats]   <- _fused_l1_fwd  (_l1_fwd_kernel_factory)      K5d
//   fused_mid[_stats]  <- _fused_mid_fwd (_mid_fwd_kernel_factory)     K5a
//   fused_out          <- _fused_out_fwd (_out_fwd_kernel_factory)     K5f
//   fused_mid_dx       <- _fused_mid_bwd_impl (_mid_bwd_dx_kernel_...)  K5b
//   fused_mid_dw       <- _fused_mid_bwd_impl (_mid_bwd_dw_kernel_...)  K5c
//   fused_l1_bwd       <- _fused_l1_bwd_impl  (_l1_bwd_kernel_factory)  K5e
//   fused_out_bwd      <- _fused_out_bwd_impl (_out_bwd_kernel_factory) K5g
//
// Layout (as in the JAX package): activations group-major (G = C*Nn, R, D)
// row-major, weights (G, Din, Dout), per-channel vectors (G, D) f32. T is
// float or __nv_bfloat16. The previous BN's affine is applied in T: k and
// b round to T, then one rounding after the multiply and one after the add
// (the TPU kernels compute `yp * k.astype(dt) + b.astype(dt)` in dt), then
// relu; the relu mask of the backward is `pre > 0` (strict). Cotangents
// are formed in f32 and round to T once before they enter a product.
// Products accumulate in f32; each output rounds once.
//
// One GEMM core, three operand orders: A.W (K5a), G.W^T (K5b), A^T.G (K5c).
// Operands are loaded through functors (the prologue: affine + relu of the
// activation, or the statistics' cotangents folded into the output's
// cotangent), and each kernel has its own epilogue (rounding, output
// statistics, relu mask and k, per-channel reduces). Tiles are 128 x 128
// per block of 256 threads; the next k-slice is fetched into registers
// while the current one is multiplied, without edge checks when the whole
// slice lies inside the operand (scalar loads: the odd widths 1539 and
// 769 leave rows unaligned for vector loads). In f32 the core is a SIMT
// FMA loop (8 x 8 outputs a thread, 16-deep slices): f32 stays full f32.
// In bf16 it is mma.sync.m16n8k16 (bf16 in, f32 accumulate) on 32-deep
// slices: 8 warps as 2 x 4, each 64 x 32 outputs, fragments read with
// 32-bit shared-memory loads from k-contiguous rows padded to 40 elements
// (no bank conflicts). No cp.async, TMA or wgmma yet: the loads, not the
// tensor cores, bound it (PERF.md).
//
// Sums across rows (the statistics, dk, db, dbias, dW of the output layer,
// dWd, and dd across column chunks) never use float atomics: each block
// writes its partial sums, reduced inside the block in a fixed order, and
// a second kernel of the same call adds the partials in a fixed order, so
// every run gives the same bits. K5c keeps its whole reduction (over R)
// inside the block.
//
// Bounds on the card (bf16, at the training step's ad pass: G = 16,
// R = 32 x 128, widths 1539 -> 769 -> 384 -> 3):
//   fused_mid[_stats], fused_mid_dx, fused_mid_dw: operations (each
//       2 G R Din Dout, 0.19 TFLOP for both mid layers).
//   fused_l1[_stats], fused_l1_bwd, fused_out, fused_out_bwd: bytes (the
//       row tensors they read and write once; K = 3 or N = 3).
//
// C interface (loaded with ctypes): dtype 0 = f32, 1 = bf16; every entry
// point returns cudaGetLastError() after its launches.

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

// yp * k + b in T; k and b already rounded to T. No FMA contraction: the
// multiply and the add round separately, as in the plain version.
template <typename T>
__device__ __forceinline__ float pre_affine(float yp, float k, float b) {
  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(yp, k)), b));
}

template <typename T>
__device__ __forceinline__ float affine_relu(float yp, float k, float b) {
  return fmaxf(pre_affine<T>(yp, k, b), 0.0f);
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// ---------------------------------------------------------------------------
// Second pass of every row sum: out[qg][c] = sum_nb part[qg][nb][c], in
// increasing nb, rounded once to TO.
// ---------------------------------------------------------------------------

template <typename TO>
__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 TO* __restrict__ out, int QG, int NB, int L) {
  const long long n = (long long)QG * L;
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x; o < n;
       o += (long long)gridDim.x * blockDim.x) {
    const long long qg = o / L, c = o % L;
    const float* p = part + qg * NB * L + c;
    float a = 0.0f;
    for (int nb = 0; nb < NB; ++nb) a += p[(long long)nb * L];
    st(out + o, a);
  }
}

template <typename TO>
void sum_parts(const float* part, TO* out, int QG, int NB, int L,
               cudaStream_t s) {
  long long blocks = ((long long)QG * L + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  sum_parts_kernel<TO><<<(int)blocks, 256, 0, s>>>(part, out, QG, NB, L);
}

// ---------------------------------------------------------------------------
// The GEMM core: a 128 x 128 output tile per block of 256 threads. Each
// thread holds 8 x 8 outputs at rows row(i) and columns col(j) of the tile;
// the threads of one row_group() (16 groups of 8 rows) cover all 128
// columns once, which the per-column reductions use.
// ---------------------------------------------------------------------------

constexpr int GT = 256;
constexpr int TM = 128, TN = 128;


template <typename T>
struct Core;

template <>
struct Core<float> {
  static constexpr int BK = 16;
  struct Smem {
    float a[BK][TM + 4];  // k-major; +4 keeps 16-byte rows
    float b[BK][TN + 4];
  };
  float acc[8][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  __device__ __forceinline__ static void put_a(Smem& s, int i, int kk,
                                               float v) {
    s.a[kk][i] = v;
  }
  __device__ __forceinline__ static void put_b(Smem& s, int j, int kk,
                                               float v) {
    s.b[kk][j] = v;
  }
  __device__ __forceinline__ void step(const Smem& s) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int kc = 0; kc < BK; ++kc) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[kc][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s.a[kc][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[kc][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s.b[kc][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ __forceinline__ static int row(int i) {
    const int ty = threadIdx.x / 16;
    return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
  }
  __device__ __forceinline__ static int col(int j) {
    const int tx = threadIdx.x % 16;
    return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
  }
  __device__ __forceinline__ static int row_group() {
    return threadIdx.x / 16;
  }
  __device__ __forceinline__ float get(int i, int j) const {
    return acc[i][j];
  }
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
struct Core<__nv_bfloat16> {
  static constexpr int BK = 32;
  static constexpr int LDS = BK + 8;  // row stride: conflict-free fragments
  struct Smem {  // bf16 bits, k-contiguous rows
    unsigned short a[TM][LDS];
    unsigned short b[TN][LDS];
  };
  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.0f;
  }
  __device__ __forceinline__ static void put_a(Smem& s, int i, int kk,
                                               float v) {
    s.a[i][kk] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static void put_b(Smem& s, int j, int kk,
                                               float v) {
    s.b[j][kk] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ void step(const Smem& s) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 4, wn = warp % 4, gid = lane / 4, tig = lane % 4;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const unsigned short* p = &s.a[wm * 64 + m * 16 + gid][ks + tig * 2];
        af[m][0] = *reinterpret_cast<const uint32_t*>(p);
        af[m][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[m][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[m][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const unsigned short* q = &s.b[wn * 32 + n * 8 + gid][ks + tig * 2];
        bf[n][0] = *reinterpret_cast<const uint32_t*>(q);
        bf[n][1] = *reinterpret_cast<const uint32_t*>(q + 8);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_bf16(acc[m][n], af[m], bf[n]);
    }
  }
  __device__ __forceinline__ static int row(int i) {
    const int warp = threadIdx.x / 32, gid = (threadIdx.x % 32) / 4;
    return (warp / 4) * 64 + (i >> 1) * 16 + (i & 1) * 8 + gid;
  }
  __device__ __forceinline__ static int col(int j) {
    const int warp = threadIdx.x / 32, tig = threadIdx.x % 4;
    return (warp % 4) * 32 + (j >> 1) * 8 + tig * 2 + (j & 1);
  }
  __device__ __forceinline__ static int row_group() {
    return (threadIdx.x / 128) * 8 + (threadIdx.x % 32) / 4;
  }
  __device__ __forceinline__ float get(int i, int j) const {
    return acc[i >> 1][j >> 1][(i & 1) * 2 + (j & 1)];
  }
};

// Tile element e of a thread's share -> (i, kk): KFAST when the operand is
// contiguous along k in memory (consecutive threads take consecutive k).
template <typename C, bool KFAST>
__device__ __forceinline__ void tile_index(int e, int& i, int& kk) {
  if (KFAST) {
    i = e / C::BK;
    kk = e % C::BK;
  } else {
    kk = e / TM;
    i = e % TM;
  }
}

template <typename C, bool KFAST, typename F>
struct Loader {
  static constexpr int NL = TM * C::BK / GT;
  float v[NL];
  // Interior tiles (the operand's full()) skip the per-element edge checks.
  template <bool CHECK>
  __device__ __forceinline__ void fetch_(const F& f, int k0) {
#pragma unroll
    for (int t = 0; t < NL; ++t) {
      int i, kk;
      tile_index<C, KFAST>(threadIdx.x + t * GT, i, kk);
      v[t] = f.template at<CHECK>(i, k0 + kk);
    }
  }
  __device__ __forceinline__ void fetch(const F& f, int k0) {
    if (f.full(k0, C::BK))
      fetch_<false>(f, k0);
    else
      fetch_<true>(f, k0);
  }
  template <bool A>
  __device__ __forceinline__ void put(typename C::Smem& s) const {
#pragma unroll
    for (int t = 0; t < NL; ++t) {
      int i, kk;
      tile_index<C, KFAST>(threadIdx.x + t * GT, i, kk);
      if (A)
        C::put_a(s, i, kk, v[t]);
      else
        C::put_b(s, i, kk, v[t]);
    }
  }
};

// acc = sum_k A(i, k) B(j, k) over k < K; the next slice is fetched into
// registers while the current one is multiplied.
template <typename T, bool AK, bool BKF, typename FA, typename FB>
__device__ __forceinline__ void gemm(Core<T>& core, typename Core<T>::Smem& s,
                                     const FA& fa, const FB& fb, int K) {
  constexpr int BK = Core<T>::BK;
  Loader<Core<T>, AK, FA> la;
  Loader<Core<T>, BKF, FB> lb;
  core.zero();
  la.fetch(fa, 0);
  lb.fetch(fb, 0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    la.template put<true>(s);
    lb.template put<false>(s);
    __syncthreads();
    if (k0 + BK < K) {
      la.fetch(fa, k0 + BK);
      lb.fetch(fb, k0 + BK);
    }
    core.step(s);
    __syncthreads();
  }
}

// Per-column sums of NQ quantities over the block's rows: each thread's
// values v[q][j] (its rows, in order) go to red[q][row group][column], and
// the 16 row groups are added in order; the block's partial lands at
// part[q][g][mb][n0 + c] of a (NQ, G, NMB, L) buffer.
template <typename C, int NQ>
__device__ __forceinline__ void col_sums(float (*red)[16][TN],
                                         float (*v)[8], float* part,
                                         int G, int g, int mb, int nmb,
                                         int n0, int L) {
  const int rg = C::row_group();
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j) red[q][rg][C::col(j)] = v[q][j];
  __syncthreads();
  for (int t = threadIdx.x; t < NQ * TN; t += GT) {
    const int q = t / TN, c = t % TN;
    if (n0 + c >= L) continue;
    float a = 0.0f;
    for (int r = 0; r < 16; ++r) a += red[q][r][c];
    part[(((long long)q * G + g) * nmb + mb) * L + n0 + c] = a;
  }
}

// --- operand functors: f(i, k) for tile index i and global k -------------
// Each maps (i, k) to (row, column) of a row-major (rows, cols) operand;
// at<CHECK> reads 0 outside it, full() says whether a tile has no edge.

template <bool ROWS>
struct Span {  // ROWS: i runs over rows (offset m0), k over columns
  int rows, cols, m0;
  __device__ __forceinline__ int row(int i, int kg) const {
    return ROWS ? m0 + i : kg;
  }
  __device__ __forceinline__ int col(int i, int kg) const {
    return ROWS ? kg : m0 + i;
  }
  __device__ __forceinline__ bool in(int r, int c) const {
    return r < rows && c < cols;
  }
  __device__ __forceinline__ bool full(int k0, int bk) const {
    return ROWS ? (m0 + TM <= rows && k0 + bk <= cols)
                : (m0 + TM <= cols && k0 + bk <= rows);
  }
};

// relu(k * yp + b) of a row-major (R, D) activation. ROWS: i runs over
// rows (the A of A.W), else over channels (the A^T of A^T.G).
template <typename T, bool ROWS>
struct Act {
  const T* yp;
  const float* k;
  const float* b;
  Span<ROWS> sp;
  __device__ __forceinline__ bool full(int k0, int bk) const {
    return sp.full(k0, bk);
  }
  template <bool CHECK>
  __device__ __forceinline__ float at(int i, int kg) const {
    const int r = sp.row(i, kg), c = sp.col(i, kg);
    if (CHECK && !sp.in(r, c)) return 0.0f;
    return affine_relu<T>(ld(yp + (long long)r * sp.cols + c),
                          round_to<T>(k[c]), round_to<T>(b[c]));
  }
};

// A weight W (Din, Dout) as the B operand: B(j, k) = W[k][m0 + j], or
// with TRANS (W^T) B(j, k) = W[m0 + j][k].
template <typename T, bool TRANS>
struct Wt {
  const T* w;
  Span<TRANS> sp;  // over W's (Din, Dout)
  __device__ __forceinline__ bool full(int k0, int bk) const {
    return sp.full(k0, bk);
  }
  template <bool CHECK>
  __device__ __forceinline__ float at(int j, int kg) const {
    const int r = sp.row(j, kg), c = sp.col(j, kg);
    if (CHECK && !sp.in(r, c)) return 0.0f;
    return ld(w + (long long)r * sp.cols + c);
  }
};

// The mid layer's output cotangent (R, D), rounded to T: with STATS
// gy + gzs + 2 (y - s) gzq, summed in that order in f32. ROWS as Act.
template <typename T, bool ROWS, bool STATS>
struct Gadj {
  const T* gy;
  const T* y;
  const float* s;
  const float* gzs;
  const float* gzq;
  Span<ROWS> sp;
  __device__ __forceinline__ bool full(int k0, int bk) const {
    return sp.full(k0, bk);
  }
  template <bool CHECK>
  __device__ __forceinline__ float at(int i, int kg) const {
    const int r = sp.row(i, kg), c = sp.col(i, kg);
    if (CHECK && !sp.in(r, c)) return 0.0f;
    const long long o = (long long)r * sp.cols + c;
    float g = ld(gy + o);
    if (STATS) {
      const float z = __fsub_rn(ld(y + o), s[c]);
      g = __fadd_rn(__fadd_rn(g, gzs[c]), __fmul_rn(__fmul_rn(2.0f, z),
                                                    gzq[c]));
    }
    return round_to<T>(g);
  }
};

// ---------------------------------------------------------------------------
// K5a: y[g] = relu(k * yp + b) @ w, and with STATS the per-block partial
// sums of z = round(y) - s and z^2 per column (part: (2, G, nmb, Dout)).
// ---------------------------------------------------------------------------

template <typename T, bool STATS>
__global__ void __launch_bounds__(GT)
mid_fwd_kernel(const T* __restrict__ yp, const float* __restrict__ kk,
               const float* __restrict__ bb, const T* __restrict__ w,
               const float* __restrict__ s, T* __restrict__ y,
               float* __restrict__ part, int G, int R, int Din, int Dout) {
  __shared__ __align__(16) typename Core<T>::Smem sm;
  __shared__ float red[2][16][TN];
  const int g = blockIdx.z, m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  Core<T> core;
  gemm<T, true, false>(
      core, sm,
      Act<T, true>{yp + (long long)g * R * Din, kk + (long long)g * Din,
                   bb + (long long)g * Din, {R, Din, m0}},
      Wt<T, false>{w + (long long)g * Din * Dout, {Din, Dout, n0}}, Din);
  T* yg = y + (long long)g * R * Dout;
  float v[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[0][j] = 0.0f;
    v[1][j] = 0.0f;
    const int c = n0 + Core<T>::col(j);
    if (c >= Dout) continue;
    const float sh = STATS ? s[(long long)g * Dout + c] : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + Core<T>::row(i);
      if (r >= R) continue;
      const float o = round_to<T>(core.get(i, j));
      st(yg + (long long)r * Dout + c, o);
      if (STATS) {
        const float z = __fsub_rn(o, sh);
        v[0][j] += z;
        v[1][j] += z * z;
      }
    }
  }
  if (STATS)
    col_sums<Core<T>, 2>(red, v, part, G, g, blockIdx.y, gridDim.y, n0,
                         Dout);
}

// ---------------------------------------------------------------------------
// K5b: da = g_adj @ w^T; dm = [pre > 0] da; dyp = round(dm * k); per-block
// partial sums of dk = sum dm * yp and db = sum dm (part: (2, G, nmb, Din)).
// ---------------------------------------------------------------------------

template <typename T, bool STATS>
__global__ void __launch_bounds__(GT)
mid_dx_kernel(const T* __restrict__ yp, const float* __restrict__ kk,
              const float* __restrict__ bb, const T* __restrict__ w,
              const float* __restrict__ s, const T* __restrict__ y,
              const T* __restrict__ gy, const float* __restrict__ gzs,
              const float* __restrict__ gzq, T* __restrict__ dyp,
              float* __restrict__ part, int G, int R, int Din, int Dout) {
  __shared__ __align__(16) typename Core<T>::Smem sm;
  __shared__ float red[2][16][TN];
  const int g = blockIdx.z, m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const long long go = (long long)g * R * Dout, gd = (long long)g * Dout;
  Core<T> core;
  gemm<T, true, true>(
      core, sm,
      Gadj<T, true, STATS>{gy + go, y + go, STATS ? s + gd : nullptr,
                           STATS ? gzs + gd : nullptr,
                           STATS ? gzq + gd : nullptr, {R, Dout, m0}},
      Wt<T, true>{w + (long long)g * Din * Dout, {Din, Dout, n0}}, Dout);
  const T* ypg = yp + (long long)g * R * Din;
  T* dypg = dyp + (long long)g * R * Din;
  float v[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[0][j] = 0.0f;
    v[1][j] = 0.0f;
    const int c = n0 + Core<T>::col(j);
    if (c >= Din) continue;
    const float kf = kk[(long long)g * Din + c];
    const float kd = round_to<T>(kf);
    const float bd = round_to<T>(bb[(long long)g * Din + c]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + Core<T>::row(i);
      if (r >= R) continue;
      const long long o = (long long)r * Din + c;
      const float x = ld(ypg + o);
      const float dm = pre_affine<T>(x, kd, bd) > 0.0f ? core.get(i, j)
                                                       : 0.0f;
      st(dypg + o, __fmul_rn(dm, kf));
      v[0][j] += dm * x;
      v[1][j] += dm;
    }
  }
  col_sums<Core<T>, 2>(red, v, part, G, g, blockIdx.y, gridDim.y, n0, Din);
}

// ---------------------------------------------------------------------------
// K5c: dw[g] = relu(k * yp + b)^T @ g_adj over all R rows inside the block,
// rounded once to T.
// ---------------------------------------------------------------------------

template <typename T, bool STATS>
__global__ void __launch_bounds__(GT)
mid_dw_kernel(const T* __restrict__ yp, const float* __restrict__ kk,
              const float* __restrict__ bb, const float* __restrict__ s,
              const T* __restrict__ y, const T* __restrict__ gy,
              const float* __restrict__ gzs, const float* __restrict__ gzq,
              T* __restrict__ dw, int R, int Din, int Dout) {
  __shared__ __align__(16) typename Core<T>::Smem sm;
  const int g = blockIdx.z, m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const long long go = (long long)g * R * Dout, gd = (long long)g * Dout;
  Core<T> core;
  gemm<T, false, false>(
      core, sm,
      Act<T, false>{yp + (long long)g * R * Din, kk + (long long)g * Din,
                    bb + (long long)g * Din, {R, Din, m0}},
      Gadj<T, false, STATS>{gy + go, y + go, STATS ? s + gd : nullptr,
                            STATS ? gzs + gd : nullptr,
                            STATS ? gzq + gd : nullptr, {R, Dout, n0}},
      R);
  T* dwg = dw + (long long)g * Din * Dout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + Core<T>::row(i);
    if (m >= Din) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + Core<T>::col(j);
      if (n < Dout) st(dwg + (long long)m * Dout + n, core.get(i, j));
    }
  }
}

// ---------------------------------------------------------------------------
// K5d: y[g, r, :] = d[g, r, :] @ wd[g] + yc[g, r / P, :]; with STATS the
// per-block partial sums of z = round(y) - yc, z^2 and z * sc per column
// (part: (3, G, nblocks, Dout)).
// ---------------------------------------------------------------------------

constexpr int L1_ROWS = 16, L1_STAT_ROWS = 128;
constexpr int L1_MAX_DIN = 8;

template <typename T, bool STATS>
__global__ void __launch_bounds__(256)
fused_l1_kernel(const T* __restrict__ d, const T* __restrict__ wd,
                const float* __restrict__ yc, const float* __restrict__ sc,
                T* __restrict__ y, float* __restrict__ part, int G, int R,
                int P, int Din, int Dout) {
  constexpr int ROWS = STATS ? L1_STAT_ROWS : L1_ROWS;
  const int g = blockIdx.y;
  const int r0 = blockIdx.x * ROWS;
  const int nb = R / P;
  __shared__ float ds[ROWS * L1_MAX_DIN];
  for (int e = threadIdx.x; e < ROWS * Din; e += blockDim.x) {
    const int r = r0 + e / Din;
    ds[e] = r < R ? ld(d + ((long long)g * R + r) * Din + e % Din) : 0.0f;
  }
  __syncthreads();
  const T* wg = wd + (long long)g * Din * Dout;
  const float* ycg = yc + (long long)g * nb * Dout;
  const float* scg = STATS ? sc + (long long)g * nb * Dout : nullptr;
  T* yg = y + (long long)g * R * Dout;
  const int rows = min(ROWS, R - r0);
  for (int j = threadIdx.x; j < Dout; j += blockDim.x) {
    float w[L1_MAX_DIN];
#pragma unroll
    for (int k = 0; k < L1_MAX_DIN; ++k)
      w[k] = k < Din ? ld(wg + (long long)k * Dout + j) : 0.0f;
    float zs = 0.0f, zq = 0.0f, zc = 0.0f;
    for (int r = 0; r < rows; ++r) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < L1_MAX_DIN; ++k)
        if (k < Din) acc = fmaf(ds[r * Din + k], w[k], acc);
      const int row = r0 + r;
      const long long cj = (long long)(row / P) * Dout + j;
      const float ycv = ycg[cj];
      acc += ycv;
      st(yg + (long long)row * Dout + j, acc);
      if (STATS) {
        const float z = __fsub_rn(round_to<T>(acc), ycv);
        zs += z;
        zq += z * z;
        zc += z * scg[cj];
      }
    }
    if (STATS) {
      const long long q = (long long)G * gridDim.x * Dout;
      const long long o = ((long long)g * gridDim.x + blockIdx.x) * Dout + j;
      part[o] = zs;
      part[q + o] = zq;
      part[2 * q + o] = zc;
    }
  }
}

// ---------------------------------------------------------------------------
// K5e: gt = round(gy + gzs + 2 z gzq + sc gzc) (STATS; round(gy)
// otherwise) with z = y - yc[cloud]; per block (column chunk, cloud, g):
// dyc = sum gy and dsc = (sum z) gzc over the cloud's rows (written
// directly), partial dWd = d^T gt over the cloud (ddp... (G, B, Din,
// Dout)), and partial dd = gt wd^T over the chunk's columns
// ((G, nchunk, R, Din)).
// ---------------------------------------------------------------------------

constexpr int L1B_COLS = 256;  // columns per block, one per thread
constexpr int L1B_ROWS = 32;   // rows per round of the dd reduction

template <typename T, bool STATS>
__global__ void __launch_bounds__(L1B_COLS)
l1_bwd_kernel(const T* __restrict__ d, const T* __restrict__ wd,
              const float* __restrict__ yc, const float* __restrict__ sc,
              const T* __restrict__ y, const T* __restrict__ gy,
              const float* __restrict__ gzs, const float* __restrict__ gzq,
              const float* __restrict__ gzc, float* __restrict__ dyc,
              float* __restrict__ dsc, float* __restrict__ ddp,
              float* __restrict__ dwdp, int G, int R, int P, int Din,
              int Dout) {
  __shared__ float red[L1B_COLS / 32][L1B_ROWS][L1_MAX_DIN];
  const int chunk = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int nchunk = gridDim.x, nb = gridDim.y;
  const int f = chunk * L1B_COLS + threadIdx.x;
  const bool on = f < Dout;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float w[L1_MAX_DIN], dw[L1_MAX_DIN];
#pragma unroll
  for (int i = 0; i < L1_MAX_DIN; ++i) {
    w[i] = on && i < Din ? ld(wd + ((long long)g * Din + i) * Dout + f)
                         : 0.0f;
    dw[i] = 0.0f;
  }
  const long long cb = ((long long)g * nb + b) * Dout + f;
  const float ycv = on ? yc[cb] : 0.0f;
  float scv = 0.0f, gs = 0.0f, gq = 0.0f, gc = 0.0f;
  if (STATS && on) {
    scv = sc[cb];
    gs = gzs[(long long)g * Dout + f];
    gq = gzq[(long long)g * Dout + f];
    gc = gzc[(long long)g * Dout + f];
  }
  float sum_gy = 0.0f, sum_z = 0.0f;
  const T* dg = d + (long long)g * R * Din;
  for (int t0 = 0; t0 < P; t0 += L1B_ROWS) {
    const int nr = min(L1B_ROWS, P - t0);
    for (int t = 0; t < nr; ++t) {
      const int row = b * P + t0 + t;
      float gt = 0.0f;
      if (on) {
        const long long o = ((long long)g * R + row) * Dout + f;
        const float gyv = ld(gy + o);
        sum_gy += gyv;
        gt = gyv;
        if (STATS) {
          const float z = __fsub_rn(ld(y + o), ycv);
          sum_z += z;
          const float gz = __fadd_rn(
              __fadd_rn(gs, __fmul_rn(__fmul_rn(2.0f, z), gq)),
              __fmul_rn(scv, gc));
          gt = __fadd_rn(gyv, gz);
        }
        gt = round_to<T>(gt);
      }
#pragma unroll
      for (int i = 0; i < L1_MAX_DIN; ++i) {
        if (i >= Din) break;
        dw[i] = fmaf(ld(dg + (long long)row * Din + i), gt, dw[i]);
        float p = gt * w[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) red[warp][t][i] = p;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nr * Din; e += L1B_COLS) {
      const int t = e / Din, i = e % Din;
      float a = 0.0f;
#pragma unroll
      for (int wp = 0; wp < L1B_COLS / 32; ++wp) a += red[wp][t][i];
      ddp[(((long long)g * nchunk + chunk) * R + b * P + t0 + t) * Din + i] =
          a;
    }
    __syncthreads();
  }
  if (on) {
    dyc[cb] = sum_gy;
    if (STATS) dsc[cb] = __fmul_rn(sum_z, gc);
    for (int i = 0; i < Din; ++i)
      dwdp[(((long long)g * nb + b) * Din + i) * Dout + f] = dw[i];
  }
}

// ---------------------------------------------------------------------------
// K5f: y[g] = tanh(relu(k[g] * yp[g] + b[g]) @ w[g] + bias[g]), f32
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

// ---------------------------------------------------------------------------
// K5g: gt = gy (1 - y^2) (f32), gtd = round(gt); per block of OUTB_ROWS
// rows: dyp = round([pre > 0] (gtd @ w^T) * k); per-block partials of
// dk = sum dm * yp, db = sum dm ((2, G, NB, Din)), dw = relu(pre)^T gtd
// ((G, NB, Din * Dout)) and dbias = sum gt ((G, NB, Dout)). One thread per
// channel (strided), walking the block's rows.
// ---------------------------------------------------------------------------

constexpr int OUTB_ROWS = 64, OUTB_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(OUTB_THREADS)
out_bwd_kernel(const T* __restrict__ yp, const float* __restrict__ kk,
               const float* __restrict__ bb, const T* __restrict__ w,
               const float* __restrict__ y, const float* __restrict__ gy,
               T* __restrict__ dyp, float* __restrict__ part_kb,
               float* __restrict__ part_w, float* __restrict__ part_bias,
               int G, int R, int Din, int Dout) {
  __shared__ float gtf[OUTB_ROWS][OUT_MAX_DOUT];  // gt, f32
  __shared__ float gtd[OUTB_ROWS][OUT_MAX_DOUT];  // gt rounded to T
  const int g = blockIdx.y, rb = blockIdx.x, nbk = gridDim.x;
  const int r0 = rb * OUTB_ROWS, rows = min(OUTB_ROWS, R - r0);
  for (int e = threadIdx.x; e < rows * Dout; e += blockDim.x) {
    const int r = e / Dout, o = e % Dout;
    const long long idx = ((long long)g * R + r0 + r) * Dout + o;
    const float yv = y[idx];
    const float gt = __fmul_rn(gy[idx], __fsub_rn(1.0f, __fmul_rn(yv, yv)));
    gtf[r][o] = gt;
    gtd[r][o] = round_to<T>(gt);
  }
  __syncthreads();
  if (threadIdx.x < Dout) {
    float a = 0.0f;
    for (int r = 0; r < rows; ++r) a += gtf[r][threadIdx.x];
    part_bias[((long long)g * nbk + rb) * Dout + threadIdx.x] = a;
  }
  for (int c = threadIdx.x; c < Din; c += blockDim.x) {
    const float kf = kk[(long long)g * Din + c];
    const float kd = round_to<T>(kf);
    const float bd = round_to<T>(bb[(long long)g * Din + c]);
    float wv[OUT_MAX_DOUT], dwv[OUT_MAX_DOUT];
#pragma unroll
    for (int o = 0; o < OUT_MAX_DOUT; ++o) {
      wv[o] = o < Dout ? ld(w + ((long long)g * Din + c) * Dout + o) : 0.0f;
      dwv[o] = 0.0f;
    }
    float sk = 0.0f, sb = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const long long idx = ((long long)g * R + r0 + r) * Din + c;
      const float x = ld(yp + idx);
      const float pre = pre_affine<T>(x, kd, bd);
      float da = 0.0f;
#pragma unroll
      for (int o = 0; o < OUT_MAX_DOUT; ++o)
        if (o < Dout) da = fmaf(gtd[r][o], wv[o], da);
      const float dm = pre > 0.0f ? da : 0.0f;
      st(dyp + idx, __fmul_rn(dm, kf));
      sk += dm * x;
      sb += dm;
      const float a = fmaxf(pre, 0.0f);
#pragma unroll
      for (int o = 0; o < OUT_MAX_DOUT; ++o)
        if (o < Dout) dwv[o] = fmaf(a, gtd[r][o], dwv[o]);
    }
    const long long q = (long long)G * nbk * Din;
    const long long o1 = ((long long)g * nbk + rb) * Din + c;
    part_kb[o1] = sk;
    part_kb[q + o1] = sb;
    for (int o = 0; o < Dout; ++o)
      part_w[(((long long)g * nbk + rb) * Din + c) * Dout + o] = dwv[o];
  }
}

// --- launchers --------------------------------------------------------------

template <typename T>
int l1(const void* d, const void* wd, const void* yc, void* y, int G, int R,
       int P, int Din, int Dout, cudaStream_t s) {
  if (Din > L1_MAX_DIN || P <= 0 || R % P != 0) return cudaErrorInvalidValue;
  dim3 grid(ceil_div(R, L1_ROWS), G);
  fused_l1_kernel<T, false><<<grid, 256, 0, s>>>(
      static_cast<const T*>(d), static_cast<const T*>(wd),
      static_cast<const float*>(yc), nullptr, static_cast<T*>(y), nullptr, G,
      R, P, Din, Dout);
  return (int)cudaGetLastError();
}

template <typename T>
int l1_stats(const void* d, const void* wd, const void* yc, const void* sc,
             void* y, void* part, void* stats, int G, int R, int P, int Din,
             int Dout, cudaStream_t s) {
  if (Din > L1_MAX_DIN || P <= 0 || R % P != 0) return cudaErrorInvalidValue;
  const int nb = ceil_div(R, L1_STAT_ROWS);
  dim3 grid(nb, G);
  fused_l1_kernel<T, true><<<grid, 256, 0, s>>>(
      static_cast<const T*>(d), static_cast<const T*>(wd),
      static_cast<const float*>(yc), static_cast<const float*>(sc),
      static_cast<T*>(y), static_cast<float*>(part), G, R, P, Din, Dout);
  sum_parts<float>(static_cast<const float*>(part), static_cast<float*>(stats),
                   3 * G, nb, Dout, s);
  return (int)cudaGetLastError();
}

template <typename T, bool STATS>
int mid(const void* yp, const void* k, const void* b, const void* w,
        const void* sh, void* y, void* part, void* stats, int G, int R,
        int Din, int Dout, cudaStream_t s) {
  dim3 grid(ceil_div(Dout, TN), ceil_div(R, TM), G);
  mid_fwd_kernel<T, STATS><<<grid, GT, 0, s>>>(
      static_cast<const T*>(yp), static_cast<const float*>(k),
      static_cast<const float*>(b), static_cast<const T*>(w),
      static_cast<const float*>(sh), static_cast<T*>(y),
      static_cast<float*>(part), G, R, Din, Dout);
  if (STATS)
    sum_parts<float>(static_cast<const float*>(part),
                     static_cast<float*>(stats), 2 * G, grid.y, Dout, s);
  return (int)cudaGetLastError();
}

template <typename T, bool STATS>
int mid_dx(const void* yp, const void* k, const void* b, const void* w,
           const void* sh, const void* y, const void* gy, const void* gzs,
           const void* gzq, void* dyp, void* part, void* dkdb, int G, int R,
           int Din, int Dout, cudaStream_t s) {
  dim3 grid(ceil_div(Din, TN), ceil_div(R, TM), G);
  mid_dx_kernel<T, STATS><<<grid, GT, 0, s>>>(
      static_cast<const T*>(yp), static_cast<const float*>(k),
      static_cast<const float*>(b), static_cast<const T*>(w),
      static_cast<const float*>(sh), static_cast<const T*>(y),
      static_cast<const T*>(gy), static_cast<const float*>(gzs),
      static_cast<const float*>(gzq), static_cast<T*>(dyp),
      static_cast<float*>(part), G, R, Din, Dout);
  sum_parts<float>(static_cast<const float*>(part), static_cast<float*>(dkdb),
                   2 * G, grid.y, Din, s);
  return (int)cudaGetLastError();
}

template <typename T, bool STATS>
int mid_dw(const void* yp, const void* k, const void* b, const void* sh,
           const void* y, const void* gy, const void* gzs, const void* gzq,
           void* dw, int G, int R, int Din, int Dout, cudaStream_t s) {
  dim3 grid(ceil_div(Dout, TN), ceil_div(Din, TM), G);
  mid_dw_kernel<T, STATS><<<grid, GT, 0, s>>>(
      static_cast<const T*>(yp), static_cast<const float*>(k),
      static_cast<const float*>(b), static_cast<const float*>(sh),
      static_cast<const T*>(y), static_cast<const T*>(gy),
      static_cast<const float*>(gzs), static_cast<const float*>(gzq),
      static_cast<T*>(dw), R, Din, Dout);
  return (int)cudaGetLastError();
}

template <typename T, bool STATS>
int l1_bwd(const void* d, const void* wd, const void* yc, const void* sc,
           const void* y, const void* gy, const void* gzs, const void* gzq,
           const void* gzc, void* dd, void* dwd, void* dyc, void* dsc,
           void* part, int G, int R, int P, int Din, int Dout,
           cudaStream_t s) {
  if (Din > L1_MAX_DIN || P <= 0 || R % P != 0) return cudaErrorInvalidValue;
  const int nchunk = ceil_div(Dout, L1B_COLS), nb = R / P;
  float* ddp = static_cast<float*>(part);
  float* dwdp = ddp + (long long)G * nchunk * R * Din;
  dim3 grid(nchunk, nb, G);
  l1_bwd_kernel<T, STATS><<<grid, L1B_COLS, 0, s>>>(
      static_cast<const T*>(d), static_cast<const T*>(wd),
      static_cast<const float*>(yc), static_cast<const float*>(sc),
      static_cast<const T*>(y), static_cast<const T*>(gy),
      static_cast<const float*>(gzs), static_cast<const float*>(gzq),
      static_cast<const float*>(gzc), static_cast<float*>(dyc),
      static_cast<float*>(dsc), ddp, dwdp, G, R, P, Din, Dout);
  sum_parts<T>(ddp, static_cast<T*>(dd), G, nchunk, R * Din, s);
  sum_parts<T>(dwdp, static_cast<T*>(dwd), G, nb, Din * Dout, s);
  return (int)cudaGetLastError();
}

template <typename T>
int out(const void* yp, const void* k, const void* b, const void* w,
        const void* bias, void* y, int G, int R, int Din, int Dout,
        cudaStream_t s) {
  if (Dout > OUT_MAX_DOUT) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)Din * Dout + 2 * Din);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid(ceil_div(R, OUT_ROWS), G);
  fused_out_kernel<T><<<grid, 256, smem, s>>>(
      static_cast<const T*>(yp), static_cast<const float*>(k),
      static_cast<const float*>(b), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), R, Din, Dout);
  return (int)cudaGetLastError();
}

template <typename T>
int out_bwd(const void* yp, const void* k, const void* b, const void* w,
            const void* y, const void* gy, void* dyp, void* part, void* dkdb,
            void* dw, void* dbias, int G, int R, int Din, int Dout,
            cudaStream_t s) {
  if (Dout > OUT_MAX_DOUT) return cudaErrorInvalidValue;
  const int nbk = ceil_div(R, OUTB_ROWS);
  float* part_kb = static_cast<float*>(part);
  float* part_w = part_kb + 2LL * G * nbk * Din;
  float* part_bias = part_w + (long long)G * nbk * Din * Dout;
  dim3 grid(nbk, G);
  out_bwd_kernel<T><<<grid, OUTB_THREADS, 0, s>>>(
      static_cast<const T*>(yp), static_cast<const float*>(k),
      static_cast<const float*>(b), static_cast<const T*>(w),
      static_cast<const float*>(y), static_cast<const float*>(gy),
      static_cast<T*>(dyp), part_kb, part_w, part_bias, G, R, Din, Dout);
  sum_parts<float>(part_kb, static_cast<float*>(dkdb), 2 * G, nbk, Din, s);
  sum_parts<T>(part_w, static_cast<T*>(dw), G, nbk, Din * Dout, s);
  sum_parts<float>(part_bias, static_cast<float*>(dbias), G, nbk, Dout, s);
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

int fpsg_fused_l1_fwd_stats(int dtype, const void* d, const void* wd,
                            const void* yc, const void* sc, void* y,
                            void* part, void* stats, int G, int R, int P,
                            int Din, int Dout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return l1_stats<float>(d, wd, yc, sc, y, part, stats, G, R, P, Din, Dout,
                           s);
  if (dtype == 1)
    return l1_stats<__nv_bfloat16>(d, wd, yc, sc, y, part, stats, G, R, P,
                                   Din, Dout, s);
  return (int)cudaErrorInvalidValue;
}

int fpsg_fused_mid_fwd(int dtype, const void* yp, const void* k,
                       const void* b, const void* w, void* y, int G, int R,
                       int Din, int Dout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mid<float, false>(yp, k, b, w, nullptr, y, nullptr, nullptr, G, R,
                             Din, Dout, s);
  if (dtype == 1)
    return mid<__nv_bfloat16, false>(yp, k, b, w, nullptr, y, nullptr,
                                     nullptr, G, R, Din, Dout, s);
  return (int)cudaErrorInvalidValue;
}

int fpsg_fused_mid_fwd_stats(int dtype, const void* yp, const void* k,
                             const void* b, const void* w, const void* sh,
                             void* y, void* part, void* stats, int G, int R,
                             int Din, int Dout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mid<float, true>(yp, k, b, w, sh, y, part, stats, G, R, Din, Dout,
                            s);
  if (dtype == 1)
    return mid<__nv_bfloat16, true>(yp, k, b, w, sh, y, part, stats, G, R,
                                    Din, Dout, s);
  return (int)cudaErrorInvalidValue;
}

int fpsg_fused_mid_dx(int dtype, int stats, const void* yp, const void* k,
                      const void* b, const void* w, const void* sh,
                      const void* y, const void* gy, const void* gzs,
                      const void* gzq, void* dyp, void* part, void* dkdb,
                      int G, int R, int Din, int Dout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FPSG_ARGS yp, k, b, w, sh, y, gy, gzs, gzq, dyp, part, dkdb, G, R, \
                  Din, Dout, s
  if (dtype == 0)
    return stats ? mid_dx<float, true>(FPSG_ARGS)
                 : mid_dx<float, false>(FPSG_ARGS);
  if (dtype == 1)
    return stats ? mid_dx<__nv_bfloat16, true>(FPSG_ARGS)
                 : mid_dx<__nv_bfloat16, false>(FPSG_ARGS);
#undef FPSG_ARGS
  return (int)cudaErrorInvalidValue;
}

int fpsg_fused_mid_dw(int dtype, int stats, const void* yp, const void* k,
                      const void* b, const void* sh, const void* y,
                      const void* gy, const void* gzs, const void* gzq,
                      void* dw, int G, int R, int Din, int Dout,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FPSG_ARGS yp, k, b, sh, y, gy, gzs, gzq, dw, G, R, Din, Dout, s
  if (dtype == 0)
    return stats ? mid_dw<float, true>(FPSG_ARGS)
                 : mid_dw<float, false>(FPSG_ARGS);
  if (dtype == 1)
    return stats ? mid_dw<__nv_bfloat16, true>(FPSG_ARGS)
                 : mid_dw<__nv_bfloat16, false>(FPSG_ARGS);
#undef FPSG_ARGS
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

int fpsg_fused_out_bwd(int dtype, const void* yp, const void* k,
                       const void* b, const void* w, const void* y,
                       const void* gy, void* dyp, void* part, void* dkdb,
                       void* dw, void* dbias, int G, int R, int Din, int Dout,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FPSG_ARGS yp, k, b, w, y, gy, dyp, part, dkdb, dw, dbias, G, R, Din, \
                  Dout, s
  if (dtype == 0) return out_bwd<float>(FPSG_ARGS);
  if (dtype == 1) return out_bwd<__nv_bfloat16>(FPSG_ARGS);
#undef FPSG_ARGS
  return (int)cudaErrorInvalidValue;
}

int fpsg_fused_l1_bwd(int dtype, int stats, const void* d, const void* wd,
                      const void* yc, const void* sc, const void* y,
                      const void* gy, const void* gzs, const void* gzq,
                      const void* gzc, void* dd, void* dwd, void* dyc,
                      void* dsc, void* part, int G, int R, int P, int Din,
                      int Dout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FPSG_ARGS d, wd, yc, sc, y, gy, gzs, gzq, gzc, dd, dwd, dyc, dsc, \
                  part, G, R, P, Din, Dout, s
  if (dtype == 0)
    return stats ? l1_bwd<float, true>(FPSG_ARGS)
                 : l1_bwd<float, false>(FPSG_ARGS);
  if (dtype == 1)
    return stats ? l1_bwd<__nv_bfloat16, true>(FPSG_ARGS)
                 : l1_bwd<__nv_bfloat16, false>(FPSG_ARGS);
#undef FPSG_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* fpsg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
