// The grouped GEMM shared by the MoE expert-FFN kernels K4
// (moe_grouped_ffn_fwd.cu) and K4b (moe_grouped_ffn_bwd.cu).
//
// One launch computes, for every expert e at once (grid.z = e),
//
//     C_e[m, n] = sum_k  xa(A_e[m, k]) * xb(B_e[k, n])        (f32 accumulation)
//
// and hands the sum to an epilogue. A and B are read as stored, with no
// transposed copy: A row-major [M, K] or, with `kAT`, [K, M]; B row-major
// [K, N] or, with `kBT`, [N, K]. The rows of the MoE dispatch layout are
// grouped by expert (expert e owns rows e*cap .. e*cap+cap-1), so a block
// finds its expert's rows and weights from blockIdx.z and strides alone.
// The load transforms xa, xb put the reference's bf16 rounding points into
// the operand loads: kRound rounds an f32 operand to the storage type T
// (dh before the dx and dw1 products), kActRound applies the activation to
// the f32 pre-activation s and rounds (h before the second product and dw2).
//
// Tiling: a block of 256 threads owns a 128 x 128 tile of C and walks K in
// steps of 16. Each step's A and B tiles are read from device memory into
// registers while the previous step computes from shared memory (two
// buffers, one barrier a step); operands are widened to f32 and transformed
// on their way into shared memory, so bf16 and f32 share one compute loop. Thread (ty, tx) of the 16 x 16 grid
// owns rows {ty*4 + i, 64 + ty*4 + i} and columns {tx*4 + j, 64 + tx*4 + j}
// (i, j < 4) of the tile: 64 f32 accumulators, read from shared memory as
// float4s. Every edge is masked (rows past an expert's capacity, ragged D,
// H), so no dimension must be a multiple of the tile. The weight-gradient
// epilogue (kWgrad) reduces over the expert's rows inside the block (K is
// the row axis), with no atomics: the result is deterministic. Blocks of
// the first row tile also sum the raw B operand per column on the way in,
// which is the bias gradient (db1 from dh, db2 from dy).
//
// This is the simple first version: f32 FMA on the CUDA cores. Tensor cores
// (mma.sync / wgmma), TMA and a hidden tile kept on chip are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace moe {

constexpr int kBM = 128;  // rows of a C tile
constexpr int kBN = 128;  // columns of a C tile
constexpr int kBK = 16;   // depth of one k step
constexpr int kThreads = 256;
constexpr int kPitch = kBM + 4;  // shared rows padded by 4 floats (kBM == kBN)

enum Act : int { kGelu = 0, kRelu = 1, kSilu = 2 };
enum Xform : int { kRaw = 0, kRound = 1, kActRound = 2 };
// kBiasF32: f32 C + bias (s of the forward). kBiasOut: T(C + bias) (y).
// kDactF32: act'(s) * C in f32 (dh). kOut: T(C) (dx). kWgrad: T(C) per
// expert, plus the column sums of B into `dbias` (dw1 + db1, dw2 + db2).
enum Epi : int { kBiasF32 = 0, kBiasOut = 1, kDactF32 = 2, kOut = 3, kWgrad = 4 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the storage type T and widened back (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// The activations of MoELayer. GELU is the tanh form, as jax.nn.gelu's
// default and the dense FFN's gelu(approximate=True).
__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == kGelu) {
    const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanhf(u));
  }
  if (act == kRelu) return fmaxf(x, 0.f);
  return x / (1.f + expf(-x));
}

// d act / dx. relu' is 0 at x = 0, as jax.nn.relu's.
__device__ __forceinline__ float act_grad(float x, int act) {
  if (act == kGelu) {
    const float x2 = x * x;
    const float t = tanhf(0.7978845608028654f * (x + 0.044715f * x2 * x));
    return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * 0.7978845608028654f * (1.f + 0.134145f * x2);
  }
  if (act == kRelu) return x > 0.f ? 1.f : 0.f;
  const float sg = 1.f / (1.f + expf(-x));
  return sg * (1.f + x * (1.f - sg));
}

template <typename T, int X>
__device__ __forceinline__ float xform(float v, int act) {
  if (X == kRound) return round_to<T>(v);
  if (X == kActRound) return round_to<T>(act_fn(v, act));
  return v;
}

// Element (r, c) of expert e's matrix is p[e * expert + r * ld + c].
struct Mat {
  const void* p;
  long long expert, ld;
};

struct GemmArgs {
  Mat a, b;                    // the operands as stored
  void* c;                     // C_e[m, n] at c[e * c_expert + m * ldc + n]
  long long c_expert, ldc;
  const void* aux;             // kBias*: bias[e * N + n] (T); kDactF32: s, laid out as C (f32)
  void* dbias;                 // kWgrad: the column sums of B, [E, N] (T)
  int M, N, K, act;
};

// The block's tile of the grouped product; see the top of this file.
template <typename T, typename TA, bool kAT, int kAX, typename TB, bool kBT, int kBX, int kEpi>
__device__ __forceinline__ void gemm_tile(const GemmArgs& g) {
  static_assert(!(kEpi == kWgrad && kBT), "the column sums need B stored [K, N]");
  __shared__ __align__(16) float As[2][kBK][kPitch];  // As[k][m]
  __shared__ __align__(16) float Bs[2][kBK][kPitch];  // Bs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const TA* A = static_cast<const TA*>(g.a.p) + e * g.a.expert;
  const TB* B = static_cast<const TB*>(g.b.p) + e * g.b.expert;
  const bool colsum = kEpi == kWgrad && blockIdx.y == 0;
  float csum = 0.f;  // this thread's share of column n0 + (tid & 127) of B
  float ra[8], rb[8];

  // Element i of this thread's share of a tile: 8 of the 2048 per operand.
  // Along a stored row the neighbouring threads read neighbouring addresses.
  auto a_at = [&](int i, int& m, int& k) {
    if (kAT) { k = (tid >> 7) + 2 * i; m = tid & 127; }
    else { m = (tid >> 4) + 16 * i; k = tid & 15; }
  };
  auto b_at = [&](int i, int& k, int& n) {
    if (kBT) { n = (tid >> 4) + 16 * i; k = tid & 15; }
    else { k = (tid >> 7) + 2 * i; n = tid & 127; }
  };
  // load() only issues the reads; the transforms wait for store(), after
  // the step's products, so the reads' latency hides behind them. A masked
  // element is 0, which every transform keeps at 0.
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int m, k;
      a_at(i, m, k);
      const int gm = m0 + m, gk = k0 + k;
      ra[i] = gm < g.M && gk < g.K ? to_float(kAT ? A[gk * g.a.ld + gm] : A[gm * g.a.ld + gk])
                                   : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int k, n;
      b_at(i, k, n);
      const int gk = k0 + k, gn = n0 + n;
      rb[i] = gk < g.K && gn < g.N ? to_float(kBT ? B[gn * g.b.ld + gk] : B[gk * g.b.ld + gn])
                                   : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int m, k, n;
      a_at(i, m, k);
      As[buf][k][m] = xform<T, kAX>(ra[i], g.act);
      b_at(i, k, n);
      if (colsum) csum += rb[i];  // the bias gradient sums the unrounded operand
      Bs[buf][k][n] = xform<T, kBX>(rb[i], g.act);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (g.K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) load((t + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read in step t - 1, before the barrier
    if (t + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gn >= g.N) continue;
      const long long off = e * g.c_expert + gm * g.ldc + gn;
      const float v = acc[i][j];
      if (kEpi == kBiasF32) {
        static_cast<float*>(g.c)[off] = v + to_float(static_cast<const T*>(g.aux)[(long long)e * g.N + gn]);
      } else if (kEpi == kBiasOut) {
        static_cast<T*>(g.c)[off] =
            from_float<T>(v + to_float(static_cast<const T*>(g.aux)[(long long)e * g.N + gn]));
      } else if (kEpi == kDactF32) {
        static_cast<float*>(g.c)[off] = act_grad(static_cast<const float*>(g.aux)[off], g.act) * v;
      } else {
        static_cast<T*>(g.c)[off] = from_float<T>(v);
      }
    }
  }

  if (colsum) {  // uniform over the block: every thread reaches the barriers
    float* red = &As[0][0][0];  // free: the loop ended on a barrier
    red[tid] = csum;
    __syncthreads();
    if (tid < 128 && n0 + tid < g.N)
      static_cast<T*>(g.dbias)[(long long)e * g.N + n0 + tid] = from_float<T>(red[tid] + red[tid + 128]);
  }
}

}  // namespace moe
