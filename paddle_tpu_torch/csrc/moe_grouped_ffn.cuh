// The grouped GEMM bodies shared by the MoE expert-FFN kernels K4
// (moe_grouped_ffn_fwd.cu) and K4b (moe_grouped_ffn_bwd.cu).
//
// One launch computes, for every expert e at once (grid.z = e),
//
//     C_e[m, n] = sum_k A_e[m, k] * B_e[k, n]        (f32 accumulation)
//
// and hands each sum to an epilogue. A and B are read as stored, with no
// transposed copy: A K-major ([M, K], K contiguous) or MN-major ([K, M]); B
// K-major ([N, K]) or MN-major ([K, N]). The rows of the MoE dispatch layout
// are grouped by expert (expert e owns rows e*cap .. e*cap+cap-1), so a
// block finds its expert's rows and weights from blockIdx.z alone.
//
// Live rows. `rows[e]` (a device array, or null for "all cap") is the number
// of rows of expert e that hold a token; the rest hold the zero token and
// get a zero output gradient. The products over rows skip them:
//   - a row-tiled product (s, y, dh, dx: M is the expert's rows) computes a
//     128-row tile only if it holds a live row. The forward's two products
//     also compute the tile of row rows[e] itself: its h and y rows are the
//     zero token's, which the fill kernel copies to the later padding rows.
//     A skipped tile writes only what its rows must hold (s = b1, dx = 0);
//   - a weight-gradient product (dw1, dw2: K is the expert's rows) runs its
//     reduction to rows[e], not cap.
// The epilogues write the reference's values on padding rows whatever the
// inputs hold there: s = f32(b1), h = T(act(b1)), dh = 0, dx = 0. The
// weight-gradient products multiply the padding rows of xg and dy in their
// last box by zeros, so those rows must hold finite values.
//
// Two bodies, one per dtype:
//   - bf16 (tc::): 128 x 128 tiles of C on wgmma tensor cores. A producer
//     warp issues TMA loads of 64 x 64 128-byte-swizzled panels (two of A,
//     two of B per 64-deep k step) into a 4-stage mbarrier ring; two
//     consumer warpgroups of 64 rows each issue m64n128k16 wgmmas on them,
//     reading every operand as stored (K-major or MN-major descriptors;
//     bf16 allows both for A and B), and keep one wgmma group in flight.
//     The row operands are 3-D tensor maps [E, cap, width], so a box past
//     an expert's last row reads zeros, never the next expert's rows.
//   - f32 (simt::): true f32 FMA on the CUDA cores (the f32 gates rule out
//     TF32). A 256-thread block owns a 128 x 128 tile, 8 x 8 accumulators a
//     thread, two blocks to an SM (at most 128 registers a thread); 32-deep
//     k steps of A and B arrive by 16-byte cp.async, coalesced along the
//     stored rows, into a 3-stage ring, with no transform on the way. A
//     K-major operand stays [mn][k] in shared memory and is read 4 k at a
//     time as float4s; every other fragment is used as it is read.
// No transform sits on a load path: the activation is applied once, in the
// epilogue that holds the f32 pre-activation (s -> h in the forward, s -> h
// and dh in the backward), which writes the operand copy the next product
// reads. The bias gradients are column sums taken by a separate
// deterministic kernel (colsum below), never by atomics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace moe {

constexpr int kTile = 128;  // rows and columns of a C tile, both bodies

enum Act : int { kGelu = 0, kRelu = 1, kSilu = 2 };
// What a tile of C becomes.
// kS:  s = C + b1 (f32) and h = T(act(s)); padding rows: s = b1.
// kY:  y = T(C + b2).
// kDh: dh = act'(s) C (f32), its bf16 copy T(dh) (bf16 only), h = T(act(s));
//      padding rows: all 0.
// kDx: dx = T(C); padding rows: 0.
// kDw: dw = T(C), the reduction running over the expert's live rows.
enum Epi : int { kS = 0, kY = 1, kDh = 2, kDx = 3, kDw = 4 };

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

// An operand as stored: element (r, c) of expert e's matrix at
// p[e * expert + r * ld + c] (the SIMT body's view; the tc body reads the
// same operands through tensor maps).
struct Mat {
  const void* p;
  long long expert, ld;
};

struct Args {
  Mat a, b;
  void* c;                  // C_e[m, n] at c[e * c_expert + m * ldc + n]: s, y, dh (f32), dx, dw
  long long c_expert, ldc;
  void* h;                  // kS, kDh: h = T(act(s)), laid out as C
  void* dh_t;               // kDh, bf16: T(dh), laid out as C
  const void* aux;          // kS: b1, kY: b2 ([E, N], T); kDh: s (f32, laid out as C)
  const int* rows;          // [E] live rows of each expert, or null: all cap
  int M, N, K, cap, act;
  int vec;                  // SIMT: every operand row and base allows 16-byte copies
};

__device__ __forceinline__ int live_rows(const Args& g, int e) {
  return g.rows == nullptr ? g.cap : min(max(g.rows[e], 0), g.cap);
}

// Whether a row-tiled product computes the 128-row tile at m0 (see the top).
template <int kEpi>
__device__ __forceinline__ bool tile_computed(int m0, int live, int cap) {
  if (kEpi == kS || kEpi == kY) return m0 < cap && m0 <= live;
  return m0 < live;
}

template <typename T, int kV>
__device__ __forceinline__ void store(void* p, long long off, const float (&v)[kV]) {
  T* q = static_cast<T*>(p) + off;
  if constexpr (kV == 2 && std::is_same_v<T, float>) {
    *reinterpret_cast<float2*>(q) = make_float2(v[0], v[1]);
  } else if constexpr (kV == 2) {
    *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i) q[i] = from_float<T>(v[i]);
  }
}

// The epilogue of kV consecutive columns col.. of row `row` (both inside C)
// of expert e, whose first `live` rows hold tokens. kV = 2 needs even
// columns and widths (the bf16 instances: N % 8 == 0).
template <typename T, int kEpi, int kV>
__device__ __forceinline__ void epilogue(const Args& g, int e, int live, int row, int col,
                                         const float (&acc)[kV]) {
  const long long off = e * g.c_expert + (long long)row * g.ldc + col;
  const bool on = row < live;
  float v[kV];
  if constexpr (kEpi == kS || kEpi == kY) {
    const T* bias = static_cast<const T*>(g.aux) + (long long)e * g.N + col;
#pragma unroll
    for (int i = 0; i < kV; ++i) v[i] = (kEpi == kY || on ? acc[i] : 0.f) + to_float(bias[i]);
    if constexpr (kEpi == kS) {
      store<float, kV>(g.c, off, v);
      float h[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) h[i] = act_fn(v[i], g.act);
      store<T, kV>(g.h, off, h);
    } else {
      store<T, kV>(g.c, off, v);
    }
  } else if constexpr (kEpi == kDh) {
    float h[kV];
    if (on) {
      float s[kV];
      const float* sp = static_cast<const float*>(g.aux) + off;
      if constexpr (kV == 2) {
        const float2 t = *reinterpret_cast<const float2*>(sp);
        s[0] = t.x;
        s[1] = t.y;
      } else {
#pragma unroll
        for (int i = 0; i < kV; ++i) s[i] = sp[i];
      }
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        v[i] = act_grad(s[i], g.act) * acc[i];
        h[i] = act_fn(s[i], g.act);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i) v[i] = h[i] = 0.f;
    }
    store<float, kV>(g.c, off, v);
    store<T, kV>(g.h, off, h);
    if constexpr (!std::is_same_v<T, float>) store<T, kV>(g.dh_t, off, v);
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i) v[i] = kEpi == kDw || on ? acc[i] : 0.f;
    store<T, kV>(g.c, off, v);
  }
}

// What a row-tiled product writes for a tile it skips: s = b1 (kS) or
// dx = 0 (kDx). kY's skipped rows are filled by fill_rows after the launch;
// kDh's are read by nothing. Neighbouring threads write neighbouring columns.
template <typename T, int kEpi>
__device__ __forceinline__ void skipped_tile(const Args& g, int e, int m0, int n0) {
  if constexpr (kEpi == kS || kEpi == kDx) {
    for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
      const int row = m0 + i / kTile, col = n0 + i % kTile;
      if (row >= g.M || col >= g.N) continue;
      const long long off = e * g.c_expert + (long long)row * g.ldc + col;
      if constexpr (kEpi == kS) {
        static_cast<float*>(g.c)[off] = to_float(static_cast<const T*>(g.aux)[(long long)e * g.N + col]);
      } else {
        static_cast<T*>(g.c)[off] = from_float<T>(0.f);
      }
    }
  }
}

// ---- f32: SIMT FMA fed by a cp.async ring --------------------------------------

namespace simt {

constexpr int kThreads = 256;
constexpr int kDepth = 32;  // k per stage
constexpr int kStages = 3;
constexpr int kPad = 4;     // floats of padding per shared row (keeps rows 16-byte aligned)

// A stage's tile of one operand in shared memory: [128][kDepth + 4] when K is
// its stored inner dim, else [kDepth][128 + 4].
template <bool kKInner>
__host__ __device__ constexpr int tile_floats() {
  return kKInner ? kTile * (kDepth + kPad) : kDepth * (kTile + kPad);
}

template <bool kAK, bool kBK>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * (tile_floats<kAK>() + tile_floats<kBK>()) * 4;
}

// One stage's tile of an operand stored [outer][inner] (pitch ld) from
// outer o0.. and inner i0.. into `dst`; elements at or past (o_lim, i_lim)
// are zero. Consecutive threads copy consecutive 16-byte chunks of a row
// (4-byte elements where `vec` is off: a row or base not 16-byte aligned).
template <bool kKInner>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ld, int o0, int i0,
                                          int o_lim, int i_lim, bool vec) {
  constexpr int kO = kKInner ? kTile : kDepth;
  constexpr int kI = kKInner ? kDepth : kTile;
  constexpr int kP = kI + kPad;
  if (vec) {
#pragma unroll
    for (int n = threadIdx.x; n < kO * kI / 4; n += kThreads) {
      const int o = n / (kI / 4), i = 4 * (n % (kI / 4));
      const bool ok = o0 + o < o_lim && i0 + i < i_lim;
      hopper::cp_async16(hopper::smem_u32(dst + o * kP + i),
                         ok ? src + (long long)(o0 + o) * ld + i0 + i : src, ok);
    }
  } else {
#pragma unroll 4
    for (int n = threadIdx.x; n < kO * kI; n += kThreads) {
      const int o = n / kI, i = n % kI;
      const bool ok = o0 + o < o_lim && i0 + i < i_lim;
      hopper::cp_async4(hopper::smem_u32(dst + o * kP + i),
                        ok ? src + (long long)(o0 + o) * ld + i0 + i : src, ok);
    }
  }
}

// Row i (< 8) of thread ty's accumulators within the tile.
__device__ __forceinline__ int row_of(int ty, int i) { return i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4; }
// Column j (< 8) of thread tx's: blocks of 4 when B is MN-major (float4
// reads along n), every 16th when B is K-major (float4 reads along k, and
// rows 16 apart are free of bank conflicts at the padded pitch).
template <bool kBK>
__device__ __forceinline__ int col_of(int tx, int j) {
  return kBK ? tx + 16 * j : (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
}

// x[0..3] = p[0..3], x[4..7] = p[64..67]: a thread's 8 rows or columns of
// one k, two float4s from shared memory.
__device__ __forceinline__ void load8(float (&x)[8], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 64);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// The block's tile of the grouped product (see the top of this file).
template <int kEpi, bool kAK, bool kBK>
__device__ __forceinline__ void gemm(const Args& g) {
  static_assert(kAK || !kBK, "an MN-major A is paired with an MN-major B (the weight gradients)");
  constexpr bool kWgrad = kEpi == kDw;
  const int e = blockIdx.z, m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int live = live_rows(g, e);
  if (!kWgrad && !tile_computed<kEpi>(m0, live, g.cap)) {
    skipped_tile<float, kEpi>(g, e, m0, n0);
    return;
  }
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = tile_floats<kAK>() + tile_floats<kBK>();
  const float* A = static_cast<const float*>(g.a.p) + e * g.a.expert;
  const float* B = static_cast<const float*>(g.b.p) + e * g.b.expert;
  // the reduction's extent, and the rows of A a row-tiled product reads
  // (kY reads h's rows past `live`: they hold the zero token's h)
  const int k_lim = kWgrad ? live : g.K;
  const int a_rows = kEpi == kY ? g.cap : live;
  const bool vec = g.vec != 0;
  const int nk = (k_lim + kDepth - 1) / kDepth;

  auto load = [&](int t) {
    float* As = smem + (t % kStages) * kStage;
    float* Bs = As + tile_floats<kAK>();
    const int k0 = t * kDepth;
    if (kAK) load_tile<true>(As, A, g.a.ld, m0, k0, a_rows, k_lim, vec);      // [m][k]
    else load_tile<false>(As, A, g.a.ld, k0, m0, k_lim, g.M, vec);            // [k][m]
    if (kBK) load_tile<true>(Bs, B, g.b.ld, n0, k0, g.N, k_lim, vec);         // [n][k]
    else load_tile<false>(Bs, B, g.b.ld, k0, n0, k_lim, g.N, vec);            // [k][n]
  };

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nk) load(t);
    hopper::cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    hopper::cp_async_wait<kStages - 2>();  // stage t has landed (this thread's copies)
    __syncthreads();                       // everyone's copies; stage t - 1 is free again
    if (t + kStages - 1 < nk) load(t + kStages - 1);
    hopper::cp_async_commit();
    const float* As = smem + (t % kStages) * kStage;
    const float* Bs = As + tile_floats<kAK>();
#pragma unroll
    for (int kq = 0; kq < kDepth; kq += 4) {
      // Four k of the stage. A K-major A is read as one float4 along k per
      // row; every other fragment is used as soon as it is read, so a
      // thread holds at most 32 operand values beside its 64 sums.
      float a4[4][8];  // kAK: a4[t][i] = A[row i][kq + t]
      if constexpr (kAK) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(As + row_of(ty, i) * (kDepth + kPad) + kq);
          a4[0][i] = v.x; a4[1][i] = v.y; a4[2][i] = v.z; a4[3][i] = v.w;
        }
      }
      if constexpr (kBK) {  // Bs[n][k]: one float4 along k per column
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(Bs + col_of<true>(tx, j) * (kDepth + kPad) + kq);
          const float b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int t4 = 0; t4 < 4; ++t4)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a4[t4][i], b[t4], acc[i][j]);
        }
      } else {  // Bs[k][n]: two float4s along n per k (and As[k][m] likewise)
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4) {
          float a[8], b[8];
          load8(b, Bs + (kq + t4) * (kTile + kPad) + tx * 4);
          if constexpr (kAK) {
#pragma unroll
            for (int i = 0; i < 8; ++i) a[i] = a4[t4][i];
          } else {
            load8(a, As + (kq + t4) * (kTile + kPad) + ty * 4);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + row_of(ty, i);
    if (row >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + col_of<kBK>(tx, j);
      if (col >= g.N) continue;
      const float v[1] = {acc[i][j]};
      epilogue<float, kEpi, 1>(g, e, live, row, col, v);
    }
  }
}

}  // namespace simt

// ---- bf16: wgmma tensor cores fed by TMA ------------------------------------------

namespace tc {

constexpr int kConsumers = 2;                     // consumer warpgroups, 64 rows of C each
constexpr int kThreads = 128 * (kConsumers + 1);  // warpgroup 0 produces (one thread issues TMA)
constexpr int kStages = 4;                        // depth of the TMA ring
constexpr int kDepth = 64;                        // k per stage: one panel wide
constexpr int kStageBytes = 4 * hopper::kPanel;   // A: two 64 x 64 panels, B: two
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr int kProducerRegs = 24;                 // setmaxnreg: 24 x 128 + 240 x 256 <= 65,536
constexpr int kConsumerRegs = 240;

// D[64 x 128] += A[64 x 16] B[16 x 128], both from shared memory; A K-major
// or MN-major (kAK false: transposed), B likewise.
template <bool kAK, bool kBK>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kAK ? 0 : 1), "n"(kBK ? 0 : 1));
}

// The block's tile of the grouped product (see the top of this file). `ta`
// and `tb` are 3-D tensor maps of A and B over (stored columns, stored rows,
// expert). A stage holds k0 .. k0 + 63 of the reduction: panel p of A is
// rows (K-major) or columns (MN-major) m0 + 64 p .., consumer warpgroup p's
// 64 rows of C; B's two panels cover n0 .. n0 + 127 the same way.
template <int kEpi, bool kAK, bool kBK>
__device__ __forceinline__ void gemm(const CUtensorMap* ta, const CUtensorMap* tb, const Args& g) {
  using namespace hopper;
  constexpr bool kWgrad = kEpi == kDw;
  const int e = blockIdx.z, m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int live = live_rows(g, e);
  if (!kWgrad && !tile_computed<kEpi>(m0, live, g.cap)) {
    skipped_tile<__nv_bfloat16, kEpi>(g, e, m0, n0);
    return;
  }
  // Row-tiled products run the whole K, zero-filled past it by TMA; the
  // weight gradients run over the live rows. Their last box may reach past
  // rows[e] into padding rows of the same 128-row tile, which the dh
  // epilogue zeroed in the operand paired with them (T(dh), h), so any
  // finite value in the other operand adds 0.
  const int nk = ((kWgrad ? live : g.K) + kDepth - 1) / kDepth;
  uint8_t* base = smem_base();
  const uint32_t ring = smem_u32(base);
  const uint32_t bar_full = ring + kStages * kStageBytes;  // kStages barriers
  const uint32_t bar_empty = bar_full + 8 * kStages;       // kStages barriers

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, kConsumers * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every copy
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int t = 0; t < nk; ++t) {
        const int st = t % kStages;
        const uint32_t a = ring + st * kStageBytes, b = a + 2 * kPanel;
        const int k0 = t * kDepth;
        mbar_wait(bar_empty + 8 * st, ((t / kStages) & 1) ^ 1);
        mbar_arrive_tx(bar_full + 8 * st, kStageBytes);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if (kAK) tma_load_3d(a + p * kPanel, ta, bar_full + 8 * st, k0, m0 + 64 * p, e);
          else tma_load_3d(a + p * kPanel, ta, bar_full + 8 * st, m0 + 64 * p, k0, e);
          if (kBK) tma_load_3d(b + p * kPanel, tb, bar_full + 8 * st, k0, n0 + 64 * p, e);
          else tma_load_3d(b + p * kPanel, tb, bar_full + 8 * st, n0 + 64 * p, k0, e);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int t = 0; t < nk; ++t) {
      const int st = t % kStages;
      const uint32_t a = ring + st * kStageBytes + w * kPanel, b = ring + st * kStageBytes + 2 * kPanel;
      mbar_wait(bar_full + 8 * st, (t / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk)
        wgmma_n128<kAK, kBK>(acc, kAK ? desc_k(a, kk) : desc_mn(a, kk),
                             kBK ? desc_k(b, kk) : desc_mn(b, kk));
      wgmma_commit();
      wgmma_wait_n<1>();  // step t - 1's products are done: free its stage
      if (t > 0) mbar_arrive(bar_empty + 8 * ((t - 1) % kStages));
    }
    wgmma_wait();
    fence_regs(acc);

    // accumulator element 4j + 2hh + c: row 16 (tid / 32) + lane / 4 + 8 hh,
    // column 8 j + 2 (lane % 4) + c of the warpgroup's 64 x 128 block
    const int r_lo = m0 + 64 * w + 16 * (tid / 32) + lane / 4;
    const int c_lo = n0 + 2 * (lane % 4);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r_lo + 8 * hh;
      if (row >= g.M) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = c_lo + 8 * j;
        if (col >= g.N) continue;
        const float v[2] = {acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]};
        epilogue<__nv_bfloat16, kEpi, 2>(g, e, live, row, col, v);
      }
    }
  }
}

}  // namespace tc

// ---- the small passes ----------------------------------------------------------

// K4's last pass: the padding rows of expert e past the tiles its products
// computed take the zero token's y, row rows[e] (computed by the y product).
template <typename T>
__device__ __forceinline__ void fill_rows(T* y, const int* rows, int cap, int D) {
  const int e = blockIdx.y;
  const int live = min(max(rows[e], 0), cap);
  if (live >= cap) return;
  const int first = min(cap, (live / kTile + 1) * kTile);
  const T* src = y + ((long long)e * cap + live) * D;
  T* dst = y + ((long long)e * cap + first) * D;
  const long long n = (long long)(cap - first) * D;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = src[i % D];
}

// K4b's bias gradients: db1[e, n] = sum of dh[e, r, n] (f32) and db2[e, n] =
// sum of dy[e, r, n] over the expert's live rows r, the sums in f32 and cast
// to T. A block of 256 threads owns 32 columns of one expert: 8 lanes of
// rows, then the 8 partial sums added in a fixed order, so the result is
// the same from run to run (no atomics). Blocks x < ceil(H / 32) take db1.
template <typename T>
__device__ __forceinline__ void colsum(const float* dh, const T* dy, const int* rows, T* db1, T* db2,
                                       int cap, int D, int H) {
  __shared__ float part[8][32];
  const int e = blockIdx.y;
  const int live = rows == nullptr ? cap : min(max(rows[e], 0), cap);
  const int nb1 = (H + 31) / 32;
  const bool first = (int)blockIdx.x < nb1;
  const int W = first ? H : D;
  const int c = threadIdx.x % 32, lane_r = threadIdx.x / 32;
  const int col = (first ? (int)blockIdx.x : (int)blockIdx.x - nb1) * 32 + c;
  float sum = 0.f;
  if (col < W) {
    if (first) {
      const float* p = dh + (long long)e * cap * H + col;
      for (int r = lane_r; r < live; r += 8) sum += p[(long long)r * H];
    } else {
      const T* p = dy + (long long)e * cap * D + col;
      for (int r = lane_r; r < live; r += 8) sum += to_float(p[(long long)r * D]);
    }
  }
  part[lane_r][c] = sum;
  __syncthreads();
  if (threadIdx.x < 32 && col < W) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) total += part[i][c];
    (first ? db1 : db2)[(long long)e * W + col] = from_float<T>(total);
  }
}

// ---- host ---------------------------------------------------------------------

using SimtKernel = void (*)(Args);
using TcKernel = void (*)(CUtensorMap, CUtensorMap, Args);

// Launches one grouped product over E experts on `stream`: the SIMT kernel
// for f32, the tc kernel for bf16, whose tensor maps are made here from the
// operands' Mat views (a contiguous [E, expert / ld, ld] each). The grid is
// (N tiles, M tiles, E) whatever rows[e] holds: the kernels read it.
template <typename T, bool kAK, bool kBK>
cudaError_t launch(const Args& g, int E, cudaStream_t stream, SimtKernel simt_kernel,
                   TcKernel tc_kernel) {
  const dim3 grid((g.N + kTile - 1) / kTile, (g.M + kTile - 1) / kTile, E);
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {
    constexpr int bytes = simt::smem_bytes<kAK, kBK>();
    err = cudaFuncSetAttribute(simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    simt_kernel<<<grid, simt::kThreads, bytes, stream>>>(g);
  } else {
    err = cudaFuncSetAttribute(tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tc::kSmemBytes);
    if (err != cudaSuccess) return err;
    CUtensorMap ta, tb;
    if ((err = hopper::make_map_3d(&ta, g.a.p, (int)g.a.ld, (int)(g.a.expert / g.a.ld), E)) !=
            cudaSuccess ||
        (err = hopper::make_map_3d(&tb, g.b.p, (int)g.b.ld, (int)(g.b.expert / g.b.ld), E)) !=
            cudaSuccess)
      return err;
    tc_kernel<<<grid, tc::kThreads, tc::kSmemBytes, stream>>>(ta, tb, g);
  }
  return cudaGetLastError();
}

}  // namespace moe
