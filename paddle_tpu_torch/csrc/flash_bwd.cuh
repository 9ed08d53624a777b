// The flash-attention backward of K2 (flash_attention_bwd.cu) and K3b
// (flash_flat_bwd.cu): three bodies, which each kernel's __global__
// functions inline with their own arguments.
//
// FlashAttention-2 style from the forward's row statistics: with
// X = Q K^T * scale + bias, P = exp(X - m - log l) (causal and ragged pairs
// masked to 0), di = rowsum(dO o O),
//   dV = P^T dO,   dS = P o (dO V^T - di),   dQ = dS K * scale,   dK = dS^T Q * scale.
// K2 passes its lse as `m` and no `logl` (log l = 0) and no bias; K3b passes
// m and log l apart (flash_fwd.cuh says why) and an optional f32 or bf16
// bias [b|1, 1, s, s] through its strides. q, k, v, out, dout [b, s, h, d]
// (any strides, unit stride on d) in f32 or bf16; dq, dk, dv in the input
// dtype through the caller's strides (so the three can be slices of one
// packed [b, s, 3, h, d] gradient). All arithmetic is f32; a bf16 result is
// rounded once, at the store. The bias gets no gradient.
//
// Design. The TPU kernels keep a head's whole K/V (dq) or Q/dO/stats
// (dk/dv) in VMEM, or accumulate dq across sequential grid steps; a Hopper
// block cannot, and blocks run in no order. So, deterministic with no
// atomics:
// - `di_body`: di [b, h, s] f32, one warp per row (the reference computes it
//   in jnp outside its Pallas calls).
// - `dkv_body`: one block of 256 threads per (b, h, 64-row k tile). K and V
//   tiles stay in shared memory; the block loops over 64-row q tiles (from
//   the diagonal when causal) with Q, dO and the bias tile staged,
//   recomputes X, P, dP and dS for the 64 x 64 tile, and accumulates dK and
//   dV in f32 registers.
// - `dq_body`: one block per (b, h, 64-row q tile); Q, dO stay in shared
//   memory, the block loops over K/V (and bias) tiles up to the diagonal
//   and accumulates dQ in registers.
// Thread (ty, tx) owns score rows ty*4..ty*4+3 and keys tx, tx+16, tx+32,
// tx+48 of a tile, and accumulator rows ty*4..ty*4+3 at columns
// c*64 + tx*4 + 0..3. Rows and keys past a ragged s are masked here.
// Shared memory: four 64 x (d+4) f32 tiles plus one (dq) or two (dk/dv)
// 64 x 68 score tiles and, with a bias, one 64 x 68 bias tile: at most
// 187,392 bytes (dk/dv, d = 128, bias), under the card's 232,448, opted in
// above 48 KB.
#pragma once

#include <math.h>

#include "flash_common.cuh"

namespace flash {

// di[b, h, s] = sum_d dO * O in f32, one warp per (b, s, h) row.
template <typename T, int D>
__device__ __forceinline__ void di_body(const T* __restrict__ out, const T* __restrict__ dout,
                                        float* __restrict__ di, int b, int s, int h, Strides os,
                                        Strides gs) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool live = row < (long long)b * s * h;
  const int hi = live ? (int)(row % h) : 0;
  const int si = live ? (int)((row / h) % s) : 0;
  const int bi = live ? (int)(row / ((long long)h * s)) : 0;
  float acc = 0.f;
  if (live) {
    const T* o = out + bi * os.b + si * os.s + hi * os.h;
    const T* g = dout + bi * gs.b + si * gs.s + hi * gs.h;
    for (int c = lane; c < D; c += 32) acc = fmaf(to_float(o[c]), to_float(g[c]), acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (live && lane == 0) di[((long long)bi * h + hi) * s + si] = acc;
}

// acc[i][j] = sum_d A[ty*4 + i][d] * B[tx + 16*j][d] over two [64][D + 4]
// tiles in shared memory.
template <int D>
__device__ __forceinline__ void tile_nt(float (&acc)[4][4], const float* A, const float* B,
                                        int ty, int tx) {
  constexpr int kPitch = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * kPitch + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * kPitch + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = acc[i][j];
        a = fmaf(av[i].x, bv[j].x, a);
        a = fmaf(av[i].y, bv[j].y, a);
        a = fmaf(av[i].z, bv[j].z, a);
        a = fmaf(av[i].w, bv[j].w, a);
        acc[i][j] = a;
      }
  }
}

// From the raw scores `sc` (Q K^T) and dP = dO V^T of the thread's 4 x 4
// entries (q rows q0 + ty*4 + i, keys k0 + tx + 16*j), the bias tile `Bs`
// (null without a bias) and the rows' statistics: P = exp(X - m - log l),
// masked to 0 outside the visible (row, key) pairs, and dS = P (dP - di).
// Both are written to [64][kSPitch] tiles in shared memory (P only if Ps).
__device__ __forceinline__ void probs_and_dscores(const float (&sc)[4][4], const float (&dp)[4][4],
                                                  const float* Bs, const float (&m)[4],
                                                  const float (&logl)[4], const float (&di)[4],
                                                  float* Ps, float* dSs, int q0, int k0, int s,
                                                  int causal, float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool visible = row < s && key < s && (!causal || key <= row);
      const int at = (ty * 4 + i) * kSPitch + tx + 16 * j;
      float x = sc[i][j] * scale;
      if (Bs != nullptr) x += Bs[at];
      const float p = visible ? expf((x - m[i]) - logl[i]) : 0.f;
      if (Ps != nullptr) Ps[at] = p;
      dSs[at] = p * (dp[i][j] - di[i]);
    }
  }
}

// m, log l and di of the thread's four q rows (0 past s: those rows are
// masked); log l is 0 without `logl` (K2's lse passed as m).
__device__ __forceinline__ void row_stats(float (&m_r)[4], float (&logl_r)[4], float (&di_r)[4],
                                          const float* __restrict__ m,
                                          const float* __restrict__ logl,
                                          const float* __restrict__ di, long long head, int q0,
                                          int s, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    m_r[i] = row < s ? m[head * s + row] : 0.f;
    logl_r[i] = row < s && logl != nullptr ? logl[head * s + row] : 0.f;
    di_r[i] = row < s ? di[head * s + row] : 0.f;
  }
}

template <int D>
constexpr int dkv_smem_bytes(bool bias) {
  return (4 * kTile * (D + 4) + (bias ? 3 : 2) * kTile * kSPitch) * (int)sizeof(float);
}

template <int D>
constexpr int dq_smem_bytes(bool bias) {
  return (4 * kTile * (D + 4) + (bias ? 2 : 1) * kTile * kSPitch) * (int)sizeof(float);
}

// kBias: the instance reads `bias`; without it the bias code compiles out
// (K2, and K3b's no-bias calls).
template <typename T, typename BT, int D, bool kBias>
__device__ __forceinline__ void dkv_body(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ dout,
                                         const BT* __restrict__ bias,
                                         const float* __restrict__ m,
                                         const float* __restrict__ logl,
                                         const float* __restrict__ di, T* __restrict__ dk,
                                         T* __restrict__ dv, int s, int h, Strides qs, Strides ks,
                                         Strides vs, Strides gs, BiasStrides bst, Strides dks,
                                         Strides dvs, int causal, float scale) {
  constexpr int kPitch = D + 4;
  constexpr int kColGroups = D / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * kPitch;
  float* Qs = Vs + kTile * kPitch;
  float* dOs = Qs + kTile * kPitch;
  float* Ps = dOs + kTile * kPitch;
  float* dSs = Ps + kTile * kSPitch;
  float* Bs = kBias ? dSs + kTile * kSPitch : nullptr;

  const int kt = blockIdx.x;  // causal: k tile 0 sees every q tile, so low tiles go first
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k0 = kt * kTile;
  const long long head = (long long)bi * h + hi;

  load_tile<T, D>(Ks, k, ks, bi, hi, k0, s);
  load_tile<T, D>(Vs, v, vs, bi, hi, k0, s);

  float dk_acc[4][kColGroups][4], dv_acc[4][kColGroups][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kColGroups; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[i][c][e] = dv_acc[i][c][e] = 0.f;

  const int n_tiles = (s + kTile - 1) / kTile;
  for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's Qs, dOs, Ps, dSs and Bs are no longer read
    load_tile<T, D>(Qs, q, qs, bi, hi, q0, s);
    load_tile<T, D>(dOs, dout, gs, bi, hi, q0, s);
    if (kBias) load_bias_tile<BT>(Bs, bias, bst, bi, q0, k0, s);
    float m_r[4], logl_r[4], di_r[4];
    row_stats(m_r, logl_r, di_r, m, logl, di, head, q0, s, ty);
    __syncthreads();

    float sc[4][4], dp[4][4];
    tile_nt<D>(sc, Qs, Ks, ty, tx);   // S[q][key]
    tile_nt<D>(dp, dOs, Vs, ty, tx);  // dP[q][key]
    probs_and_dscores(sc, dp, Bs, m_r, logl_r, di_r, Ps, dSs, q0, k0, s, causal, scale, ty, tx);
    __syncthreads();  // Ps and dSs complete

    // dV[key] += sum_q P[q][key] dO[q];  dK[key] += sum_q dS[q][key] Q[q]
#pragma unroll 2
    for (int qq = 0; qq < kTile; ++qq) {
      const float4 p4 = *reinterpret_cast<const float4*>(Ps + qq * kSPitch + ty * 4);
      const float4 d4 = *reinterpret_cast<const float4*>(dSs + qq * kSPitch + ty * 4);
#pragma unroll
      for (int c = 0; c < kColGroups; ++c) {
        const float4 g = *reinterpret_cast<const float4*>(dOs + qq * kPitch + c * 64 + tx * 4);
        const float4 x = *reinterpret_cast<const float4*>(Qs + qq * kPitch + c * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = comp(p4, i);
          const float ds = comp(d4, i);
          dv_acc[i][c][0] = fmaf(p, g.x, dv_acc[i][c][0]);
          dv_acc[i][c][1] = fmaf(p, g.y, dv_acc[i][c][1]);
          dv_acc[i][c][2] = fmaf(p, g.z, dv_acc[i][c][2]);
          dv_acc[i][c][3] = fmaf(p, g.w, dv_acc[i][c][3]);
          dk_acc[i][c][0] = fmaf(ds, x.x, dk_acc[i][c][0]);
          dk_acc[i][c][1] = fmaf(ds, x.y, dk_acc[i][c][1]);
          dk_acc[i][c][2] = fmaf(ds, x.z, dk_acc[i][c][2]);
          dk_acc[i][c][3] = fmaf(ds, x.w, dk_acc[i][c][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= s) continue;
    T* gk = dk + bi * dks.b + row * dks.s + hi * dks.h;
    T* gv = dv + bi * dvs.b + row * dvs.s + hi * dvs.h;
#pragma unroll
    for (int c = 0; c < kColGroups; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gk[c * 64 + tx * 4 + e] = from_float<T>(dk_acc[i][c][e] * scale);
        gv[c * 64 + tx * 4 + e] = from_float<T>(dv_acc[i][c][e]);
      }
  }
}

template <typename T, typename BT, int D, bool kBias>
__device__ __forceinline__ void dq_body(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, const T* __restrict__ dout,
                                        const BT* __restrict__ bias, const float* __restrict__ m,
                                        const float* __restrict__ logl,
                                        const float* __restrict__ di, T* __restrict__ dq, int s,
                                        int h, Strides qs, Strides ks, Strides vs, Strides gs,
                                        BiasStrides bst, Strides dqs, int causal, float scale) {
  constexpr int kPitch = D + 4;
  constexpr int kColGroups = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kTile * kPitch;
  float* Ks = dOs + kTile * kPitch;
  float* Vs = Ks + kTile * kPitch;
  float* dSs = Vs + kTile * kPitch;
  float* Bs = kBias ? dSs + kTile * kSPitch : nullptr;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = qt * kTile;
  const long long head = (long long)bi * h + hi;

  load_tile<T, D>(Qs, q, qs, bi, hi, q0, s);
  load_tile<T, D>(dOs, dout, gs, bi, hi, q0, s);
  float m_r[4], logl_r[4], di_r[4];
  row_stats(m_r, logl_r, di_r, m, logl, di, head, q0, s, ty);

  float acc[4][kColGroups][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kColGroups; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;

  const int n_tiles = (s + kTile - 1) / kTile;
  const int n_live = causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < n_live; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's Ks, Vs, dSs and Bs are no longer read
    load_tile<T, D>(Ks, k, ks, bi, hi, k0, s);
    load_tile<T, D>(Vs, v, vs, bi, hi, k0, s);
    if (kBias) load_bias_tile<BT>(Bs, bias, bst, bi, q0, k0, s);
    __syncthreads();

    float sc[4][4], dp[4][4];
    tile_nt<D>(sc, Qs, Ks, ty, tx);
    tile_nt<D>(dp, dOs, Vs, ty, tx);
    probs_and_dscores(sc, dp, Bs, m_r, logl_r, di_r, nullptr, dSs, q0, k0, s, causal, scale, ty,
                      tx);
    __syncthreads();  // dSs complete

    // dQ[q] += sum_key dS[q][key] K[key]
#pragma unroll 2
    for (int kk = 0; kk < kTile; kk += 4) {
      float4 d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d4[i] = *reinterpret_cast<const float4*>(dSs + (ty * 4 + i) * kSPitch + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int c = 0; c < kColGroups; ++c) {
          const float4 kv = *reinterpret_cast<const float4*>(Ks + (kk + t) * kPitch + c * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ds = comp(d4[i], t);
            acc[i][c][0] = fmaf(ds, kv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(ds, kv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(ds, kv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(ds, kv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s) continue;
    T* g = dq + bi * dqs.b + row * dqs.s + hi * dqs.h;
#pragma unroll
    for (int c = 0; c < kColGroups; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) g[c * 64 + tx * 4 + e] = from_float<T>(acc[i][c][e] * scale);
  }
}

}  // namespace flash
