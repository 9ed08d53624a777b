// The flash-attention forward of K1 (flash_attention_fwd.cu) and K3
// (flash_flat_fwd.cu): one body, which each kernel's __global__ function
// inlines with its own arguments.
//
// q, k, v [b, s, h, d] (any strides, unit stride on d), scale 1/sqrt(d), an
// optional additive f32 or bf16 bias [b|1, 1, s, s] read through its own
// strides (K3; K1 passes none and the compiler drops the bias code), an
// optional causal mask; K/V streamed through an online softmax with f32
// running max, sum and accumulator; out [b, s, h, d] in the input dtype.
// Row statistics, f32 [b, h, s]: with `logl` null one array `m` receives
// lse = m + log l (K1); else `m` gets the running max and `logl` log l (K3).
// Kept apart, they let the backward recompute p = exp(x - m - log l) exactly
// on a row whose every key is masked by a bias of -1e30, where m + log l
// would round to m.
//
// Design. One block of 256 threads owns one (b, h, 64-row q tile); it keeps
// the q tile in shared memory and loops over 64-row K/V tiles (and their
// 64 x 64 bias tiles) staged in shared memory, all in f32. Tiles entirely
// above the diagonal are never loaded (causal), rows and keys past a ragged
// s are masked here, and the heaviest causal q tiles are launched first.
// Thread (ty, tx) owns score rows ty*4..ty*4+3 and keys tx, tx+16, tx+32,
// tx+48, so a row's max and sum are a shuffle over 16 lanes; shared rows are
// padded by 4 floats so the float4 reads of a quarter warp hit distinct
// banks.
//
// Masking. Causal and ragged keys get -inf and p = 0. A bias entry is added
// to the f32 score, so a key masked by -1e30 stays finite: m starts at -inf
// and the rescale exp(m - m_new) runs in f32, so a fully biased tile gives
// p = 1 until a live tile rescales it by exp(-1e30) = 0, and a row whose
// every key is biased averages V uniformly, as the plain composite does.
#pragma once

#include <math.h>

#include "flash_common.cuh"

namespace flash {

template <int D>
constexpr int fwd_smem_bytes(bool bias) {
  return (3 * kTile * (D + 4) + (bias ? 2 : 1) * kTile * kSPitch) * (int)sizeof(float);
}

template <typename T, typename BT, int D>
__device__ __forceinline__ void fwd_body(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const BT* __restrict__ bias,
                                         T* __restrict__ out, float* __restrict__ m_out,
                                         float* __restrict__ logl_out, int s, int h, Strides qs,
                                         Strides ks, Strides vs, BiasStrides bst, Strides os,
                                         int causal, float scale) {
  constexpr int kPitch = D + 4;
  constexpr int kColGroups = D / 64;  // output columns c*64 + tx*4 + 0..3
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * kPitch;
  float* Vs = Ks + kTile * kPitch;
  float* Ps = Vs + kTile * kPitch;
  float* Bs = Ps + kTile * kSPitch;  // only with a bias

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = qt * kTile;

  load_tile<T, D>(Qs, q, qs, bi, hi, q0, s);

  float m[4], l[4], acc[4][kColGroups][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kColGroups; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  const int n_tiles = (s + kTile - 1) / kTile;
  const int n_live = causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < n_live; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's Ks, Vs, Ps and Bs are no longer read
    load_tile<T, D>(Ks, k, ks, bi, hi, k0, s);
    load_tile<T, D>(Vs, v, vs, bi, hi, k0, s);
    if (bias != nullptr) load_bias_tile<BT>(Bs, bias, bst, bi, q0, k0, s);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * kPitch + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * kPitch + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool visible = key < s && (!causal || key <= row);
        float x = sc[i][j] * scale;
        if (bias != nullptr) x += Bs[(ty * 4 + i) * kSPitch + tx + 16 * j];
        sc[i][j] = visible ? x : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // every row sees key 0 in tile 0, so m_new is finite from then on;
      // the guards keep a fully masked row at p = 0 instead of NaN
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_new);
        Ps[(ty * 4 + i) * kSPitch + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kColGroups; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();  // Ps complete

#pragma unroll 2
    for (int kk = 0; kk < kTile; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kSPitch + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int c = 0; c < kColGroups; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(Vs + (kk + t) * kPitch + c * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = comp(pv[i], t);
            acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s) continue;
    const float inv = 1.f / l[i];
    T* o = out + bi * os.b + row * os.s + hi * os.h;
#pragma unroll
    for (int c = 0; c < kColGroups; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c * 64 + tx * 4 + e] = from_float<T>(acc[i][c][e] * inv);
    if (tx == 0) {
      const long long at = ((long long)bi * h + hi) * s + row;
      if (logl_out == nullptr) {
        m_out[at] = m[i] + logf(l[i]);
      } else {
        m_out[at] = m[i];
        logl_out[at] = logf(l[i]);
      }
    }
  }
}

}  // namespace flash
