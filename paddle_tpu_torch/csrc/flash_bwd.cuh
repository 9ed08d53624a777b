// The flash-attention backward of K2 (flash_attention_bwd.cu) and K3b
// (flash_flat_bwd.cu): a di pre-kernel body shared by both dtypes, and a
// dk/dv and a dq body per dtype, which each kernel's __global__ functions
// inline with their own arguments. f32 takes the SIMT bodies `dkv_body`
// and `dq_body`, bf16 the tensor-core bodies `sm90::dkv_body_tc` and
// `sm90::dq_body_tc`.
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
// packed [b, s, 3, h, d] gradient). Accumulation is f32. The f32 bodies
// round nothing; the bf16 bodies round P before dV and dS before dQ and dK,
// as the reference does (flash_attention.py:192,225,228,
// flash_attention_flat.py:207,210), and each result once, at the store. The
// bias gets no gradient.
//
// Split. The TPU kernels keep a head's whole K/V (dq) or Q/dO/stats
// (dk/dv) in VMEM, or accumulate dq across sequential grid steps; a Hopper
// block cannot, and blocks run in no order. So, deterministic with no
// atomics, for both dtypes (FlashAttention-3's deterministic layout):
// - `di_body`: di [b, h, s] f32, one warp per row (the reference computes it
//   in jnp outside its Pallas calls). Memory-bound and small: SIMT for both.
// - dk/dv: one block per (b, h, k tile), K and V resident, looping over q
//   tiles (from the diagonal when causal), accumulating dK and dV.
// - dq: one block per (b, h, q tile), Q and dO resident, looping over K/V
//   tiles up to the diagonal, accumulating dQ.
// The split recomputes S and dP in both kernels: 7 matmuls where the bound
// counts 5 (chip_smoke.py attention_bound), the price of determinism
// without atomics.
//
// f32 design (SIMT). 256 threads per block and 64-row tiles; thread
// (ty, tx) owns score rows ty*4..ty*4+3 and keys tx, tx+16, tx+32, tx+48 of
// a tile, and accumulator rows ty*4..ty*4+3 at columns c*64 + tx*4 + 0..3.
// Shared memory: four 64 x (d+4) f32 tiles plus one (dq) or two (dk/dv)
// 64 x 68 score tiles and, with a bias, one 64 x 68 bias tile: at most
// 187,392 bytes (dk/dv, d = 128, bias), opted in above 48 KB. True f32.
//
// bf16 design (Hopper tensor cores, flash_sm90.cuh). Three warpgroups per
// block, 128 resident rows (two consumer warpgroups of 64) against 64-row
// streamed tiles, as the forward (flash_fwd.cuh): warpgroup 0 (setmaxnreg
// 24) streams by TMA into a 2-stage mbarrier ring, warpgroups 1 and 2
// (setmaxnreg 240) run wgmma.
// - dk/dv works in the transposed space, so P^T and dS^T come out of
//   wgmma as accumulator fragments whose bf16 rounding is the register A
//   operand of the next product: S^T = K Q^T and dP^T = V dO^T (shared
//   memory operands, K-major), then dV += P^T dO and dK += dS^T Q (Q and dO
//   read MN-major from the same panels). Warp 0 copies the streamed rows'
//   m, log l and di into the stage beside Q and dO.
// - dq: S = Q K^T and dP = dO V^T, then dQ += dS K (K MN-major).
// Registers: at d = 64 a consumer holds dK and dV (32 f32 each), S^T and
// dP^T (32 each) and their bf16 halves, within the 240 that setmaxnreg
// gives it. At d = 128 the two accumulators double; the tiles stay 64
// keys per warpgroup, and ptxas spills a little in the biased instances
// (their ptxas lines in chip_smoke.py's build phase); d = 64 spills none. The bias is
// staged through shared memory into the score fragments, as in the
// forward (flash_sm90.cuh).
#pragma once

#include <math.h>

#include "flash_common.cuh"
#include "flash_sm90.cuh"

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

namespace sm90 {

// Shared memory of the bf16 dk/dv body: two resident 64 x D K tiles and two
// V tiles, kStages Q and dO tiles, kStages 1 KiB blocks of row statistics
// (m, log l, di of the 64 streamed rows), 64 bytes of barriers, with a bias
// its staging buffers, and 1024 bytes of alignment slack.
template <int D, bool kBias>
constexpr int dkv_smem_bytes() {
  return (4 + 2 * kStages) * tile_bytes<D>() + kStages * 1024 + 64 + bias_smem_bytes<kBias>() +
         1024;
}

// Shared memory of the bf16 dq body: two resident Q and two dO tiles,
// kStages K and V tiles, the barriers, the bias buffers and the slack.
template <int D, bool kBias>
constexpr int dq_smem_bytes() {
  return (4 + 2 * kStages) * tile_bytes<D>() + 64 + bias_smem_bytes<kBias>() + 1024;
}

// The bf16 dk/dv body of K2 (no bias) and K3b (kBias). Block (b, h, 128-key
// tile), warpgroups 1 and 2 each own 64 keys, whose K and V tiles stay in
// shared memory. Warp 0 streams 64-row Q and dO tiles by TMA (from the
// diagonal when causal) and copies the rows' m, log l and di beside them.
// Computed in the transposed space, so that P^T and dS^T come out of wgmma
// as accumulator fragments whose bf16 rounding is the register A operand of
// the next product:
//   S^T = K Q^T, P^T = exp(S^T scale (+ bias^T) - m - log l),
//   dV += P^T dO,  dP^T = V dO^T,  dS^T = P^T o (dP^T - di),  dK += dS^T Q.
// Q and dO are read K-major for S^T and dP^T and MN-major for dK and dV.
template <typename BT, int D, bool kBias, typename E = __nv_bfloat16>
__device__ __forceinline__ void dkv_body_tc(const CUtensorMap* tq, const CUtensorMap* tk,
                                            const CUtensorMap* tv, const CUtensorMap* tdo,
                                            const BT* __restrict__ bias, BiasStrides bst,
                                            const float* __restrict__ m,
                                            const float* __restrict__ logl,
                                            const float* __restrict__ di,
                                            E* __restrict__ dk,
                                            E* __restrict__ dv, Strides dks,
                                            Strides dvs, int s, int h, int causal, float scale) {
  constexpr int kTile = tile_bytes<D>();
  uint8_t* base = smem_base();
  const uint32_t Ks = smem_u32(base);
  const uint32_t Vs = Ks + 2 * kTile;
  const uint32_t Qs = Vs + 2 * kTile;
  const uint32_t dOs = Qs + kStages * kTile;
  float* stats = reinterpret_cast<float*>(base + (4 + 2 * kStages) * kTile);  // [kStages][256]
  const uint32_t bar_kv = smem_u32(stats + kStages * 256);
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  float* bias_bufs = reinterpret_cast<float*>(base + (4 + 2 * kStages) * kTile + kStages * 1024 + 64);

  const int kb = blockIdx.x;  // causal: k tile 0 sees every q tile, so low tiles go first
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int k0 = kb * 128;
  const long long head = (long long)bi * h + hi;
  const int n_q = (s + 63) / 64;
  const int qt_first = causal ? k0 / 64 : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar_full + 8 * i, 32);  // warp 0's lanes: the statistics, and the TMA bytes
      mbar_init(bar_empty + 8 * i, kConsumers * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_tx(bar_kv, 4 * kTile);
        tma_load_tile<D>(Ks, tk, bar_kv, hi, k0, bi);
        tma_load_tile<D>(Ks + kTile, tk, bar_kv, hi, k0 + 64, bi);
        tma_load_tile<D>(Vs, tv, bar_kv, hi, k0, bi);
        tma_load_tile<D>(Vs + kTile, tv, bar_kv, hi, k0 + 64, bi);
      }
      for (int t = 0; qt_first + t < n_q; ++t) {
        const int st = t % kStages;
        const int q0 = (qt_first + t) * 64;
        mbar_wait(bar_empty + 8 * st, ((t / kStages) & 1) ^ 1);
        float* sm = stats + st * 256;
        for (int i = lane; i < 64; i += 32) {  // rows past s are masked by the consumers
          const int row = q0 + i;
          const bool live = row < s;
          sm[i] = live ? m[head * s + row] : 0.f;
          sm[64 + i] = live && logl != nullptr ? logl[head * s + row] : 0.f;
          sm[128 + i] = live ? di[head * s + row] : 0.f;
        }
        if (lane == 0) {  // after its own statistics: arriving publishes them
          mbar_arrive_tx(bar_full + 8 * st, 2 * kTile);
          tma_load_tile<D>(Qs + st * kTile, tq, bar_full + 8 * st, hi, q0, bi);
          tma_load_tile<D>(dOs + st * kTile, tdo, bar_full + 8 * st, hi, q0, bi);
        } else {
          mbar_arrive(bar_full + 8 * st);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int kw0 = k0 + 64 * w;
    const int key_lo = kw0 + 16 * (tid / 32) + lane / 4;  // fragment rows (keys) key_lo, key_lo + 8
    const int c_off = 2 * (lane % 4);
    const uint32_t k_tile = Ks + w * kTile;
    const uint32_t v_tile = Vs + w * kTile;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    // a wholly masked tile (causal: q rows all above the keys) is skipped;
    // the bias of the next live tile is read while this one's products run
    const int t_live = causal ? kw0 / 64 - qt_first : 0;
    uint32_t bv[kBias ? bias_words<BT>() : 1];
    const bool vec = kBias && bias_vector_ok(bias, bst);
    if constexpr (kBias) bias_load(bv, bias, bst, bi, (qt_first + t_live) * 64, kw0, s, vec);
    mbar_wait(bar_kv, 0);
    for (int t = 0; qt_first + t < n_q; ++t) {
      const int st = t % kStages;
      const int q0 = (qt_first + t) * 64;
      mbar_wait(bar_full + 8 * st, (t / kStages) & 1);
      if (t >= t_live) {
        float* buf = bias_bufs + (2 * w + t % 2) * kBiasBuf;
        if constexpr (kBias) {
          bias_store<68, BT>(buf, bv);
          warpgroup_sync(w);
        }
        const uint32_t q_tile = Qs + st * kTile;
        const uint32_t do_tile = dOs + st * kTile;
        float sT[32], dpT[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sT[i] = dpT[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64<E>(sT, desc_k(k_tile, kk), desc_k(q_tile, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64<E>(dpT, desc_k(v_tile, kk), desc_k(do_tile, kk), kk > 0);
        wgmma_commit();
        if constexpr (kBias) {
          if (qt_first + t + 1 < n_q) bias_load(bv, bias, bst, bi, q0 + 64, kw0, s, vec);
        }
        wgmma_wait();
        fence_regs(sT);
        fence_regs(dpT);
        float bt[kBias ? 32 : 1];
        if constexpr (kBias) bias_frag<true>(bt, buf);

        const float* sm = stats + st * 256;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = key_lo + 8 * ((i / 2) % 2);
          const int col = 8 * (i / 4) + c_off + i % 2;
          const int row = q0 + col;
          const bool visible = row < s && key < s && (!causal || key <= row);
          float x = sT[i] * scale;
          if constexpr (kBias) x += bt[i];
          const float p = visible ? exp2f(((x - sm[col]) - sm[64 + col]) * kLog2e) : 0.f;
          sT[i] = p;
          dpT[i] = p * (dpT[i] - sm[128 + col]);
        }
        // P^T and dS^T rounded to bf16, as the reference rounds P before dV
        // and dS before dK
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          a_frag<E, 32>(pa[kk], sT, kk);
          a_frag<E, 32>(da[kk], dpT, kk);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<E, D>(dv_acc, pa[kk], desc_mn(do_tile, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<E, D>(dk_acc, da[kk], desc_mn(q_tile, kk));
        wgmma_commit();
        wgmma_wait();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      }
      mbar_arrive(bar_empty + 8 * st);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = key_lo + 8 * hh;
      if (key >= s) continue;
      E* gk = dk + bi * dks.b + key * dks.s + hi * dks.h + c_off;
      E* gv = dv + bi * dvs.b + key * dvs.s + hi * dvs.h + c_off;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        store_pair(gk + 8 * j, dk_acc[4 * j + 2 * hh] * scale, dk_acc[4 * j + 2 * hh + 1] * scale);
        store_pair(gv + 8 * j, dv_acc[4 * j + 2 * hh], dv_acc[4 * j + 2 * hh + 1]);
      }
    }
  }
}

// The bf16 dq body of K2 and K3b. Block (b, h, 128-row q tile), heaviest
// causal tiles first; warpgroups 1 and 2 each own 64 query rows, whose Q and
// dO tiles stay in shared memory, and read their rows' m, log l and di once.
// Warp 0 streams 64-key K and V tiles by TMA up to the diagonal:
//   S = Q K^T, P = exp(S scale (+ bias) - m - log l), dP = dO V^T,
//   dS = P o (dP - di), dQ += dS K  (K read MN-major, dS as the A operand).
template <typename BT, int D, bool kBias, typename E = __nv_bfloat16>
__device__ __forceinline__ void dq_body_tc(const CUtensorMap* tq, const CUtensorMap* tk,
                                           const CUtensorMap* tv, const CUtensorMap* tdo,
                                           const BT* __restrict__ bias, BiasStrides bst,
                                           const float* __restrict__ m,
                                           const float* __restrict__ logl,
                                           const float* __restrict__ di,
                                           E* __restrict__ dq, Strides dqs, int s,
                                           int h, int causal, float scale) {
  constexpr int kTile = tile_bytes<D>();
  uint8_t* base = smem_base();
  const uint32_t Qs = smem_u32(base);
  const uint32_t dOs = Qs + 2 * kTile;
  const uint32_t Ks = dOs + 2 * kTile;
  const uint32_t Vs = Ks + kStages * kTile;
  const uint32_t bar_q = Vs + kStages * kTile;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  float* bias_bufs = reinterpret_cast<float*>(base + (4 + 2 * kStages) * kTile + 64);

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int q0 = qb * 128;
  const long long head = (long long)bi * h + hi;
  const int n_tiles = (s + 63) / 64;
  const int n_live = causal ? min(n_tiles, (q0 + 127) / 64 + 1) : n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, kConsumers * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(bar_q, 4 * kTile);
      tma_load_tile<D>(Qs, tq, bar_q, hi, q0, bi);
      tma_load_tile<D>(Qs + kTile, tq, bar_q, hi, q0 + 64, bi);
      tma_load_tile<D>(dOs, tdo, bar_q, hi, q0, bi);
      tma_load_tile<D>(dOs + kTile, tdo, bar_q, hi, q0 + 64, bi);
      for (int t = 0; t < n_live; ++t) {
        const int st = t % kStages;
        mbar_wait(bar_empty + 8 * st, ((t / kStages) & 1) ^ 1);
        mbar_arrive_tx(bar_full + 8 * st, 2 * kTile);
        tma_load_tile<D>(Ks + st * kTile, tk, bar_full + 8 * st, hi, t * 64, bi);
        tma_load_tile<D>(Vs + st * kTile, tv, bar_full + 8 * st, hi, t * 64, bi);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r_lo = q0 + 64 * w + 16 * (tid / 32) + lane / 4;  // fragment rows r_lo, r_lo + 8
    const int c_off = 2 * (lane % 4);
    const int w_last = causal ? min(n_tiles - 1, (q0 + 64 * w + 63) / 64) : n_tiles - 1;
    const uint32_t q_tile = Qs + w * kTile;
    const uint32_t do_tile = dOs + w * kTile;

    float m_r[2], logl_r[2], di_r[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // rows past s are masked below
      const int row = r_lo + 8 * hh;
      m_r[hh] = row < s ? m[head * s + row] : 0.f;
      logl_r[hh] = row < s && logl != nullptr ? logl[head * s + row] : 0.f;
      di_r[hh] = row < s ? di[head * s + row] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    // the bias of the next tile, read while this one's products run
    uint32_t bv[kBias ? bias_words<BT>() : 1];
    const bool vec = kBias && bias_vector_ok(bias, bst);
    if constexpr (kBias) bias_load(bv, bias, bst, bi, q0 + 64 * w, 0, s, vec);
    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_live; ++t) {
      const int st = t % kStages;
      mbar_wait(bar_full + 8 * st, (t / kStages) & 1);
      if (t <= w_last) {
        const int k0 = t * 64;
        float* buf = bias_bufs + (2 * w + t % 2) * kBiasBuf;
        if constexpr (kBias) {
          bias_store<72, BT>(buf, bv);
          warpgroup_sync(w);
        }
        const uint32_t k_tile = Ks + st * kTile;
        const uint32_t v_tile = Vs + st * kTile;
        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64<E>(sc, desc_k(q_tile, kk), desc_k(k_tile, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64<E>(dp, desc_k(do_tile, kk), desc_k(v_tile, kk), kk > 0);
        wgmma_commit();
        if constexpr (kBias) {
          if (t < w_last) bias_load(bv, bias, bst, bi, q0 + 64 * w, k0 + 64, s, vec);
        }
        wgmma_wait();
        fence_regs(sc);
        fence_regs(dp);
        float bt[kBias ? 32 : 1];
        if constexpr (kBias) bias_frag<false>(bt, buf);

#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hh = (i / 2) % 2;
          const int row = r_lo + 8 * hh;
          const int key = k0 + 8 * (i / 4) + c_off + i % 2;
          const bool visible = row < s && key < s && (!causal || key <= row);
          float x = sc[i] * scale;
          if constexpr (kBias) x += bt[i];
          const float p = visible ? exp2f(((x - m_r[hh]) - logl_r[hh]) * kLog2e) : 0.f;
          sc[i] = p * (dp[i] - di_r[hh]);
        }
        uint32_t da[4][4];  // dS rounded to bf16, as the reference rounds it before dQ
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) a_frag<E, 32>(da[kk], sc, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<E, D>(acc, da[kk], desc_mn(k_tile, kk));
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc);
      }
      mbar_arrive(bar_empty + 8 * st);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r_lo + 8 * hh;
      if (row >= s) continue;
      E* g = dq + bi * dqs.b + row * dqs.s + hi * dqs.h + c_off;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store_pair(g + 8 * j, acc[4 * j + 2 * hh] * scale, acc[4 * j + 2 * hh + 1] * scale);
    }
  }
}

}  // namespace sm90

}  // namespace flash
