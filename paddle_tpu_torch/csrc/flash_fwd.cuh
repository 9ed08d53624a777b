// The flash-attention forward of K1 (flash_attention_fwd.cu) and K3
// (flash_flat_fwd.cu): two bodies, one per input dtype, which each kernel's
// __global__ functions inline with their own arguments. f32 takes the SIMT
// body `fwd_body`, bf16 the tensor-core body `sm90::fwd_body_tc`.
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
// would round to m. The bf16 body rounds P to bf16 before P V, as the
// reference does (flash_attention.py:114, flash_attention_flat.py:155);
// the f32 body has nothing to round.
//
// Bound. 4 d flops per visible query-key pair against q, k, v and out
// moved once. At the O2 step's call, [8, 1024, 16, 64] bf16 causal, the
// card needs 0.0202 ms for the bytes and 0.0174 ms for the flops
// (chip_smoke.py attention_bound): about balanced, so what bounds a kernel
// in practice is feeding the tensor cores and the exponentials between the
// two products of every tile.
//
// f32 design (SIMT). One block of 256 threads owns one (b, h, 64-row q
// tile); it keeps the q tile in shared memory and loops over 64-row K/V
// tiles (and their 64 x 64 bias tiles) staged in shared memory, all in
// f32. Tiles entirely above the diagonal are never loaded (causal), rows
// and keys past a ragged s are masked here, and the heaviest causal q tiles
// are launched first. Thread (ty, tx) owns score rows ty*4..ty*4+3 and keys
// tx, tx+16, tx+32, tx+48, so a row's max and sum are a shuffle over 16
// lanes; shared rows are padded by 4 floats so the float4 reads of a
// quarter warp hit distinct banks. True f32 math, as the f32 gates need
// (TF32 tensor cores would not meet them).
//
// bf16 design (Hopper tensor cores, flash_sm90.cuh). One block of three
// warpgroups owns one (b, h, 128-row q tile). Warpgroup 0 gives up its
// registers (setmaxnreg 24) and one of its threads issues every copy: the
// two 64-row Q tiles once, then 64-key K and V tiles into a 2-stage ring,
// by TMA from tensor maps over the operands' own strides (so packed-qkv
// views need no copy), 128-byte swizzled, rows past s zero-filled, each
// stage's arrival counted on an mbarrier. Warpgroups 1 and 2 (setmaxnreg
// 240) own 64 query rows each: S = Q K^T by wgmma m64n64k16 with both
// operands in shared memory, the online softmax on the f32 accumulator
// fragment (a row lives in a quad of threads: its max and sum are two
// shuffles; exp2 of (x - m) log2 e), then P in bf16 registers as the A
// operand of O += P V, V read MN-major from the same panels. A consumer
// skips a K/V tile wholly above its rows' diagonal but still frees its
// stage. The bias is read by the consumers themselves, coalesced, the next
// tile's while this tile's scores are computed, and staged through shared
// memory into the score fragment (flash_sm90.cuh; TMA would need 16-byte
// aligned bias rows, and K3 takes any s).
//
// Masking. Causal and ragged keys get -inf and p = 0. A bias entry is added
// to the f32 score, so a key masked by -1e30 stays finite: m starts at -inf
// and the rescale exp(m - m_new) runs in f32, so a fully biased tile gives
// p = 1 until a live tile rescales it by exp(-1e30) = 0, and a row whose
// every key is biased averages V uniformly, as the plain composite does.
// Both bodies do this.
#pragma once

#include <math.h>

#include "flash_common.cuh"
#include "flash_sm90.cuh"

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

namespace sm90 {

// Shared memory of the bf16 forward: two resident 64 x D Q tiles, kStages
// K and V tiles, 64 bytes of barriers, with a bias its staging buffers,
// and the 1024 bytes of alignment slack.
template <int D, bool kBias>
constexpr int fwd_smem_bytes() {
  return (2 + 2 * kStages) * tile_bytes<D>() + 64 + bias_smem_bytes<kBias>() + 1024;
}

// The bf16 forward of K1 (no bias) and K3 (kBias: an f32 or bf16 bias).
// Block (b, h, 128-row q tile), heaviest causal tiles first; warpgroup 0's
// first thread loads the block's two 64-row Q tiles once and streams 64-key
// K/V tiles through a kStages-deep TMA ring; warpgroups 1 and 2 each own 64
// query rows: S = Q K^T by wgmma from shared memory, the online softmax on
// the accumulator fragment, P rounded to bf16 in registers as the A operand
// of O += P V (V read MN-major from the same panels). A consumer skips a K/V
// tile that lies wholly above its rows' diagonal, but still frees it.
template <typename BT, int D, bool kBias>
__device__ __forceinline__ void fwd_body_tc(const CUtensorMap* tq, const CUtensorMap* tk,
                                            const CUtensorMap* tv, const BT* __restrict__ bias,
                                            BiasStrides bst, __nv_bfloat16* __restrict__ out,
                                            Strides os, float* __restrict__ m_out,
                                            float* __restrict__ logl_out, int s, int h,
                                            int causal, float scale) {
  constexpr int kTile = tile_bytes<D>();
  uint8_t* base = smem_base();
  const uint32_t Qs = smem_u32(base);
  const uint32_t Ks = Qs + 2 * kTile;
  const uint32_t Vs = Ks + kStages * kTile;
  const uint32_t bar_q = Vs + kStages * kTile;
  const uint32_t bar_full = bar_q + 8;                // kStages barriers
  const uint32_t bar_empty = bar_full + 8 * kStages;  // kStages barriers
  float* bias_bufs = reinterpret_cast<float*>(base + (2 + 2 * kStages) * kTile + 64);

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int q0 = qb * 128;
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

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every copy
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(bar_q, 2 * kTile);
      tma_load_tile<D>(Qs, tq, bar_q, hi, q0, bi);
      tma_load_tile<D>(Qs + kTile, tq, bar_q, hi, q0 + 64, bi);
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

    float o[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    // the bias of the next tile, read while this tile's scores are computed
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
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        const uint32_t k_tile = Ks + st * kTile;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(sc, desc_k(q_tile, kk), desc_k(k_tile, kk), kk > 0);
        wgmma_commit();
        if constexpr (kBias) {
          if (t < w_last) bias_load(bv, bias, bst, bi, q0 + 64 * w, k0 + 64, s, vec);
        }
        wgmma_wait();
        fence_regs(sc);
        float bt[kBias ? 32 : 1];
        if constexpr (kBias) bias_frag<false>(bt, buf);

        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hh = (i / 2) % 2;
          const int row = r_lo + 8 * hh;
          const int key = k0 + 8 * (i / 4) + c_off + i % 2;
          float x = sc[i] * scale;
          if constexpr (kBias) x += bt[i];
          sc[i] = key < s && (!causal || key <= row) ? x : -INFINITY;
          mx[hh] = fmaxf(mx[hh], sc[i]);
        }
        float alpha[2], m_new[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          m_new[hh] = fmaxf(m[hh], quad_max(mx[hh]));
          // every row sees key 0 in tile 0, so m_new is finite from then on;
          // the guards keep a fully masked row at p = 0 instead of NaN
          alpha[hh] = m[hh] == -INFINITY ? 0.f : exp2f((m[hh] - m_new[hh]) * kLog2e);
          m[hh] = m_new[hh];
          l[hh] *= alpha[hh];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hh = (i / 2) % 2;
          const float p = sc[i] == -INFINITY ? 0.f : exp2f((sc[i] - m_new[hh]) * kLog2e);
          sc[i] = p;
          l[hh] += p;  // this thread's part of the row sum; the quad's is summed at the end
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

        const uint32_t v_tile = Vs + st * kTile;
        uint32_t pa[4][4];  // P rounded to bf16, as the reference rounds it before P V
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) a_frag<32>(pa[kk], sc, kk);
        wgmma_fence();  // after the writes of o and pa that the products read
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<D>(o, pa[kk], desc_mn(v_tile, kk));
        wgmma_commit();
        wgmma_wait();
        fence_regs(o);
      }
      mbar_arrive(bar_empty + 8 * st);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r_lo + 8 * hh;
      const float lsum = quad_sum(l[hh]);
      if (row >= s) continue;
      const float inv = 1.f / lsum;
      __nv_bfloat16* dst = out + bi * os.b + row * os.s + hi * os.h + c_off;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store_pair(dst + 8 * j, o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
      if (lane % 4 == 0) {
        const long long at = ((long long)bi * h + hi) * s + row;
        if (logl_out == nullptr) {
          m_out[at] = m[hh] + logf(lsum);
        } else {
          m_out[at] = m[hh];
          logl_out[at] = logf(lsum);
        }
      }
    }
  }
}

}  // namespace sm90

}  // namespace flash
