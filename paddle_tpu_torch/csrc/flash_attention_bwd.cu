// Flash-attention backward (kernel K2) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// launched by `_flash_bwd` in paddle_tpu/ops/flash_attention.py. Same
// function, FlashAttention-2 style from the forward's lse: with
// S = Q K^T * scale, P = exp(S - lse) (causal-masked to 0), di = rowsum(dO o O),
//   dV = P^T dO,   dS = P o (dO V^T - di),   dQ = dS K * scale,   dK = dS^T Q * scale.
// q, k, v, out, dout [b, s, h, d] (any strides, unit stride on d) in f32 or
// bf16, lse [b, h, s] f32 as K1 writes it; dq, dk, dv [b, s, h, d] in the
// input dtype through the caller's strides (so the three can be slices of
// one packed [b, s, 3, h, d] gradient). All arithmetic is f32; a bf16
// result is rounded once, at the store.
//
// Design. The TPU pair keeps a head's whole K/V (dq) or Q/dO/lse/di (dk/dv)
// in VMEM; a Hopper block cannot, and blocks run in no order. So, as in the
// reference's split, and deterministic (no atomics):
// - `bwd_di_kernel`: di [b, h, s] f32, one warp per row (the reference does
//   this in jnp outside its Pallas calls).
// - `bwd_dkv_kernel`: one block of 256 threads per (b, h, 64-row k tile).
//   K and V tiles stay in shared memory; the block loops over 64-row q
//   tiles (from the diagonal when causal) with Q, dO staged, recomputes S,
//   P, dP and dS for the 64 x 64 tile, and accumulates dK and dV in f32
//   registers.
// - `bwd_dq_kernel`: one block per (b, h, 64-row q tile); Q, dO stay in
//   shared memory, the block loops over K/V tiles up to the diagonal and
//   accumulates dQ in registers.
// Thread (ty, tx) owns score rows ty*4..ty*4+3 and keys tx, tx+16, tx+32,
// tx+48 of a tile, and accumulator rows ty*4..ty*4+3 at columns
// c*64 + tx*4 + 0..3. Rows and keys past a ragged s are masked here, and the
// heaviest causal tiles are launched first. Shared memory: four 64 x (d+4)
// f32 tiles plus one (dq) or two (dk/dv) 64 x 68 score tiles, 170 KB for
// dk/dv at d = 128, opted in above 48 KB.
//
// Bound. Five matmuls of 2*s*s*d flops per (b, h), half of them when
// causal, against about 9*s*d elements moved: at the training shapes the
// work is matmul-bound. This is the simple first version: f32 FMA on the
// CUDA cores, no tensor cores (mma.sync / wgmma), no TMA, no pipelining of
// the tile loads, so it runs far below the bf16 tensor-core bound. Those are
// later work.

#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::comp;
using flash::from_float;
using flash::load_tile;
using flash::Strides;
using flash::to_float;
constexpr int kT = flash::kTile;
constexpr int kThreads = flash::kThreads;
constexpr int kSPitch = kT + 4;  // row pitch of a 64 x 64 score tile

// di[b, h, s] = sum_d dO * O in f32, one warp per (b, s, h) row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_di_kernel(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ di,
                  int b, int s, int h, Strides os, Strides gs) {
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

// From the scaled-logit scores `sc` and dP = dO V^T of the thread's 4 x 4
// entries (q rows q0 + ty*4 + i, keys k0 + tx + 16*j): P = exp(S*scale - lse),
// masked to 0 outside the visible (row, key) pairs, and dS = P (dP - di).
// Both are written to [64][kSPitch] tiles in shared memory (P only if Ps).
__device__ __forceinline__ void probs_and_dscores(const float (&sc)[4][4], const float (&dp)[4][4],
                                                  const float (&lse)[4], const float (&di)[4],
                                                  float* Ps, float* dSs, int q0, int k0, int s,
                                                  int causal, float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool visible = row < s && key < s && (!causal || key <= row);
      const float p = visible ? expf(sc[i][j] * scale - lse[i]) : 0.f;
      const int at = (ty * 4 + i) * kSPitch + tx + 16 * j;
      if (Ps != nullptr) Ps[at] = p;
      dSs[at] = p * (dp[i][j] - di[i]);
    }
  }
}

// lse and di of the thread's four q rows (0 past s: those rows are masked).
__device__ __forceinline__ void row_stats(float (&lse_r)[4], float (&di_r)[4],
                                          const float* __restrict__ lse,
                                          const float* __restrict__ di, long long head, int q0,
                                          int s, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < s ? lse[head * s + row] : 0.f;
    di_r[i] = row < s ? di[head * s + row] : 0.f;
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (4 * kT * (D + 4) + 2 * kT * kSPitch) * (int)sizeof(float);
}

template <int D>
constexpr int dq_smem_bytes() {
  return (4 * kT * (D + 4) + kT * kSPitch) * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv, int s,
                   int h, Strides qs, Strides ks, Strides vs, Strides gs, Strides dks,
                   Strides dvs, int causal, float scale) {
  constexpr int kPitch = D + 4;
  constexpr int kColGroups = D / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kT * kPitch;
  float* Qs = Vs + kT * kPitch;
  float* dOs = Qs + kT * kPitch;
  float* Ps = dOs + kT * kPitch;
  float* dSs = Ps + kT * kSPitch;

  const int kt = blockIdx.x;  // causal: k tile 0 sees every q tile, so low tiles go first
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k0 = kt * kT;
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

  const int n_tiles = (s + kT - 1) / kT;
  for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kT;
    __syncthreads();  // the previous tile's Qs, dOs, Ps and dSs are no longer read
    load_tile<T, D>(Qs, q, qs, bi, hi, q0, s);
    load_tile<T, D>(dOs, dout, gs, bi, hi, q0, s);
    float lse_r[4], di_r[4];
    row_stats(lse_r, di_r, lse, di, head, q0, s, ty);
    __syncthreads();

    float sc[4][4], dp[4][4];
    tile_nt<D>(sc, Qs, Ks, ty, tx);   // S[q][key]
    tile_nt<D>(dp, dOs, Vs, ty, tx);  // dP[q][key]
    probs_and_dscores(sc, dp, lse_r, di_r, Ps, dSs, q0, k0, s, causal, scale, ty, tx);
    __syncthreads();  // Ps and dSs complete

    // dV[key] += sum_q P[q][key] dO[q];  dK[key] += sum_q dS[q][key] Q[q]
#pragma unroll 2
    for (int qq = 0; qq < kT; ++qq) {
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ di, T* __restrict__ dq, int s, int h, Strides qs,
                  Strides ks, Strides vs, Strides gs, Strides dqs, int causal, float scale) {
  constexpr int kPitch = D + 4;
  constexpr int kColGroups = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kT * kPitch;
  float* Ks = dOs + kT * kPitch;
  float* Vs = Ks + kT * kPitch;
  float* dSs = Vs + kT * kPitch;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = qt * kT;
  const long long head = (long long)bi * h + hi;

  load_tile<T, D>(Qs, q, qs, bi, hi, q0, s);
  load_tile<T, D>(dOs, dout, gs, bi, hi, q0, s);
  float lse_r[4], di_r[4];
  row_stats(lse_r, di_r, lse, di, head, q0, s, ty);

  float acc[4][kColGroups][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kColGroups; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;

  const int n_tiles = (s + kT - 1) / kT;
  const int n_live = causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < n_live; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // the previous tile's Ks, Vs and dSs are no longer read
    load_tile<T, D>(Ks, k, ks, bi, hi, k0, s);
    load_tile<T, D>(Vs, v, vs, bi, hi, k0, s);
    __syncthreads();

    float sc[4][4], dp[4][4];
    tile_nt<D>(sc, Qs, Ks, ty, tx);
    tile_nt<D>(dp, dOs, Vs, ty, tx);
    probs_and_dscores(sc, dp, lse_r, di_r, nullptr, dSs, q0, k0, s, causal, scale, ty, tx);
    __syncthreads();  // dSs complete

    // dQ[q] += sum_key dS[q][key] K[key]
#pragma unroll 2
    for (int kk = 0; kk < kT; kk += 4) {
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* di, void* dq, void* dk, void* dv,
                   int b, int s, int h, const long long* st, int causal, cudaStream_t stream) {
  constexpr int dkv_bytes = dkv_smem_bytes<D>();
  constexpr int dq_bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]};
  const Strides os{st[9], st[10], st[11]}, gs{st[12], st[13], st[14]};
  const Strides dqs{st[15], st[16], st[17]}, dks{st[18], st[19], st[20]};
  const Strides dvs{st[21], st[22], st[23]};
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  const float scale = 1.f / sqrtf((float)D);

  const long long rows = (long long)b * s * h;
  const int rows_per_block = kThreads / 32;
  bwd_di_kernel<T, D><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), kThreads, 0,
                         stream>>>(static_cast<const T*>(out), gp, di, b, s, h, os, gs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((s + kT - 1) / kT, h, b);
  bwd_dkv_kernel<T, D><<<grid, kThreads, dkv_bytes, stream>>>(
      qp, kp, vp, gp, lse, di, static_cast<T*>(dk), static_cast<T*>(dv), s, h, qs, ks, vs, gs,
      dks, dvs, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, D><<<grid, kThreads, dq_bytes, stream>>>(
      qp, kp, vp, gp, lse, di, static_cast<T*>(dq), s, h, qs, ks, vs, gs, dqs, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. `strides` holds the element
// strides of dims b, s, h for q, k, v, out, dout, dq, dk and dv (24 values);
// d has unit stride. `di` is caller-allocated f32 scratch of b*h*s elements.
// dtype: 0 = float32, 1 = bfloat16. Returns the first failing launch's
// cudaError_t, else that of the last launch.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* di, void* dq,
                                   void* dk, void* dv, int b, int s, int h, int d,
                                   const long long* strides, int causal, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dd = static_cast<float*>(di);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, out, dout, l, dd, dq, dk, dv, b, s, h, strides, causal, st);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, out, dout, l, dd, dq, dk, dv, b, s, h, strides, causal, st);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, dout, l, dd, dq, dk, dv, b, s, h, strides,
                                     causal, st);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, dout, l, dd, dq, dk, dv, b, s, h, strides,
                                      causal, st);
  return cudaErrorInvalidValue;
}
