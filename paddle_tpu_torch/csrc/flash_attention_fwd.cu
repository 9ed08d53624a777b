// Flash-attention forward (kernel K1) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` launched by `_flash_fwd` in
// paddle_tpu/ops/flash_attention.py. Same function: q, k, v [b, s, h, d]
// (any strides, unit stride on d), scale 1/sqrt(d), optional causal mask,
// K/V streamed through an online softmax with f32 running max, sum and
// accumulator; out [b, s, h, d] in the input dtype and lse [b, h, s] f32
// (m + log l, in scaled-logit units) for the backward kernel.
//
// Design. The TPU kernel keeps a head's whole K/V in VMEM; a Hopper block
// cannot. One block of 256 threads owns one (b, h, 64-row q tile); it keeps
// the q tile in shared memory and loops over 64-row K/V tiles staged in
// shared memory, all in f32. Tiles entirely above the diagonal are never
// loaded (causal), rows and keys past a ragged s are masked here, and the
// heaviest causal q tiles are launched first. Thread (ty, tx) owns score rows
// ty*4..ty*4+3 and keys tx, tx+16, tx+32, tx+48, so a row's max and sum are a
// shuffle over 16 lanes; shared rows are padded by 4 floats so the float4
// reads of a quarter warp hit distinct banks.
//
// Bound. 4*s*s*d flops per (b, h) (half of it causal) against 4*s*d*bytes
// moved: at the serving shapes the work is matmul-bound on the card. This is
// the simple first version: f32 FMA on the CUDA cores, no tensor cores
// (mma.sync / wgmma), no TMA, no pipelining of the tile loads, so it runs
// far below the bf16 tensor-core bound. Those are later work.

#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::comp;
using flash::from_float;
using flash::load_tile;
using flash::Strides;
constexpr int kBlockQ = flash::kTile;
constexpr int kBlockK = flash::kTile;
constexpr int kThreads = flash::kThreads;

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_bytes() {
  return (3 * 64 * (D + 4) + 64 * (kBlockK + 4)) * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, float* __restrict__ lse, int s, int h, Strides qs,
                     Strides ks, Strides vs, Strides os, int causal, float scale) {
  constexpr int kPitch = D + 4;
  constexpr int kPPitch = kBlockK + 4;
  constexpr int kColGroups = D / 64;  // output columns c*64 + tx*4 + 0..3
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBlockQ * kPitch;
  float* Vs = Ks + kBlockK * kPitch;
  float* Ps = Vs + kBlockK * kPitch;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = qt * kBlockQ;

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

  const int n_tiles = (s + kBlockK - 1) / kBlockK;
  const int n_live = causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < n_live; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are no longer read
    load_tile<T, D>(Ks, k, ks, bi, hi, k0, s);
    load_tile<T, D>(Vs, v, vs, bi, hi, k0, s);
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
        sc[i][j] = visible ? sc[i][j] * scale : -INFINITY;
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
        Ps[(ty * 4 + i) * kPPitch + tx + 16 * j] = p;
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
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kPPitch + kk);
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
    if (tx == 0) lse[((long long)bi * h + hi) * s + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                   int s, int h, const long long* st, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, h, b);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, s, h, qs, ks, vs, os, causal, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. `strides` holds the element
// strides of dims b, s, h for q, k, v and out (12 values); d has unit stride.
// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int b, int s, int h, int d,
                                   const long long* strides, int causal, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0 && d == 64) return launch<float, 64>(q, k, v, out, l, b, s, h, strides, causal, st);
  if (dtype == 0 && d == 128) return launch<float, 128>(q, k, v, out, l, b, s, h, strides, causal, st);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, l, b, s, h, strides, causal, st);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, l, b, s, h, strides, causal, st);
  return cudaErrorInvalidValue;
}
