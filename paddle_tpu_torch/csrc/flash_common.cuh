// Helpers shared by the flash-attention kernels K1 and K3 (forward,
// flash_fwd.cuh) and K2 and K3b (backward, flash_bwd.cuh): strides, f32 <->
// storage conversions, the 64-row tile loads into shared memory and the
// 16-lane row reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int kTile = 64;      // rows of a q or k/v tile
constexpr int kThreads = 256;  // threads of a block: a 16 x 16 grid over a 64 x 64 score tile
constexpr int kSPitch = kTile + 4;  // row pitch of a 64 x 64 score or bias tile in shared memory

// Element strides of dims b, s, h of a [b, s, h, d] operand (d has unit stride).
struct Strides {
  long long b, s, h;
};

// Element strides of dims b and q of an additive bias [b|1, 1, s, s] (the
// key dim has unit stride; b is 0 for a bias broadcast over the batch).
struct BiasStrides {
  long long b, q;
};

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

// Rows row0 .. row0+63 of head (bi, hi) into dst[64][D + 4] as f32; rows at
// or past s are zero. Neighbouring threads read neighbouring d.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, Strides st,
                                          int bi, int hi, int row0, int s) {
  constexpr int kPitch = D + 4;
  const T* base = src + bi * st.b + hi * st.h;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int row = row0 + r;
    dst[r * kPitch + c] = row < s ? to_float(base[row * st.s + c]) : 0.f;
  }
}

// The 64 x 64 bias tile of query rows q0.. and keys k0.. of batch bi into
// dst[64][kSPitch] as f32; entries past s are zero (they are masked by the
// caller). Neighbouring threads read neighbouring keys.
template <typename BT>
__device__ __forceinline__ void load_bias_tile(float* dst, const BT* __restrict__ bias,
                                               BiasStrides bst, int bi, int q0, int k0, int s) {
  const BT* base = bias + bi * bst.b;
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile;
    const int c = e % kTile;
    const int row = q0 + r;
    const int key = k0 + c;
    dst[r * kSPitch + c] = row < s && key < s ? to_float(base[row * bst.q + key]) : 0.f;
  }
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Max and sum over the 16 lanes (tx) that share a score row.
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

}  // namespace flash
