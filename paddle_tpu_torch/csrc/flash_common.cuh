// Helpers shared by the flash-attention kernels K1 (flash_attention_fwd.cu)
// and K2 (flash_attention_bwd.cu): strides, f32 <-> storage conversions and
// the 64-row tile load into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int kTile = 64;      // rows of a q or k/v tile
constexpr int kThreads = 256;  // threads of a block: a 16 x 16 grid over a 64 x 64 score tile

// Element strides of dims b, s, h of a [b, s, h, d] operand (d has unit stride).
struct Strides {
  long long b, s, h;
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

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

}  // namespace flash
