// Flat flash-attention forward (kernel K3) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` launched by `_fwd_call` in
// paddle_tpu/ops/flash_attention_flat.py. Same function: per head,
// softmax(q k^T / sqrt(d) + bias [causal]) v over q, k, v that are flat
// [b, s, h*d] or packed [b, s, 3*h*d] projections, with an optional additive
// FINITE bias [b|1, 1, s, s] (f32, or bf16 / float16 as the operands) broadcast
// over heads; out in the
// input dtype, f32 row statistics for the backward (K3b).
//
// Design. The TPU kernel's "flat lanes", head groups, [b, G, s, hg] lse and
// one-hot column selects exist for Mosaic's lane rules. On Hopper a flat or
// packed operand is a [b, s, h, d] view with strides (unit stride on d), so
// K3 is K1's bodies (flash_fwd.cuh) plus the bias, read through its own
// strides (batch stride 0 for a [1, 1, s, s] bias, which is never
// materialised per batch): the f32 body stages a 64 x 64 f32 bias tile in
// shared memory beside each K/V tile; the 16-bit bodies read each thread's
// bias entries into its score fragment.
// The bias is added to the f32 scores before the running max; the scale
// multiplies the f32 scores (the reference scales q in q's dtype, exact only
// for d = 64). The row statistics are m and log l apart, so K3b's
// p = exp(x - m - log l) stays exact on a fully masked row. Ragged s is
// masked here (the reference requires s % block == 0, a TPU rule).
//
// Bound. As K1: 4 d flops per visible pair against q, k, v, out and the
// bias moved once (the bound counts only the pairs the mask leaves live;
// the kernels compute every pair). f32 runs the SIMT body; bf16 and float16
// the Hopper body, one instance each (TMA-fed K/V ring, wgmma products
// .f32.bf16.bf16 or .f32.f16.f16, flash_fwd.cuh), with the bias
// read by the consumer warpgroups from L2 into their score fragments,
// the next tile's during this tile's products.

#include <type_traits>

#include "flash_fwd.cuh"

namespace {

using flash::BiasStrides;
using flash::Strides;

template <typename T, typename BT, int D>
__global__ void __launch_bounds__(flash::kThreads)
    flash_flat_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const BT* __restrict__ bias,
                          T* __restrict__ out, float* __restrict__ m, float* __restrict__ logl,
                          int s, int h, Strides qs, Strides ks, Strides vs, BiasStrides bst,
                          Strides os, int causal, float scale) {
  flash::fwd_body<T, BT, D>(q, k, v, bias, out, m, logl, s, h, qs, ks, vs, bst, os, causal, scale);
}

// The 16-bit instances (E: bf16 or f16): the tensor-core body (flash_fwd.cuh,
// flash::sm90), with the bias code compiled in only where there is a bias.
template <typename E, typename BT, int D, bool kBias>
__global__ void __launch_bounds__(flash::sm90::kThreads, 1)
    flash_flat_fwd_kernel_tc(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const BT* __restrict__ bias,
                             E* __restrict__ out, float* __restrict__ m,
                             float* __restrict__ logl, int s, int h, BiasStrides bst, Strides os,
                             int causal, float scale) {
  flash::sm90::fwd_body_tc<BT, D, kBias, E>(&tq, &tk, &tv, bias, bst, out, os, m, logl, s, h,
                                            causal, scale);
}

template <typename E, typename BT, int D, bool kBias>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* bias, void* out,
                      float* m, float* logl, int b, int s, int h, const long long* st,
                      const long long* bst, int causal, cudaStream_t stream) {
  constexpr int bytes = flash::sm90::fwd_smem_bytes<D, kBias>();
  constexpr CUtensorMapDataType ty = flash::sm90::map_dtype<E>();
  cudaError_t err = cudaFuncSetAttribute(flash_flat_fwd_kernel_tc<E, BT, D, kBias>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = flash::sm90::make_map(&tq, q, b, s, h, D, Strides{st[0], st[1], st[2]}, ty)) != cudaSuccess ||
      (err = flash::sm90::make_map(&tk, k, b, s, h, D, Strides{st[3], st[4], st[5]}, ty)) != cudaSuccess ||
      (err = flash::sm90::make_map(&tv, v, b, s, h, D, Strides{st[6], st[7], st[8]}, ty)) != cudaSuccess)
    return err;
  const dim3 grid((s + 127) / 128, h, b);
  flash_flat_fwd_kernel_tc<E, BT, D, kBias><<<grid, flash::sm90::kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<const BT*>(bias), static_cast<E*>(out), m, logl, s, h,
      BiasStrides{bst[0], bst[1]}, Strides{st[9], st[10], st[11]}, causal, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, typename BT, int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* bias,
                        void* out, float* m, float* logl, int b, int s, int h,
                        const long long* st, const long long* bst, int causal,
                        cudaStream_t stream) {
  const int bytes = flash::fwd_smem_bytes<D>(bias != nullptr);
  cudaError_t err = cudaFuncSetAttribute(flash_flat_fwd_kernel<T, BT, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         flash::fwd_smem_bytes<D>(true));
  if (err != cudaSuccess) return err;
  const dim3 grid((s + flash::kTile - 1) / flash::kTile, h, b);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  flash_flat_fwd_kernel<T, BT, D><<<grid, flash::kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const BT*>(bias), static_cast<T*>(out), m, logl, s, h, qs, ks, vs,
      BiasStrides{bst[0], bst[1]}, os, causal, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, typename BT, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   float* m, float* logl, int b, int s, int h, const long long* st,
                   const long long* bst, int causal, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>) {
    // 16-bit: the tensor-core body
    if (bias != nullptr)
      return launch_tc<T, BT, D, true>(q, k, v, bias, out, m, logl, b, s, h, st, bst, causal,
                                       stream);
    return launch_tc<T, float, D, false>(q, k, v, bias, out, m, logl, b, s, h, st, bst, causal,
                                         stream);
  } else {  // f32: the SIMT body
    return launch_simt<T, BT, D>(q, k, v, bias, out, m, logl, b, s, h, st, bst, causal, stream);
  }
}

template <typename T, typename BT>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v, const void* bias,
                     void* out, float* m, float* logl, int b, int s, int h, const long long* st,
                     const long long* bst, int causal, cudaStream_t stream) {
  if (d == 64) return launch<T, BT, 64>(q, k, v, bias, out, m, logl, b, s, h, st, bst, causal, stream);
  if (d == 128)
    return launch<T, BT, 128>(q, k, v, bias, out, m, logl, b, s, h, st, bst, causal, stream);
  return cudaErrorInvalidValue;
}

// The instances of one operand dtype T by the bias's dtype: f32, or a 16-bit
// bias of T's own type (f32 operands take either 16-bit type).
template <typename T>
cudaError_t launch_bias(int bias_dtype, int d, const void* q, const void* k, const void* v,
                        const void* bias, void* out, float* m, float* logl, int b, int s, int h,
                        const long long* st, const long long* bst, int causal,
                        cudaStream_t stream) {
  constexpr bool f32 = std::is_same_v<T, float>;
  if (bias == nullptr || bias_dtype == 0)
    return launch_d<T, float>(d, q, k, v, bias, out, m, logl, b, s, h, st, bst, causal, stream);
  if constexpr (f32 || std::is_same_v<T, __nv_bfloat16>) {
    if (bias_dtype == 1)
      return launch_d<T, __nv_bfloat16>(d, q, k, v, bias, out, m, logl, b, s, h, st, bst, causal,
                                        stream);
  }
  if constexpr (f32 || std::is_same_v<T, __half>) {
    if (bias_dtype == 2)
      return launch_d<T, __half>(d, q, k, v, bias, out, m, logl, b, s, h, st, bst, causal, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes. `strides` holds the element
// strides of dims b, s, h for q, k, v and out (12 values; d has unit
// stride); `bias_strides` those of the bias's dims b and q (2 values; the
// key dim has unit stride). `bias` may be null (no bias). `m` and `logl`
// are f32 [b, h, s]. dtype: 0 = float32, 1 = bfloat16, 2 = float16, for q,
// k, v, out; bias_dtype the same for the bias (ignored without one): f32 or
// the operands' own type (f32 operands take any of the three). Returns the
// launch's cudaError_t.
extern "C" int flash_flat_fwd(const void* q, const void* k, const void* v, const void* bias,
                              void* out, void* m, void* logl, int b, int s, int h, int d,
                              const long long* strides, const long long* bias_strides,
                              int causal, int dtype, int bias_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(logl);
  if (dtype == 0)
    return launch_bias<float>(bias_dtype, d, q, k, v, bias, out, mm, ll, b, s, h, strides,
                              bias_strides, causal, st);
  if (dtype == 1)
    return launch_bias<__nv_bfloat16>(bias_dtype, d, q, k, v, bias, out, mm, ll, b, s, h, strides,
                                      bias_strides, causal, st);
  if (dtype == 2)
    return launch_bias<__half>(bias_dtype, d, q, k, v, bias, out, mm, ll, b, s, h, strides,
                               bias_strides, causal, st);
  return cudaErrorInvalidValue;
}
