// Flat flash-attention backward (kernel K3b) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` launched by `_bwd_call` in
// paddle_tpu/ops/flash_attention_flat.py. Same function: dq, dk, dv of K3's
// softmax(q k^T / sqrt(d) + bias [causal]) v, with the same additive bias
// [b|1, 1, s, s] (f32, or bf16 / float16 as the operands; it gets no gradient)
// and causal rule, from
// K3's row statistics (m and log l) and di = rowsum(dO o O).
//
// Design. The reference runs ONE fused kernel over k blocks and
// accumulates dq in a VMEM-resident block across sequential grid steps;
// Hopper blocks run in no order, so that design would need atomics. K3b is
// instead K2's deterministic split (flash_bwd.cuh): a di pre-kernel, a dk/dv
// kernel over k tiles that walks q tiles, and a dq kernel over q tiles that
// walks k tiles. Both recompute p = exp(s + bias - m - log l), the bias read
// through its strides (f32: a 64 x 64 tile staged in shared memory; 16-bit:
// each thread's entries into its score fragment). dq, dk and dv
// are written through the caller's strides, so the packed route's three
// land in one [b, s, 3, h, d] gradient. Whether there is a bias is a
// template parameter: the no-bias instances (GPT's packed route) compile the
// bias code out, as K2's do. Shared memory at d = 128 with a bias: 187,392
// bytes (f32 dk/dv) and 169,984 (f32 dq), under the card's 232,448; the
// 16-bit bodies take 134,184 (dk/dv) and 132,136 (dq) at d = 128.
//
// Bound. As K2: five matmuls of 2 d flops per visible pair (7 computed,
// the price of the deterministic split) against q, k, v, out, dout, the
// bias and the statistics read once and dq, dk, dv written once. f32 runs
// the SIMT bodies; bf16 and float16 the Hopper bodies, one instance each
// (TMA-fed rings, wgmma products,
// flash_bwd.cuh).

#include <type_traits>

#include "flash_bwd.cuh"

namespace {

using flash::BiasStrides;
using flash::Strides;
constexpr int kThreads = flash::kThreads;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flat_bwd_di_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ di, int b, int s, int h, Strides os, Strides gs) {
  flash::di_body<T, D>(out, dout, di, b, s, h, os, gs);
}

template <typename T, typename BT, int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
    flat_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const BT* __restrict__ bias,
                        const float* __restrict__ m, const float* __restrict__ logl,
                        const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                        int s, int h, Strides qs, Strides ks, Strides vs, Strides gs,
                        BiasStrides bst, Strides dks, Strides dvs, int causal, float scale) {
  flash::dkv_body<T, BT, D, kBias>(q, k, v, dout, bias, m, logl, di, dk, dv, s, h, qs, ks, vs,
                                   gs, bst, dks, dvs, causal, scale);
}

template <typename T, typename BT, int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
    flat_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ dout, const BT* __restrict__ bias,
                       const float* __restrict__ m, const float* __restrict__ logl,
                       const float* __restrict__ di, T* __restrict__ dq, int s, int h, Strides qs,
                       Strides ks, Strides vs, Strides gs, BiasStrides bst, Strides dqs,
                       int causal, float scale) {
  flash::dq_body<T, BT, D, kBias>(q, k, v, dout, bias, m, logl, di, dq, s, h, qs, ks, vs, gs,
                                  bst, dqs, causal, scale);
}

// The 16-bit instances (E: bf16 or f16): the tensor-core bodies
// (flash_bwd.cuh, flash::sm90).
template <typename E, typename BT, int D, bool kBias>
__global__ void __launch_bounds__(flash::sm90::kThreads, 1)
    flat_bwd_dkv_kernel_tc(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo, const BT* __restrict__ bias,
                           BiasStrides bst, const float* __restrict__ m,
                           const float* __restrict__ logl, const float* __restrict__ di,
                           E* __restrict__ dk, E* __restrict__ dv, int s, int h, Strides dks,
                           Strides dvs, int causal, float scale) {
  flash::sm90::dkv_body_tc<BT, D, kBias, E>(&tq, &tk, &tv, &tdo, bias, bst, m, logl, di, dk, dv,
                                            dks, dvs, s, h, causal, scale);
}

template <typename E, typename BT, int D, bool kBias>
__global__ void __launch_bounds__(flash::sm90::kThreads, 1)
    flat_bwd_dq_kernel_tc(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const BT* __restrict__ bias,
                          BiasStrides bst, const float* __restrict__ m,
                          const float* __restrict__ logl, const float* __restrict__ di,
                          E* __restrict__ dq, int s, int h, Strides dqs, int causal, float scale) {
  flash::sm90::dq_body_tc<BT, D, kBias, E>(&tq, &tk, &tv, &tdo, bias, bst, m, logl, di, dq, dqs, s,
                                           h, causal, scale);
}

template <typename E, typename BT, int D, bool kBias>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* bias,
                      const void* out, const void* dout, const float* m, const float* logl,
                      float* di, void* dq, void* dk, void* dv, int b, int s, int h,
                      const long long* st, const long long* bst_in, int causal,
                      cudaStream_t stream) {
  constexpr int dkv_bytes = flash::sm90::dkv_smem_bytes<D, kBias>();
  constexpr int dq_bytes = flash::sm90::dq_smem_bytes<D, kBias>();
  constexpr CUtensorMapDataType ty = flash::sm90::map_dtype<E>();
  cudaError_t err = cudaFuncSetAttribute(flat_bwd_dkv_kernel_tc<E, BT, D, kBias>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flat_bwd_dq_kernel_tc<E, BT, D, kBias>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  if ((err = flash::sm90::make_map(&tq, q, b, s, h, D, Strides{st[0], st[1], st[2]}, ty)) != cudaSuccess ||
      (err = flash::sm90::make_map(&tk, k, b, s, h, D, Strides{st[3], st[4], st[5]}, ty)) != cudaSuccess ||
      (err = flash::sm90::make_map(&tv, v, b, s, h, D, Strides{st[6], st[7], st[8]}, ty)) != cudaSuccess ||
      (err = flash::sm90::make_map(&tdo, dout, b, s, h, D, Strides{st[12], st[13], st[14]}, ty)) !=
          cudaSuccess)
    return err;
  const Strides os{st[9], st[10], st[11]}, gs{st[12], st[13], st[14]};
  const Strides dqs{st[15], st[16], st[17]}, dks{st[18], st[19], st[20]};
  const Strides dvs{st[21], st[22], st[23]};
  const BiasStrides bst{bst_in[0], bst_in[1]};
  const BT* bp = static_cast<const BT*>(bias);
  const float scale = 1.f / sqrtf((float)D);

  const long long rows = (long long)b * s * h;
  const int rows_per_block = kThreads / 32;
  flat_bwd_di_kernel<E, D><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                             kThreads, 0, stream>>>(static_cast<const E*>(out),
                                                    static_cast<const E*>(dout), di, b, s, h, os,
                                                    gs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((s + 127) / 128, h, b);
  flat_bwd_dkv_kernel_tc<E, BT, D, kBias><<<grid, flash::sm90::kThreads, dkv_bytes, stream>>>(
      tq, tk, tv, tdo, bp, bst, m, logl, di, static_cast<E*>(dk), static_cast<E*>(dv), s, h, dks,
      dvs, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flat_bwd_dq_kernel_tc<E, BT, D, kBias><<<grid, flash::sm90::kThreads, dq_bytes, stream>>>(
      tq, tk, tv, tdo, bp, bst, m, logl, di, static_cast<E*>(dq), s, h, dqs, causal, scale);
  return cudaGetLastError();
}

template <typename T, typename BT, int D, bool kBias>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* bias,
                        const void* out, const void* dout, const float* m, const float* logl,
                        float* di, void* dq, void* dk, void* dv, int b, int s, int h,
                        const long long* st, const long long* bst_in, int causal,
                        cudaStream_t stream) {
  constexpr int dkv_bytes = flash::dkv_smem_bytes<D>(kBias);
  constexpr int dq_bytes = flash::dq_smem_bytes<D>(kBias);
  cudaError_t err = cudaFuncSetAttribute(flat_bwd_dkv_kernel<T, BT, D, kBias>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flat_bwd_dq_kernel<T, BT, D, kBias>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]};
  const Strides os{st[9], st[10], st[11]}, gs{st[12], st[13], st[14]};
  const Strides dqs{st[15], st[16], st[17]}, dks{st[18], st[19], st[20]};
  const Strides dvs{st[21], st[22], st[23]};
  const BiasStrides bst{bst_in[0], bst_in[1]};
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  const BT* bp = static_cast<const BT*>(bias);
  const float scale = 1.f / sqrtf((float)D);

  const long long rows = (long long)b * s * h;
  const int rows_per_block = kThreads / 32;
  flat_bwd_di_kernel<T, D><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), kThreads,
                             0, stream>>>(static_cast<const T*>(out), gp, di, b, s, h, os, gs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((s + flash::kTile - 1) / flash::kTile, h, b);
  flat_bwd_dkv_kernel<T, BT, D, kBias><<<grid, kThreads, dkv_bytes, stream>>>(
      qp, kp, vp, gp, bp, m, logl, di, static_cast<T*>(dk), static_cast<T*>(dv), s, h, qs, ks,
      vs, gs, bst, dks, dvs, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flat_bwd_dq_kernel<T, BT, D, kBias><<<grid, kThreads, dq_bytes, stream>>>(
      qp, kp, vp, gp, bp, m, logl, di, static_cast<T*>(dq), s, h, qs, ks, vs, gs, bst, dqs,
      causal, scale);
  return cudaGetLastError();
}

// f32 takes the SIMT bodies, bf16 and f16 the tensor-core bodies (di is SIMT
// for all).
template <typename T, typename BT, int D, bool kBias>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* out, const void* dout, const float* m, const float* logl,
                   float* di, void* dq, void* dk, void* dv, int b, int s, int h,
                   const long long* st, const long long* bst, int causal, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>) {
    return launch_tc<T, BT, D, kBias>(q, k, v, bias, out, dout, m, logl, di, dq, dk, dv, b, s, h, st,
                                   bst, causal, stream);
  } else {
    return launch_simt<T, BT, D, kBias>(q, k, v, bias, out, dout, m, logl, di, dq, dk, dv, b, s,
                                        h, st, bst, causal, stream);
  }
}

template <typename T, typename BT, bool kBias>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v, const void* bias,
                     const void* out, const void* dout, const float* m, const float* logl,
                     float* di, void* dq, void* dk, void* dv, int b, int s, int h,
                     const long long* st, const long long* bst, int causal, cudaStream_t stream) {
  if (d == 64)
    return launch<T, BT, 64, kBias>(q, k, v, bias, out, dout, m, logl, di, dq, dk, dv, b, s, h,
                                    st, bst, causal, stream);
  if (d == 128)
    return launch<T, BT, 128, kBias>(q, k, v, bias, out, dout, m, logl, di, dq, dk, dv, b, s, h,
                                     st, bst, causal, stream);
  return cudaErrorInvalidValue;
}

// The instances of one operand dtype T by the bias: none, f32, or a 16-bit
// bias of T's own type (f32 operands take either 16-bit type); the no-bias
// instances compile the bias code out, as K2's do.
template <typename T>
cudaError_t launch_bias(int bias_dtype, int d, const void* q, const void* k, const void* v,
                        const void* bias, const void* out, const void* dout, const float* m,
                        const float* logl, float* di, void* dq, void* dk, void* dv, int b, int s,
                        int h, const long long* st, const long long* bst, int causal,
                        cudaStream_t stream) {
  constexpr bool f32 = std::is_same_v<T, float>;
  if (bias == nullptr)
    return launch_d<T, float, false>(d, q, k, v, bias, out, dout, m, logl, di, dq, dk, dv, b, s,
                                     h, st, bst, causal, stream);
  if (bias_dtype == 0)
    return launch_d<T, float, true>(d, q, k, v, bias, out, dout, m, logl, di, dq, dk, dv, b, s, h,
                                    st, bst, causal, stream);
  if constexpr (f32 || std::is_same_v<T, __nv_bfloat16>) {
    if (bias_dtype == 1)
      return launch_d<T, __nv_bfloat16, true>(d, q, k, v, bias, out, dout, m, logl, di, dq, dk, dv,
                                              b, s, h, st, bst, causal, stream);
  }
  if constexpr (f32 || std::is_same_v<T, __half>) {
    if (bias_dtype == 2)
      return launch_d<T, __half, true>(d, q, k, v, bias, out, dout, m, logl, di, dq, dk, dv, b, s,
                                       h, st, bst, causal, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes. `strides` holds the element
// strides of dims b, s, h for q, k, v, out, dout, dq, dk and dv (24 values;
// d has unit stride); `bias_strides` those of the bias's dims b and q (2
// values; the key dim has unit stride). `bias` may be null (no bias). `m`
// and `logl` are K3's f32 [b, h, s] statistics; `di` is caller-allocated
// f32 scratch of b*h*s elements. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16, for the q/k/v family; bias_dtype the same for the bias
// (ignored without one): f32 or the operands' own type (f32 operands take
// any of the three).
// Returns the first failing launch's cudaError_t, else that of the last.
extern "C" int flash_flat_bwd(const void* q, const void* k, const void* v, const void* bias,
                              const void* out, const void* dout, const void* m, const void* logl,
                              void* di, void* dq, void* dk, void* dv, int b, int s, int h, int d,
                              const long long* strides, const long long* bias_strides,
                              int causal, int dtype, int bias_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mm = static_cast<const float*>(m);
  const float* ll = static_cast<const float*>(logl);
  float* dd = static_cast<float*>(di);
  if (dtype == 0)
    return launch_bias<float>(bias_dtype, d, q, k, v, bias, out, dout, mm, ll, dd, dq, dk, dv, b,
                              s, h, strides, bias_strides, causal, st);
  if (dtype == 1)
    return launch_bias<__nv_bfloat16>(bias_dtype, d, q, k, v, bias, out, dout, mm, ll, dd, dq, dk,
                                      dv, b, s, h, strides, bias_strides, causal, st);
  if (dtype == 2)
    return launch_bias<__half>(bias_dtype, d, q, k, v, bias, out, dout, mm, ll, dd, dq, dk, dv, b,
                               s, h, strides, bias_strides, causal, st);
  return cudaErrorInvalidValue;
}
