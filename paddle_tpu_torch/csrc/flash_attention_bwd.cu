// Flash-attention backward (kernel K2) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// launched by `_flash_bwd` in paddle_tpu/ops/flash_attention.py. Same
// function, FlashAttention-2 style from the forward's lse: with
// S = Q K^T * scale, P = exp(S - lse) (causal-masked to 0), di = rowsum(dO o O),
//   dV = P^T dO,   dS = P o (dO V^T - di),   dQ = dS K * scale,   dK = dS^T Q * scale.
// q, k, v, out, dout [b, s, h, d] (any strides, unit stride on d) in f32,
// bf16 or float16, lse [b, h, s] f32 as K1 writes it; dq, dk, dv [b, s, h, d] in the
// input dtype through the caller's strides (so the three can be slices of
// one packed [b, s, 3, h, d] gradient).
//
// Design. As in the reference's split, and deterministic (no atomics): a
// di pre-kernel, a dk/dv kernel per k tile and a dq kernel per q tile.
// Their bodies, shared with K3b (flash_flat_bwd.cu), are in flash_bwd.cuh;
// K2 is their no-bias instance, with lse as the row max and log l = 0.
// f32 inputs take the SIMT bodies (64-row tiles, f32 FMA); bf16 and float16
// inputs the Hopper bodies, one instance each: three warpgroups per block,
// 128 resident rows, 64-row tiles streamed by TMA, every product on wgmma
// (f32 accumulation), P^T / dS^T (dk/dv) and dS (dq) in 16-bit registers as
// the A operand of the product that follows.
//
// Bound. Five matmuls of 2 d flops per visible pair against q, k, v, out,
// dout and lse read once and dq, dk, dv written once; at the O2 step's call
// the flops bound (0.0435 ms bf16) dominates. The split does 7 matmuls (S
// and dP recomputed in the dq kernel) to stay deterministic; the bf16
// bodies run them on the tensor cores with the copies in flight behind
// them.

#include <type_traits>

#include "flash_bwd.cuh"

namespace {

using flash::BiasStrides;
using flash::Strides;
constexpr int kThreads = flash::kThreads;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_di_kernel(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ di,
                  int b, int s, int h, Strides os, Strides gs) {
  flash::di_body<T, D>(out, dout, di, b, s, h, os, gs);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv, int s,
                   int h, Strides qs, Strides ks, Strides vs, Strides gs, Strides dks,
                   Strides dvs, int causal, float scale) {
  flash::dkv_body<T, float, D, false>(q, k, v, dout, nullptr, lse, nullptr, di, dk, dv, s, h,
                                      qs, ks, vs, gs, BiasStrides{0, 0}, dks, dvs, causal, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ di, T* __restrict__ dq, int s, int h, Strides qs,
                  Strides ks, Strides vs, Strides gs, Strides dqs, int causal, float scale) {
  flash::dq_body<T, float, D, false>(q, k, v, dout, nullptr, lse, nullptr, di, dq, s, h, qs, ks,
                                     vs, gs, BiasStrides{0, 0}, dqs, causal, scale);
}

// The 16-bit instances (E: bf16 or f16): the tensor-core bodies
// (flash_bwd.cuh, flash::sm90).
template <typename E, int D>
__global__ void __launch_bounds__(flash::sm90::kThreads, 1)
    bwd_dkv_kernel_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                      const float* __restrict__ di, E* __restrict__ dk, E* __restrict__ dv, int s,
                      int h, Strides dks, Strides dvs, int causal, float scale) {
  flash::sm90::dkv_body_tc<float, D, false, E>(&tq, &tk, &tv, &tdo, nullptr, BiasStrides{0, 0},
                                               lse, nullptr, di, dk, dv, dks, dvs, s, h, causal,
                                               scale);
}

template <typename E, int D>
__global__ void __launch_bounds__(flash::sm90::kThreads, 1)
    bwd_dq_kernel_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                     const float* __restrict__ di, E* __restrict__ dq, int s, int h, Strides dqs,
                     int causal, float scale) {
  flash::sm90::dq_body_tc<float, D, false, E>(&tq, &tk, &tv, &tdo, nullptr, BiasStrides{0, 0}, lse,
                                              nullptr, di, dq, dqs, s, h, causal, scale);
}

template <typename E, int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* out,
                      const void* dout, const float* lse, float* di, void* dq, void* dk, void* dv,
                      int b, int s, int h, const long long* st, int causal, cudaStream_t stream) {
  constexpr int dkv_bytes = flash::sm90::dkv_smem_bytes<D, false>();
  constexpr int dq_bytes = flash::sm90::dq_smem_bytes<D, false>();
  constexpr CUtensorMapDataType ty = flash::sm90::map_dtype<E>();
  cudaError_t err = cudaFuncSetAttribute(bwd_dkv_kernel_tc<E, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_kernel_tc<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
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
  const float scale = 1.f / sqrtf((float)D);

  const long long rows = (long long)b * s * h;
  const int rows_per_block = kThreads / 32;
  bwd_di_kernel<E, D><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), kThreads, 0,
                           stream>>>(static_cast<const E*>(out), static_cast<const E*>(dout),
                                     di, b, s, h, os, gs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((s + 127) / 128, h, b);
  bwd_dkv_kernel_tc<E, D><<<grid, flash::sm90::kThreads, dkv_bytes, stream>>>(
      tq, tk, tv, tdo, lse, di, static_cast<E*>(dk), static_cast<E*>(dv), s, h, dks, dvs,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel_tc<E, D><<<grid, flash::sm90::kThreads, dq_bytes, stream>>>(
      tq, tk, tv, tdo, lse, di, static_cast<E*>(dq), s, h, dqs, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* out,
                        const void* dout, const float* lse, float* di, void* dq, void* dk, void* dv,
                        int b, int s, int h, const long long* st, int causal, cudaStream_t stream) {
  constexpr int dkv_bytes = flash::dkv_smem_bytes<D>(false);
  constexpr int dq_bytes = flash::dq_smem_bytes<D>(false);
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

  const dim3 grid((s + flash::kTile - 1) / flash::kTile, h, b);
  bwd_dkv_kernel<T, D><<<grid, kThreads, dkv_bytes, stream>>>(
      qp, kp, vp, gp, lse, di, static_cast<T*>(dk), static_cast<T*>(dv), s, h, qs, ks, vs, gs,
      dks, dvs, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, D><<<grid, kThreads, dq_bytes, stream>>>(
      qp, kp, vp, gp, lse, di, static_cast<T*>(dq), s, h, qs, ks, vs, gs, dqs, causal, scale);
  return cudaGetLastError();
}


// f32 takes the SIMT bodies, bf16 and f16 the tensor-core bodies (di is SIMT
// for all).
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* di, void* dq, void* dk, void* dv,
                   int b, int s, int h, const long long* st, int causal, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>) {
    return launch_tc<T, D>(q, k, v, out, dout, lse, di, dq, dk, dv, b, s, h, st, causal, stream);
  } else {
    return launch_simt<T, D>(q, k, v, out, dout, lse, di, dq, dk, dv, b, s, h, st, causal, stream);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. `strides` holds the element
// strides of dims b, s, h for q, k, v, out, dout, dq, dk and dv (24 values);
// d has unit stride. `di` is caller-allocated f32 scratch of b*h*s elements.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns the first failing launch's
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
  if (dtype == 2 && d == 64)
    return launch<__half, 64>(q, k, v, out, dout, l, dd, dq, dk, dv, b, s, h, strides, causal, st);
  if (dtype == 2 && d == 128)
    return launch<__half, 128>(q, k, v, out, dout, l, dd, dq, dk, dv, b, s, h, strides, causal, st);
  return cudaErrorInvalidValue;
}
