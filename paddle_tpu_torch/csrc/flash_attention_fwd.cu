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
// cannot. The bodies, shared with K3 (flash_flat_fwd.cu), are in
// flash_fwd.cuh; K1 is their no-bias instance. f32 inputs take the SIMT
// body (one 256-thread block per (b, h, 64-row q tile), f32 FMA, true f32
// as the f32 gates need). bf16 and float16 inputs take the Hopper body, one
// instance each: one block of three warpgroups per (b, h, 128-row q tile),
// K/V tiles fed by TMA through an mbarrier ring, S = Q K^T and O += P V by
// wgmma on the tensor cores (.f32.bf16.bf16 or .f32.f16.f16, f32
// accumulation and f32 lse in both), P in 16-bit registers between them
// (flash_fwd.cuh says how).
//
// Bound. 4 d flops per visible query-key pair against q, k, v and out moved
// once. At the O2 training step's call ([8, 1024, 16, 64] bf16, causal,
// packed-qkv views) the card needs 0.0202 ms for the bytes and 0.0174 ms
// for the flops: balanced, so the bf16 body is limited by how well it keeps
// the tensor cores fed between the softmax steps; it overlaps the next
// tile's TMA copy with this tile's products, and two consumer warpgroups
// share each K/V tile. The f32 body is bound by f32 FMA on the CUDA cores
// (0.257 ms of flops at 67 TFLOP/s).

#include <type_traits>

#include "flash_fwd.cuh"

namespace {

using flash::Strides;

template <typename T, int D>
__global__ void __launch_bounds__(flash::kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, float* __restrict__ lse, int s, int h, Strides qs,
                     Strides ks, Strides vs, Strides os, int causal, float scale) {
  flash::fwd_body<T, float, D>(q, k, v, nullptr, out, lse, nullptr, s, h, qs, ks, vs,
                               flash::BiasStrides{0, 0}, os, causal, scale);
}

// The 16-bit instances (E: bf16 or f16): the tensor-core body
// (flash_fwd.cuh, flash::sm90).
template <typename E, int D>
__global__ void __launch_bounds__(flash::sm90::kThreads, 1)
    flash_fwd_kernel_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, E* __restrict__ out,
                        float* __restrict__ lse, int s, int h, Strides os, int causal, float scale) {
  flash::sm90::fwd_body_tc<float, D, false, E>(&tq, &tk, &tv, nullptr, flash::BiasStrides{0, 0},
                                               out, os, lse, nullptr, s, h, causal, scale);
}

template <typename E, int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                      int s, int h, const long long* st, int causal, cudaStream_t stream) {
  constexpr int bytes = flash::sm90::fwd_smem_bytes<D, false>();
  constexpr CUtensorMapDataType ty = flash::sm90::map_dtype<E>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_tc<E, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = flash::sm90::make_map(&tq, q, b, s, h, D, Strides{st[0], st[1], st[2]}, ty)) != cudaSuccess ||
      (err = flash::sm90::make_map(&tk, k, b, s, h, D, Strides{st[3], st[4], st[5]}, ty)) != cudaSuccess ||
      (err = flash::sm90::make_map(&tv, v, b, s, h, D, Strides{st[6], st[7], st[8]}, ty)) != cudaSuccess)
    return err;
  const dim3 grid((s + 127) / 128, h, b);
  flash_fwd_kernel_tc<E, D><<<grid, flash::sm90::kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<E*>(out), lse, s, h, Strides{st[9], st[10], st[11]},
      causal, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                        int s, int h, const long long* st, int causal, cudaStream_t stream) {
  constexpr int bytes = flash::fwd_smem_bytes<D>(false);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + flash::kTile - 1) / flash::kTile, h, b);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  flash_fwd_kernel<T, D><<<grid, flash::kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, s, h, qs, ks, vs, os, causal, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

// f32 takes the SIMT body, bf16 and f16 the tensor-core body.
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                   int s, int h, const long long* st, int causal, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>) {
    return launch_tc<T, D>(q, k, v, out, lse, b, s, h, st, causal, stream);
  } else {
    return launch_simt<T, D>(q, k, v, out, lse, b, s, h, st, causal, stream);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. `strides` holds the element
// strides of dims b, s, h for q, k, v and out (12 values); d has unit stride.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns the launch's cudaError_t.
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
  if (dtype == 2 && d == 64) return launch<__half, 64>(q, k, v, out, l, b, s, h, strides, causal, st);
  if (dtype == 2 && d == 128)
    return launch<__half, 128>(q, k, v, out, l, b, s, h, strides, causal, st);
  return cudaErrorInvalidValue;
}
