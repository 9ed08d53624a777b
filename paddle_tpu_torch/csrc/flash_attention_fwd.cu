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
// cannot. The body, shared with K3 (flash_flat_fwd.cu), is in flash_fwd.cuh:
// one block of 256 threads per (b, h, 64-row q tile), K/V tiles streamed
// through shared memory, f32 throughout. K1 is its no-bias instance.
//
// Bound. 4*s*s*d flops per (b, h) (half of it causal) against 4*s*d*bytes
// moved: at the serving shapes the work is matmul-bound on the card. This is
// the simple first version: f32 FMA on the CUDA cores, no tensor cores
// (mma.sync / wgmma), no TMA, no pipelining of the tile loads, so it runs
// far below the bf16 tensor-core bound. Those are later work.

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
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
