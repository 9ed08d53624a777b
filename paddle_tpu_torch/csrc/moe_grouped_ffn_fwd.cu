// Grouped expert-FFN forward (kernel K4) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels `_ffn_fwd_small_kernel` and
// `_ffn_fwd_kernel` launched by `_grouped_ffn_fwd` in
// paddle_tpu/ops/moe_pallas.py. Same function over the sorted, padded MoE
// dispatch layout (expert e owns rows e*cap .. e*cap+cap-1 of xg):
//
//     s = xg @ w1[e] + b1[e]                 f32, kept as the backward's residual
//     y = T(act(s)) @ w2[e] + f32(b2[e])     accumulated in f32, then cast to T
//
// xg [E*cap, D], w1 [E, D, H], b1 [E, 1, H], w2 [E, H, D], b2 [E, 1, D], all
// of one type T (f32 or bf16); s [E*cap, H] f32, y [E*cap, D] T. The
// rounding points are the reference's: s in f32 with b1 added in f32, h cast
// to T before the second product, y in f32 with b2 in f32 before the cast.
//
// Design. Two launches of the grouped GEMM of moe_grouped_ffn.cuh: the first
// writes s (as the TPU's single-hidden-tile kernel does, whatever H is), the
// second applies the activation and the rounding to s as it loads it, so h
// never exists in device memory. The TPU kernel's split into a small and a
// hidden-tiled variant is a VMEM matter and does not carry over.
//
// Bound. 4 * E*cap * D * H flops against about (E*cap*(2D + 4H) + 2E*D*H)
// elements moved: at the model's widths the work is bound by operations.
// This version runs on the CUDA cores in f32 (see moe_grouped_ffn.cuh), so
// in bf16 it is far from the tensor-core bound.

#include "moe_grouped_ffn.cuh"

namespace {

using moe::GemmArgs;

template <typename T, typename TA, bool kAT, int kAX, typename TB, bool kBT, int kBX, int kEpi>
__global__ void __launch_bounds__(moe::kThreads) moe_ffn_fwd_gemm(GemmArgs g) {
  moe::gemm_tile<T, TA, kAT, kAX, TB, kBT, kBX, kEpi>(g);
}

template <typename T, typename TA, bool kAT, int kAX, typename TB, bool kBT, int kBX, int kEpi>
cudaError_t run(const GemmArgs& g, int experts, cudaStream_t stream) {
  const dim3 grid((g.N + moe::kBN - 1) / moe::kBN, (g.M + moe::kBM - 1) / moe::kBM, experts);
  moe_ffn_fwd_gemm<T, TA, kAT, kAX, TB, kBT, kBX, kEpi><<<grid, moe::kThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const void* xg, const void* w1, const void* b1, const void* w2, const void* b2,
                    float* s, void* y, int E, int cap, int D, int H, int act, cudaStream_t stream) {
  using moe::kActRound;
  using moe::kRaw;
  GemmArgs g1{};  // s = xg @ w1[e] + b1[e]
  g1.a = {xg, (long long)cap * D, D};
  g1.b = {w1, (long long)D * H, H};
  g1.c = s;
  g1.c_expert = (long long)cap * H;
  g1.ldc = H;
  g1.aux = b1;
  g1.M = cap; g1.N = H; g1.K = D; g1.act = act;
  cudaError_t err = run<T, T, false, kRaw, T, false, kRaw, moe::kBiasF32>(g1, E, stream);
  if (err != cudaSuccess) return err;
  GemmArgs g2{};  // y = T(act(s)) @ w2[e] + b2[e]
  g2.a = {s, (long long)cap * H, H};
  g2.b = {w2, (long long)H * D, D};
  g2.c = y;
  g2.c_expert = (long long)cap * D;
  g2.ldc = D;
  g2.aux = b2;
  g2.M = cap; g2.N = D; g2.K = H; g2.act = act;
  return run<T, float, false, kActRound, T, false, kRaw, moe::kBiasOut>(g2, E, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. act: 0 = gelu (tanh form),
// 1 = relu, 2 = silu. dtype: 0 = float32, 1 = bfloat16 (xg, w1, b1, w2, b2
// and y); s is always float32. Every tensor is contiguous. Returns the first
// launch error (cudaError_t), or 0.
extern "C" int moe_grouped_ffn_fwd(const void* xg, const void* w1, const void* b1, const void* w2,
                                   const void* b2, void* s, void* y, int E, int cap, int D, int H,
                                   int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(s);
  if (dtype == 0) return forward<float>(xg, w1, b1, w2, b2, sf, y, E, cap, D, H, act, st);
  if (dtype == 1) return forward<__nv_bfloat16>(xg, w1, b1, w2, b2, sf, y, E, cap, D, H, act, st);
  return cudaErrorInvalidValue;
}
