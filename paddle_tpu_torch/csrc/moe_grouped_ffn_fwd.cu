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
// Rows r >= rows[e] of expert e are the zero token, whatever xg holds there:
// s[r] = f32(b1[e]) and y[r] = T(T(act(b1[e])) @ w2[e] + b2[e]).
//
// Design (moe_grouped_ffn.cuh). Three launches: s = xg @ w1 + b1, whose
// epilogue also writes h = T(act(s)) once into a scratch buffer; y = h @ w2
// + b2; and a fill of the padding rows past the computed tiles with the
// zero token's y, which the second launch computed as row rows[e]. Both
// products skip the 128-row tiles that hold no live row. bf16 runs them on
// wgmma tensor cores with TMA-fed operands, f32 on the CUDA cores with a
// cp.async ring. The TPU kernel's split into a small and a hidden-tiled
// variant is a VMEM matter and does not carry over.
//
// Bound. 4 * L * D * H flops over the L live rows against about
// (R*(2D + 4H) + 2E*D*H) elements moved: at the model's widths the work is
// bound by operations, at 67 TFLOP/s (f32, CUDA cores) or 989 (bf16).

#include "moe_grouped_ffn.cuh"

namespace {

using moe::Args;

template <int kEpi, bool kAK, bool kBK>
__global__ void __launch_bounds__(moe::simt::kThreads, 2) moe_ffn_fwd_gemm(Args g) {
  moe::simt::gemm<kEpi, kAK, kBK>(g);
}

template <int kEpi, bool kAK, bool kBK>
__global__ void __launch_bounds__(moe::tc::kThreads, 1)
    moe_ffn_fwd_gemm_tc(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb, Args g) {
  moe::tc::gemm<kEpi, kAK, kBK>(&ta, &tb, g);
}

template <typename T>
__global__ void __launch_bounds__(256) moe_ffn_fwd_fill(T* y, const int* rows, int cap, int D) {
  moe::fill_rows<T>(y, rows, cap, D);
}

template <typename T, int kEpi, bool kAK, bool kBK>
cudaError_t product(const Args& g, int E, cudaStream_t stream) {
  return moe::launch<T, kAK, kBK>(g, E, stream, moe_ffn_fwd_gemm<kEpi, kAK, kBK>,
                                  moe_ffn_fwd_gemm_tc<kEpi, kAK, kBK>);
}

template <typename T>
cudaError_t forward(const void* xg, const void* w1, const void* b1, const void* w2, const void* b2,
                    const int* rows, float* s, void* h, void* y, int E, int cap, int D, int H,
                    int act, cudaStream_t stream) {
  Args g{};  // s = xg @ w1[e] + b1[e], h = T(act(s)): A [cap, D] K-major, B [D, H] MN-major
  g.a = {xg, (long long)cap * D, D};
  g.b = {w1, (long long)D * H, H};
  g.c = s;
  g.c_expert = (long long)cap * H;
  g.ldc = H;
  g.h = h;
  g.aux = b1;
  g.rows = rows;
  g.M = cap; g.N = H; g.K = D; g.cap = cap; g.act = act;
  g.vec = D % 4 == 0 && H % 4 == 0;
  cudaError_t err = product<T, moe::kS, true, false>(g, E, stream);
  if (err != cudaSuccess) return err;
  g.a = {h, (long long)cap * H, H};  // y = h @ w2[e] + b2[e]: A [cap, H] K-major, B [H, D] MN-major
  g.b = {w2, (long long)H * D, D};
  g.c = y;
  g.c_expert = (long long)cap * D;
  g.ldc = D;
  g.h = nullptr;
  g.aux = b2;
  g.N = D; g.K = H;
  if ((err = product<T, moe::kY, true, false>(g, E, stream)) != cudaSuccess || rows == nullptr)
    return err;
  const int blocks = (int)std::min<long long>(((long long)cap * D + 2047) / 2048, 4096);
  moe_ffn_fwd_fill<T><<<dim3(blocks, E), 256, 0, stream>>>(static_cast<T*>(y), rows, cap, D);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. act: 0 = gelu (tanh form),
// 1 = relu, 2 = silu. dtype: 0 = float32, 1 = bfloat16 (xg, w1, b1, w2, b2,
// y and the scratch h [E*cap, H]); s is always float32. `rows` is an int32
// [E] device array of each expert's live rows, or null (all cap). Every
// tensor is contiguous; bf16 ones 16-byte aligned with D % 8 == H % 8 == 0.
// Returns the first launch error (cudaError_t), or 0.
extern "C" int moe_grouped_ffn_fwd(const void* xg, const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* rows, void* s, void* h, void* y,
                                   int E, int cap, int D, int H, int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  float* sf = static_cast<float*>(s);
  if (dtype == 0) return forward<float>(xg, w1, b1, w2, b2, r, sf, h, y, E, cap, D, H, act, st);
  if (dtype == 1)
    return forward<__nv_bfloat16>(xg, w1, b1, w2, b2, r, sf, h, y, E, cap, D, H, act, st);
  return cudaErrorInvalidValue;
}
