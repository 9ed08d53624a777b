// Grouped expert-FFN backward (kernel K4b) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels `_ffn_bwd_fused_kernel`,
// `_ffn_bwd_dx_kernel` and `_ffn_bwd_dw_kernel` launched by
// `_grouped_ffn_bwd` in paddle_tpu/ops/moe_pallas.py. Given the forward's
// residual s = xg @ w1[e] + b1[e] (f32) and the output gradient dy:
//
//     dh  = act'(s) * (dy @ w2[e]^T)               f32
//     dx  = T(dh) @ w1[e]^T                        -> T
//     dw1 = xg_e^T @ T(dh_e),  db1 = sum_rows dh   -> T (sums in f32)
//     dw2 = T(act(s_e))^T @ dy_e, db2 = sum_rows dy
//
// with the reference's rounding points (dh cast to T before the dx and dw1
// products, h = act(s) cast to T; every sum in f32, cast at the end).
// Padding rows hold the zero token and receive dy = 0, so they add nothing
// to any weight or bias gradient.
//
// Design. Four launches of the grouped GEMM of moe_grouped_ffn.cuh on one
// stream: dp -> dh (the activation's derivative in the epilogue, dh kept in
// f32 for db1), then dx, dw1 with db1, and dw2 with db2, each reading its
// operands as stored (dy @ w2^T and dh @ w1^T as "NT" products, the weight
// gradients as "TN" products over the expert's rows). A weight-gradient tile
// is reduced over all of its expert's rows inside one block: no atomics, so
// the gradients are deterministic, as the TPU kernels' in-order revisits
// are. The bias gradients are the column sums of dh and dy, taken by the
// first row tile of the dw1 and dw2 launches as they load them.
//
// Bound. 8 * E*cap * D * H flops (4 products, s saved) against about
// (E*cap*(3D + 4H) + 4E*D*H) elements moved: bound by operations at the
// model's widths. f32 FMA on the CUDA cores, like K4.

#include "moe_grouped_ffn.cuh"

namespace {

using moe::GemmArgs;

template <typename T, typename TA, bool kAT, int kAX, typename TB, bool kBT, int kBX, int kEpi>
__global__ void __launch_bounds__(moe::kThreads) moe_ffn_bwd_gemm(GemmArgs g) {
  moe::gemm_tile<T, TA, kAT, kAX, TB, kBT, kBX, kEpi>(g);
}

template <typename T, typename TA, bool kAT, int kAX, typename TB, bool kBT, int kBX, int kEpi>
cudaError_t run(const GemmArgs& g, int experts, cudaStream_t stream) {
  const dim3 grid((g.N + moe::kBN - 1) / moe::kBN, (g.M + moe::kBM - 1) / moe::kBM, experts);
  moe_ffn_bwd_gemm<T, TA, kAT, kAX, TB, kBT, kBX, kEpi><<<grid, moe::kThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* xg, const void* w1, const void* w2, const float* s,
                     const void* dy, float* dh, void* dx, void* dw1, void* db1, void* dw2,
                     void* db2, int E, int cap, int D, int H, int act, cudaStream_t stream) {
  using moe::kActRound;
  using moe::kRaw;
  using moe::kRound;
  const long long rows_d = (long long)cap * D, rows_h = (long long)cap * H;
  const long long weights = (long long)D * H;

  GemmArgs g{};  // dh = act'(s) * (dy @ w2[e]^T): w2[e] is [H, D], read as [N, K]
  g.a = {dy, rows_d, D};
  g.b = {w2, weights, D};
  g.c = dh;
  g.c_expert = rows_h;
  g.ldc = H;
  g.aux = s;
  g.M = cap; g.N = H; g.K = D; g.act = act;
  cudaError_t err = run<T, T, false, kRaw, T, true, kRaw, moe::kDactF32>(g, E, stream);
  if (err != cudaSuccess) return err;

  g = GemmArgs{};  // dx = T(dh) @ w1[e]^T: w1[e] is [D, H], read as [N, K]
  g.a = {dh, rows_h, H};
  g.b = {w1, weights, H};
  g.c = dx;
  g.c_expert = rows_d;
  g.ldc = D;
  g.M = cap; g.N = D; g.K = H; g.act = act;
  err = run<T, float, false, kRound, T, true, kRaw, moe::kOut>(g, E, stream);
  if (err != cudaSuccess) return err;

  g = GemmArgs{};  // dw1[e] = xg_e^T @ T(dh_e), db1[e] = sum_rows dh_e
  g.a = {xg, rows_d, D};
  g.b = {dh, rows_h, H};
  g.c = dw1;
  g.c_expert = weights;
  g.ldc = H;
  g.dbias = db1;
  g.M = D; g.N = H; g.K = cap; g.act = act;
  err = run<T, T, true, kRaw, float, false, kRound, moe::kWgrad>(g, E, stream);
  if (err != cudaSuccess) return err;

  g = GemmArgs{};  // dw2[e] = T(act(s_e))^T @ dy_e, db2[e] = sum_rows dy_e
  g.a = {s, rows_h, H};
  g.b = {dy, rows_d, D};
  g.c = dw2;
  g.c_expert = weights;
  g.ldc = D;
  g.dbias = db2;
  g.M = H; g.N = D; g.K = cap; g.act = act;
  return run<T, float, true, kActRound, T, false, kRaw, moe::kWgrad>(g, E, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. `dh` is an f32 [E*cap, H] scratch
// buffer. act and dtype as in moe_grouped_ffn_fwd; xg, w1, w2, dy and every
// gradient are of that dtype, s and dh float32. Every tensor is contiguous.
// Returns the first launch error (cudaError_t), or 0.
extern "C" int moe_grouped_ffn_bwd(const void* xg, const void* w1, const void* w2, const void* s,
                                   const void* dy, void* dh, void* dx, void* dw1, void* db1,
                                   void* dw2, void* db2, int E, int cap, int D, int H, int act,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  float* dhf = static_cast<float*>(dh);
  if (dtype == 0)
    return backward<float>(xg, w1, w2, sf, dy, dhf, dx, dw1, db1, dw2, db2, E, cap, D, H, act, st);
  if (dtype == 1)
    return backward<__nv_bfloat16>(xg, w1, w2, sf, dy, dhf, dx, dw1, db1, dw2, db2, E, cap, D, H,
                                   act, st);
  return cudaErrorInvalidValue;
}
