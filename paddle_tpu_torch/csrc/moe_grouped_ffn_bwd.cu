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
// Rows r >= rows[e] of expert e are the zero token with a zero output
// gradient, whatever finite values xg and dy hold there: dx[r] = 0, and they
// add nothing to any weight or bias gradient.
//
// Design (moe_grouped_ffn.cuh). Five launches on one stream: dp -> dh, whose
// epilogue holds the f32 pre-activation and writes dh (f32, for db1), h =
// T(act(s)) and, in bf16, T(dh), the operands the later products read;
// dx = T(dh) @ w1^T; dw1 = xg^T @ T(dh) and dw2 = h^T @ dy, each reduced
// over the expert's live rows inside one block; and the bias gradients as
// deterministic column sums. Every operand is read as stored (dy @ w2^T and
// dh @ w1^T with B K-major, the weight gradients with A and B MN-major).
// The row-tiled products skip the 128-row tiles past rows[e]. No atomics:
// the gradients are the same from run to run, as the TPU kernels' in-order
// revisits are.
//
// Bound. 8 * L * D * H flops over the L live rows (4 products, s saved)
// against about (R*(3D + 4H) + 4E*D*H) elements moved: bound by operations
// at the model's widths.

#include "moe_grouped_ffn.cuh"

namespace {

using moe::Args;

template <int kEpi, bool kAK, bool kBK>
__global__ void __launch_bounds__(moe::simt::kThreads, 2) moe_ffn_bwd_gemm(Args g) {
  moe::simt::gemm<kEpi, kAK, kBK>(g);
}

template <int kEpi, bool kAK, bool kBK>
__global__ void __launch_bounds__(moe::tc::kThreads, 1)
    moe_ffn_bwd_gemm_tc(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb, Args g) {
  moe::tc::gemm<kEpi, kAK, kBK>(&ta, &tb, g);
}

template <typename T>
__global__ void __launch_bounds__(256)
    moe_ffn_bwd_colsum(const float* dh, const T* dy, const int* rows, T* db1, T* db2, int cap, int D,
                       int H) {
  moe::colsum<T>(dh, dy, rows, db1, db2, cap, D, H);
}

template <typename T, int kEpi, bool kAK, bool kBK>
cudaError_t product(const Args& g, int E, cudaStream_t stream) {
  return moe::launch<T, kAK, kBK>(g, E, stream, moe_ffn_bwd_gemm<kEpi, kAK, kBK>,
                                  moe_ffn_bwd_gemm_tc<kEpi, kAK, kBK>);
}

template <typename T>
cudaError_t backward(const void* xg, const void* w1, const void* w2, const float* s,
                     const void* dy, const int* rows, float* dh, void* dh_t, void* h, void* dx,
                     void* dw1, void* db1, void* dw2, void* db2, int E, int cap, int D, int H,
                     int act, cudaStream_t stream) {
  const long long rows_d = (long long)cap * D, rows_h = (long long)cap * H;
  const long long weights = (long long)D * H;
  // the dx and dw1 products read T(dh): dh itself in f32, its bf16 copy in bf16
  const void* dh_op = std::is_same_v<T, float> ? static_cast<const void*>(dh) : dh_t;
  Args base{};
  base.rows = rows;
  base.cap = cap;
  base.act = act;
  base.vec = D % 4 == 0 && H % 4 == 0;

  Args g = base;  // dh = act'(s) * (dy @ w2[e]^T): A [cap, D] K-major, B = w2[e] [H, D] K-major
  g.a = {dy, rows_d, D};
  g.b = {w2, weights, D};
  g.c = dh;
  g.c_expert = rows_h;
  g.ldc = H;
  g.h = h;
  g.dh_t = dh_t;
  g.aux = s;
  g.M = cap; g.N = H; g.K = D;
  cudaError_t err = product<T, moe::kDh, true, true>(g, E, stream);
  if (err != cudaSuccess) return err;

  g = base;  // dx = T(dh) @ w1[e]^T: A [cap, H] K-major, B = w1[e] [D, H] K-major
  g.a = {dh_op, rows_h, H};
  g.b = {w1, weights, H};
  g.c = dx;
  g.c_expert = rows_d;
  g.ldc = D;
  g.M = cap; g.N = D; g.K = H;
  if ((err = product<T, moe::kDx, true, true>(g, E, stream)) != cudaSuccess) return err;

  g = base;  // dw1[e] = xg_e^T @ T(dh_e): A = xg [cap, D] MN-major, B = T(dh) [cap, H] MN-major
  g.a = {xg, rows_d, D};
  g.b = {dh_op, rows_h, H};
  g.c = dw1;
  g.c_expert = weights;
  g.ldc = H;
  g.M = D; g.N = H; g.K = cap;
  if ((err = product<T, moe::kDw, false, false>(g, E, stream)) != cudaSuccess) return err;

  g = base;  // dw2[e] = h_e^T @ dy_e: A = h [cap, H] MN-major, B = dy [cap, D] MN-major
  g.a = {h, rows_h, H};
  g.b = {dy, rows_d, D};
  g.c = dw2;
  g.c_expert = weights;
  g.ldc = D;
  g.M = H; g.N = D; g.K = cap;
  if ((err = product<T, moe::kDw, false, false>(g, E, stream)) != cudaSuccess) return err;

  // db1 = sum_rows dh, db2 = sum_rows dy over the live rows
  moe_ffn_bwd_colsum<T><<<dim3((H + 31) / 32 + (D + 31) / 32, E), 256, 0, stream>>>(
      dh, static_cast<const T*>(dy), rows, static_cast<T*>(db1), static_cast<T*>(db2), cap, D, H);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. `dh` is an f32 [E*cap, H]
// scratch buffer, `h` one of the operands' dtype, and `dh_t` a bf16 one of
// the same shape for bf16 operands (null for f32). act and dtype as in
// moe_grouped_ffn_fwd; xg, w1, w2, dy and every gradient are of that dtype,
// s float32; `rows` an int32 [E] device array of live rows, or null (all
// cap). Every tensor is contiguous. Returns the first launch error
// (cudaError_t), or 0.
extern "C" int moe_grouped_ffn_bwd(const void* xg, const void* w1, const void* w2, const void* s,
                                   const void* dy, const void* rows, void* dh, void* dh_t, void* h,
                                   void* dx, void* dw1, void* db1, void* dw2, void* db2, int E,
                                   int cap, int D, int H, int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  const int* r = static_cast<const int*>(rows);
  float* dhf = static_cast<float*>(dh);
  if (dtype == 0)
    return backward<float>(xg, w1, w2, sf, dy, r, dhf, nullptr, h, dx, dw1, db1, dw2, db2, E, cap,
                           D, H, act, st);
  if (dtype == 1)
    return backward<__nv_bfloat16>(xg, w1, w2, sf, dy, r, dhf, dh_t, h, dx, dw1, db1, dw2, db2, E,
                                   cap, D, H, act, st);
  return cudaErrorInvalidValue;
}
