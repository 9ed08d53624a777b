// Hopper building blocks shared by the bf16 kernel bodies of the port: the
// flash-attention bodies (flash_sm90.cuh, flash_fwd.cuh, flash_bwd.cuh) and
// the grouped expert FFN (moe_grouped_ffn.cuh). mbarriers, TMA tile loads,
// wgmma's shared-memory descriptors and fences, warpgroup register
// reallocation, cp.async, and the host-side encoding of a TMA tensor map.
// sm_90a only (wgmma, setmaxnreg).
//
// Tiles. Every bf16 operand tile lives in shared memory as 64-row x 64-column
// panels of 128-byte rows written by TMA with the 128-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r % 8)), 8 KiB each, 1024-byte aligned. The
// same panel is read by wgmma either K-major (rows are M or N, the 64
// columns are the reduction) or MN-major (rows are the reduction, the
// columns are M or N).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the driver entry point is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kPanel = 64 * 64 * 2;  // bytes of one 64 x 64 bf16 panel (one TMA box)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory, rounded up to 1024 bytes (the 128-byte
// swizzle's period); kernels request 1024 bytes more than they use.
__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ uint8_t smem_tc[];
  const uint32_t a = smem_u32(smem_tc);
  return smem_tc + ((1024u - (a & 1023u)) & 1023u);
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and announce `bytes` of TMA traffic that will complete on `bar`.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA --------------------------------------------------------------------

// One 64 x 64 box of a 3-D operand (tensor map over (columns, rows, z)):
// columns c0.., rows r0.., slice z, into the panel at `dst`; completion of
// its bytes is signalled on `bar`. Entries past the operand's edges read as
// zero (and count toward the bytes).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int r0, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(r0), "r"(z)
      : "memory");
}

// ---- cp.async (the SIMT bodies' ring) -----------------------------------------

// 16 (or 4) bytes from `src` to shared `dst`; zeros where `ok` is false
// (then nothing is read, and `src` need only be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor with the 128-byte swizzle; byte offsets.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: a tile at `tile` of 64-row panels whose columns are the
// reduction; k-step kk covers columns 16 kk .. 16 kk + 15 (32 bytes of a
// 128-byte row; 8-row groups 1024 bytes apart, so consecutive panels
// continue the rows).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk / 4) * kPanel + (kk % 4) * 32, 16, 1024);
}

// MN-major operand: a tile at `tile` whose rows are the reduction and whose
// columns are M or N, 64 columns a panel; k-step kk covers rows 16 kk ..
// 16 kk + 15 (8-row groups 1024 bytes apart, 64-column panels kPanel apart).
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 16 * 128, kPanel, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N of the warpgroup's committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- host: tensor maps ------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library links no -lcuda. Null if the driver has none.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a contiguous bf16 [z, rows, cols] operand at `base`:
// 3-D over (cols, rows, z), 64 x 64 boxes (64 columns x 64 rows x 1 slice),
// the 128-byte swizzle and zero fill past the edges, so a box that runs past
// a slice's last row reads zeros, never the next slice's rows. TMA needs a
// 16-byte aligned base and cols % 8 == 0; the callers check both.
inline cudaError_t make_map_3d(CUtensorMap* map, const void* base, int cols, int rows, int z) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)z};
  const cuuint64_t strides[2] = {2ull * cols, 2ull * cols * rows};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
