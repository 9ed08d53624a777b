// Hopper building blocks of the bf16 flash-attention bodies (flash_fwd.cuh,
// flash_bwd.cuh): mbarriers, TMA tile loads, wgmma on tensor cores and
// their shared-memory descriptors, warpgroup register reallocation, and the
// host-side encoding of a TMA tensor map. sm_90a only (wgmma, setmaxnreg).
//
// Tiles. Every bf16 operand tile lives in shared memory as 64-row x 64-column
// panels of 128-byte rows written by TMA with the 128-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r % 8)); a 64 x d tile is d / 64 panels,
// 8 KiB each, 1024-byte aligned. The same panel is read by wgmma either
// K-major (rows are M or N, the 64 columns are the reduction) or MN-major
// (rows are the reduction, the columns are N), so one copy of Q, K, V or dO
// in shared memory serves both products it takes part in.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the driver entry point is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace flash {
namespace sm90 {

constexpr int kConsumers = 2;                     // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // warpgroup 0 produces (TMA), 1 and 2 consume
constexpr int kStages = 2;                        // depth of the TMA ring
constexpr int kPanel = 64 * 64 * 2;               // bytes of one 64 x 64 bf16 panel (one TMA box)
constexpr int kProducerRegs = 24;                 // setmaxnreg: 24 x 128 + 240 x 256 <= 65,536
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int tile_bytes() { return 64 * D * 2; }  // one 64-row bf16 tile: D / 64 panels

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

// One 64 x 64 box of a [b, s, h, d] operand (tensor map over (d, h, s, b)):
// columns c0.., head hi, rows row0.., batch bi, into the panel at `dst`;
// completion of its bytes is signalled on `bar`. Rows past s read as zero.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int hi, int row0, int bi) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(hi), "r"(row0), "r"(bi)
      : "memory");
}

// A 64-row x D tile (D / 64 boxes) of rows row0.. into `dst`.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int hi, int row0, int bi) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p) tma_load(dst + p * kPanel, map, bar, p * 64, hi, row0, bi);
}

// ---- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor with the 128-byte swizzle; byte offsets.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: a 64-row tile at `tile` whose D columns are the
// reduction; k-step kk covers columns 16 kk .. 16 kk + 15 (32 bytes of a
// 128-byte row; 8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk / 4) * kPanel + (kk % 4) * 32, 16, 1024);
}

// MN-major operand: a 64-row tile at `tile` whose rows are the reduction and
// whose D columns are N; k-step kk covers rows 16 kk .. 16 kk + 15 (8-row
// groups 1024 bytes apart, 64-column panels kPanel apart).
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

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma instruction wrappers: m64nNk16, bf16 in, f32 accumulate.

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs), B in
// shared memory MN-major (transposed: N contiguous).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (bf16 pairs), B in
// shared memory MN-major (transposed: N contiguous).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64_tb(d, a, db);
  } else {
    wgmma_rs_n128_tb(d, a, db);
  }
}

// Accumulator fragment of a 64 x N f32 wgmma result, thread t of the
// warpgroup: element 4j + 2hh + e is row 16 (t / 32) + (t % 32) / 4 + 8 hh,
// column 8j + 2 (t % 4) + e. Its columns 16 kk .. 16 kk + 15, rounded to
// bf16, are exactly the register A operand of k-step kk.
template <int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&d)[N], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 v = __floats2bfloat162_rn(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
    a[i] = *reinterpret_cast<uint32_t*>(&v);
  }
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Max and sum over the 4 lanes (a quad) that share a fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- the additive bias ------------------------------------------------------
//
// A consumer warpgroup's 64 x 64 bias tile (64 query rows q0.. x 64 keys
// k0..) goes global -> registers -> shared memory -> its score fragment.
// The global read is coalesced: thread t of the warpgroup reads rows
// t / 16 + 8 i (i < 8) at keys 4 (t % 16) .. + 3, one 16-byte (f32) or
// 8-byte (bf16) load each where the bias's base and strides allow, else
// four scalar loads; entries past s read as 0 (the caller masks them).
// The raw bits wait in registers and are converted as they are stored.
// The next tile's loads are issued while this tile's scores are computed.
// TMA would need 16-byte aligned bias rows, and K3 takes any s. In shared
// memory the tile is f32 [64][pitch], two buffers per warpgroup; the
// fragment read is free of bank conflicts: float2 pairs at pitch 72 for
// the row-major fragments (fwd, dq), scalars at pitch 68 for dk/dv's
// transposed one.
constexpr int kBiasBuf = 64 * 72;  // floats of one buffer (the larger pitch)

template <bool kBias>
__host__ __device__ constexpr int bias_smem_bytes() {
  return kBias ? 2 * kConsumers * kBiasBuf * 4 : 0;
}

template <typename BT>
__device__ __forceinline__ bool bias_vector_ok(const BT* bias, BiasStrides bst) {
  return bst.q % 4 == 0 && bst.b % 4 == 0 &&
         reinterpret_cast<uintptr_t>(bias) % (4 * sizeof(BT)) == 0;
}

// The raw bits of the 32 bias entries a thread reads: 32 f32 words, or 16
// words of two bf16 each. They are converted to f32 only when stored to
// shared memory, a tile later: converting at the load would stall the
// warpgroup on the load's latency.
template <typename BT>
__host__ __device__ constexpr int bias_words() { return 32 * (int)sizeof(BT) / 4; }

template <typename BT>
__device__ __forceinline__ void bias_load(uint32_t (&r)[bias_words<BT>()],
                                          const BT* __restrict__ bias, BiasStrides bst, int bi,
                                          int q0, int k0, int s, bool vec) {
  constexpr int kW = sizeof(BT);  // words per 4 entries
  const int tid = threadIdx.x % 128;
  const int key = k0 + 4 * (tid % 16);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + tid / 16 + 8 * i;
    const BT* p = bias + bi * bst.b + (long long)row * bst.q + key;
    if (vec && row < s && key + 3 < s) {
      if constexpr (kW == 4) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
        r[4 * i] = v.x;
        r[4 * i + 1] = v.y;
        r[4 * i + 2] = v.z;
        r[4 * i + 3] = v.w;
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        r[2 * i] = v.x;
        r[2 * i + 1] = v.y;
      }
    } else {
      const auto* u = reinterpret_cast<const typename std::conditional<kW == 4, uint32_t,
                                                                      unsigned short>::type*>(p);
      uint32_t e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) e[c] = row < s && key + c < s ? (uint32_t)__ldg(u + c) : 0u;
      if constexpr (kW == 4) {
#pragma unroll
        for (int c = 0; c < 4; ++c) r[4 * i + c] = e[c];
      } else {
        r[2 * i] = e[0] | (e[1] << 16);
        r[2 * i + 1] = e[2] | (e[3] << 16);
      }
    }
  }
}

template <int kPitch, typename BT>
__device__ __forceinline__ void bias_store(float* buf, const uint32_t (&r)[bias_words<BT>()]) {
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float4 v;
    if constexpr (sizeof(BT) == 4) {
      v = make_float4(__uint_as_float(r[4 * i]), __uint_as_float(r[4 * i + 1]),
                      __uint_as_float(r[4 * i + 2]), __uint_as_float(r[4 * i + 3]));
    } else {  // bf16 is the top half of an f32
      v = make_float4(__uint_as_float(r[2 * i] << 16), __uint_as_float(r[2 * i] & 0xffff0000u),
                      __uint_as_float(r[2 * i + 1] << 16),
                      __uint_as_float(r[2 * i + 1] & 0xffff0000u));
    }
    *reinterpret_cast<float4*>(buf + (tid / 16 + 8 * i) * kPitch + 4 * (tid % 16)) = v;
  }
}

// The bias of fragment element i (see a_frag), for a fragment whose rows
// are queries (fwd, dq; pitch 72) or keys (kTransposed: dk/dv; pitch 68).
template <bool kTransposed>
__device__ __forceinline__ void bias_frag(float (&bv)[32], const float* buf) {
  const int tid = threadIdx.x % 128;
  const int r = 16 * (tid / 32) + (tid % 32) / 4;
  const int c = 2 * (tid % 4);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int rr = r + 8 * ((i / 2) % 2);
    const int cc = c + 8 * (i / 4);
    if constexpr (kTransposed) {
      bv[i] = buf[cc * 68 + rr];
      bv[i + 1] = buf[(cc + 1) * 68 + rr];
    } else {
      const float2 v = *reinterpret_cast<const float2*>(buf + rr * 72 + cc);
      bv[i] = v.x;
      bv[i + 1] = v.y;
    }
  }
}

// Barrier of one consumer warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// Store a bf16 pair at `p` (4-byte aligned: the wrappers require 16-byte
// aligned bases and strides).
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
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

// The tensor map of a bf16 [b, s, h, d] operand at `base` with element
// strides `st` (unit stride on d): 4-D over (d, h, s, b) with the operand's
// own byte strides (so a view of a packed [b, s, 3, h, d] projection needs
// no copy), 64 x 64 boxes (64 columns x 1 head x 64 rows x 1 batch), the
// 128-byte swizzle and zero fill past the edges. The wrappers check that
// the base and the strides of dims longer than 1 are 16-byte aligned, as
// TMA requires; a dim of length 1 is never stepped, so its stride is moot.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int b, int s, int h, int d,
                            Strides st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t moot = 2ull * d;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {h > 1 ? 2ull * st.h : moot, s > 1 ? 2ull * st.s : moot,
                                 b > 1 ? 2ull * st.b : moot};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace flash
