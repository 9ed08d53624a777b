// Hopper building blocks of the 16-bit flash-attention bodies (flash_fwd.cuh,
// flash_bwd.cuh), each an instance per element type E (__nv_bfloat16 or
// __half; both two bytes, f32 accumulation): the 4-D TMA tile loads of a [b, s, h, d] operand, the
// wgmma instructions the bodies issue, the accumulator-to-operand fragment,
// the additive bias's staging, and the tensor map of a [b, s, h, d]
// operand. The generic pieces (mbarriers, descriptors, fences, setmaxnreg,
// the driver's map encoder) are hopper.cuh's, shared with the grouped
// expert FFN. sm_90a only (wgmma, setmaxnreg).
//
// Tiles. A 64 x d operand tile is d / 64 of hopper.cuh's swizzled 64 x 64
// panels; the same panel is read K-major or MN-major, so one copy of Q, K,
// V or dO in shared memory serves both products it takes part in.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace flash {
namespace sm90 {

using hopper::desc_k;
using hopper::desc_mn;
using hopper::desc_sw128;
using hopper::encode_tiled;
using hopper::EncodeTiled;
using hopper::fence_regs;
using hopper::kPanel;
using hopper::mbar_arrive;
using hopper::mbar_arrive_tx;
using hopper::mbar_init;
using hopper::mbar_init_fence;
using hopper::mbar_wait;
using hopper::setmaxnreg_dec;
using hopper::setmaxnreg_inc;
using hopper::smem_base;
using hopper::smem_u32;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int kConsumers = 2;                     // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // warpgroup 0 produces (TMA), 1 and 2 consume
constexpr int kStages = 2;                        // depth of the TMA ring
constexpr int kProducerRegs = 24;                 // setmaxnreg: 24 x 128 + 240 x 256 <= 65,536
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int tile_bytes() { return 64 * D * 2; }  // one 64-row 16-bit tile: D / 64 panels

// The PTX type of an element type in a wgmma instruction.
template <typename E>
__host__ __device__ constexpr bool is_half() { return std::is_same_v<E, __half>; }

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

// wgmma instruction wrappers: m64nNk16, E in (bf16 or f16), f32 accumulate. Each
// asm body is a macro of the PTX type, instanced per E.

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory, both K-major.
#define FLASH_WGMMA_SS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(accumulate));

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (E pairs), B in
// shared memory MN-major (transposed: N contiguous).
#define FLASH_WGMMA_RS_N64_TB(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (E pairs), B in
// shared memory MN-major (transposed: N contiguous).
#define FLASH_WGMMA_RS_N128_TB(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));

template <typename E>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (is_half<E>()) {
    FLASH_WGMMA_SS_N64("f16");
  } else {
    FLASH_WGMMA_SS_N64("bf16");
  }
}

template <typename E>
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (is_half<E>()) {
    FLASH_WGMMA_RS_N64_TB("f16");
  } else {
    FLASH_WGMMA_RS_N64_TB("bf16");
  }
}

template <typename E>
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (is_half<E>()) {
    FLASH_WGMMA_RS_N128_TB("f16");
  } else {
    FLASH_WGMMA_RS_N128_TB("bf16");
  }
}

template <typename E, int D>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64_tb<E>(d, a, db);
  } else {
    wgmma_rs_n128_tb<E>(d, a, db);
  }
}

// Accumulator fragment of a 64 x N f32 wgmma result, thread t of the
// warpgroup: element 4j + 2hh + e is row 16 (t / 32) + (t % 32) / 4 + 8 hh,
// column 8j + 2 (t % 4) + e. Its columns 16 kk .. 16 kk + 15, rounded to
// E, are exactly the register A operand of k-step kk.
template <typename E, int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&d)[N], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (is_half<E>()) {
      __half2 v = __floats2half2_rn(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
      a[i] = *reinterpret_cast<uint32_t*>(&v);
    } else {
      __nv_bfloat162 v = __floats2bfloat162_rn(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
      a[i] = *reinterpret_cast<uint32_t*>(&v);
    }
  }
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
// 8-byte (bf16, f16) load each where the bias's base and strides allow, else
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
// words of two bf16 or f16 each. They are converted to f32 only when stored to
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
    } else if constexpr (is_half<BT>()) {  // two f16 per word, converted
      v = make_float4(__half2float(__ushort_as_half((unsigned short)(r[2 * i] & 0xffffu))),
                      __half2float(__ushort_as_half((unsigned short)(r[2 * i] >> 16))),
                      __half2float(__ushort_as_half((unsigned short)(r[2 * i + 1] & 0xffffu))),
                      __half2float(__ushort_as_half((unsigned short)(r[2 * i + 1] >> 16))));
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

// Store an E pair at `p` (4-byte aligned: the wrappers require 16-byte
// aligned bases and strides).
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

// ---- host: tensor maps ------------------------------------------------------

// The tensor map of a 16-bit [b, s, h, d] operand (`dtype`: bf16 or f16) at `base` with element
// strides `st` (unit stride on d): 4-D over (d, h, s, b) with the operand's
// own byte strides (so a view of a packed [b, s, 3, h, d] projection needs
// no copy), 64 x 64 boxes (64 columns x 1 head x 64 rows x 1 batch), the
// 128-byte swizzle and zero fill past the edges. The wrappers check that
// the base and the strides of dims longer than 1 are 16-byte aligned, as
// TMA requires; a dim of length 1 is never stepped, so its stride is moot.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int b, int s, int h, int d,
                            Strides st,
                            CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t moot = 2ull * d;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {h > 1 ? 2ull * st.h : moot, s > 1 ? 2ull * st.s : moot,
                                 b > 1 ? 2ull * st.b : moot};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = encode(map, dtype, 4, const_cast<void*>(base),
                             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor-map element type of E.
template <typename E>
constexpr CUtensorMapDataType map_dtype() {
  return is_half<E>() ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

}  // namespace sm90
}  // namespace flash
