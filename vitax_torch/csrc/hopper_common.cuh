// Hopper (sm_90a) helpers shared by the wgmma kernels (dequant_matmul.cu,
// flash_attn_fwd.cu, flash_attn_bwd.cu): shared-memory addresses and wgmma
// matrix descriptors, mbarriers, TMA tile loads, the wgmma fence / commit /
// wait and the register pin that keeps the compiler off registers an
// asynchronous product still reads or writes, the tensor-map encoder of
// the CUDA driver API, and the 4-D maps over strided (B, N, H, Dh) views. Each
// kernel source is its own shared library; this header is compiled into
// each of them.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace vitax {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A K-major operand tile of 128-byte rows, 128B-swizzled, 8-row groups 1024
// bytes apart (SBO 64), the leading offset unused in this layout (LBO 1).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of a 2-D tensor map (inner coordinate c0, outer c1) into shared
// memory; completion is counted in bytes on `bar`. Out-of-bounds elements
// arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers across the asynchronous products: the compiler may neither
// read nor move them past a wgmma fence or wait.
template <typename T, int R>
__device__ __forceinline__ void pin(T (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (std::is_same_v<T, float>)
      asm volatile("" : "+f"(r[i])::"memory");
    else
      asm volatile("" : "+r"(r[i])::"memory");
  }
}

// A wgmma matrix descriptor: shared address, leading and stride byte
// offsets, and the swizzle of a TMA tile of SW-byte rows (128, 64 or 32).
// K-major operands (rows of K): SBO is the 8-row group stride, LBO unused
// (1). MN-major operands (rows of K, N contiguous, e.g. V read as B): LBO is
// the stride between SW-byte column blocks of N, SBO the 8-row group stride
// along K.
template <int SW>
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  static_assert(SW == 128 || SW == 64 || SW == 32, "a TMA swizzle span");
  constexpr uint64_t mode = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (mode << 62);
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completion counted in bytes on `bar`; out-of-bounds elements
// arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links no libcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A bf16 (B, N, H, Dh) view as a 4-D tensor map (Dh, H, N, B) (element
// strides s_h, s_n, s_b), boxes of (SW / 2, 1, rows, 1), SW-swizzled, zeros
// out of bounds. A dimension of size 1 is never stepped along; it gets the
// packed stride, so its own (any value) never meets TMA's rules.
template <int SW>
bool encode_view(CUtensorMap* map, const void* base, int dh, int H, int N, int B, int64_t s_b, int64_t s_n,
                 int64_t s_h, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  if (H == 1) s_h = dh;
  if (N == 1) s_n = s_h * H;
  if (B == 1) s_b = s_n * N;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_n * 2, (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {SW / 2, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What TMA asks of n (B, N, H, Dh) views (element strides (batch, sequence,
// head) of view i at st[3 i]): 16-byte-aligned bases, and every stride of a
// dimension longer than 1 a multiple of 8 elements (16 bytes).
inline bool tma_takes(const void* const* ptrs, int n, const int64_t* st, int B, int N, int H) {
  const int sizes[3] = {B, N, H};
  for (int i = 0; i < n; ++i) {
    if ((reinterpret_cast<uintptr_t>(ptrs[i]) & 15u) != 0) return false;
    for (int a = 0; a < 3; ++a)
      if (sizes[a] > 1 && st[3 * i + a] % 8 != 0) return false;
  }
  return true;
}

}  // namespace vitax
