// The wgmma products and shared tile layout of the flash-attention kernels
// for Hopper (flash_attn_fwd.cu, flash_attn_bwd.cu): a 64-row warpgroup
// product with both bf16 operands in shared memory, one with A in registers
// and B read MN-major, the exponential they put the softmax scale into, and
// the byte offset of an element in a TMA-swizzled tile. Each kernel source
// is its own shared library; this header is compiled into each of them.

#pragma once

#include "hopper_common.cuh"

namespace vitax {

#define ACC8(c, d, i) \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), c(d[i + 7])

// d (64 x N, f32) (+)= A (64 x 16) * B (N x 16)^T, A and B bf16 in shared
// memory, both K-major; scale_d 0 overwrites d. Register i of a thread holds
// row 16 * warp + lane / 4 + 8 * (i / 2 % 2), column 8 * (i / 4) + 2 *
// (lane % 4) + i % 2 (the mma.sync m16n8 layout, four warps stacked).
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

// d (64 x N, f32) += A (64 x 16, bf16 in registers: four bf16x2 a thread,
// rows g and g + 8 of its warp's 16, k 2t..2t+1 and 2t+8..2t+9, the
// mma.sync A layout) * B (16 x N, bf16 in shared memory, MN-major: N
// contiguous, the transpose bit set).
template <int N>
__device__ void wgmma_rs_vt(float (&d)[N / 2], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                            uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC8("+f", d, 0), ACC8("+f", d, 8)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8("+f", d, 0), ACC8("+f", d, 8), ACC8("+f", d, 16), ACC8("+f", d, 24)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8("+f", d, 0), ACC8("+f", d, 8), ACC8("+f", d, 16), ACC8("+f", d, 24),
        ACC8("+f", d, 32), ACC8("+f", d, 40), ACC8("+f", d, 48), ACC8("+f", d, 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_vt<64>(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8("+f", d, 0), ACC8("+f", d, 8), ACC8("+f", d, 16), ACC8("+f", d, 24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_vt<128>(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8("+f", d, 0), ACC8("+f", d, 8), ACC8("+f", d, 16), ACC8("+f", d, 24),
        ACC8("+f", d, 32), ACC8("+f", d, 40), ACC8("+f", d, 48), ACC8("+f", d, 56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_vt<160>(float (&d)[80], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : ACC8("+f", d, 0), ACC8("+f", d, 8), ACC8("+f", d, 16), ACC8("+f", d, 24),
        ACC8("+f", d, 32), ACC8("+f", d, 40), ACC8("+f", d, 48), ACC8("+f", d, 56),
        ACC8("+f", d, 64), ACC8("+f", d, 72)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef ACC8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;

// Byte offset of element (row, col) in a tile of ROWS rows stored as TMA
// boxes of SW-byte rows (box j holds columns [j SW/2, (j + 1) SW/2)), with
// TMA's swizzle: the 16-byte chunk index XOR the row within the swizzle
// atom (offset bits [4, 7) ^ [7, 10), as many bits as an SW row has chunks).
// The tile starts 1024-aligned.
template <int SW, int ROWS>
__device__ __forceinline__ uint32_t tile_off(int row, int col) {
  constexpr int BC = SW / 2;
  const uint32_t off = (uint32_t)((col / BC) * ROWS * SW + row * SW + (col % BC) * 2);
  return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

}  // namespace vitax
