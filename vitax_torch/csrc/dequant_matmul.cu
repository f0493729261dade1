// Fused dequant matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces vitax/ops/dequant_matmul.py:dequant_matmul_kernel (the TPU
// kernel behind every quantized Dense site of the serve forward):
//
//   out[m, f] = (float(sum_k x[m, k] * W[f, k]) * sx) * s[f]     (f32 out)
//
// W is the stored int8 or float8 e4m3 weight in the port's (out, in)
// layout, s its per-output-channel f32 scale, sx the per-tensor activation
// scale (act mode) read from device memory. Three families:
// - weight-only, bf16 x (every site of the bf16 serve path, the head
//   included): every int8 value and every finite e4m3 value is exactly a
//   bf16, so the weight codes are converted to bf16 on the card and the
//   tensor cores run bf16 x bf16 with f32 accumulators. bf16 x bf16
//   products are exact in f32, so the result differs from the f32
//   reference only in summation order. The dequantized weight never
//   reaches device memory. sx is 1.
// - weight-only, f32 x: CUDA-core FMAs, exact f32 (the port's f32 checks).
// - act: int8 x int8 on the tensor cores, exact int32 sums (|acc| <= K *
//   127^2 < 2^31 for K <= 133,144, checked by the wrapper). The epilogue
//   spells both multiplies as rounded intrinsics in the reference's order,
//   so nvcc contracts nothing and it is bitwise equal to the plain version.
//
// What bounds it on the card: at the 10B serve shapes (M = 2048 rows of a
// bucket-8 batch, K x F = 5120 x 15360 ... 20480 x 5120) one call does
// 107-430 GFLOP against 26-150 MB, far above the H100's ~295 FLOP a byte:
// it is bound by operations (989 TFLOP/s bf16, 1979 TOP/s int8). The head
// (M = 1..8, F = 1000) is bound by its 5.2 MB of weight bytes.
//
// Two kernels; ops/dequant_matmul.py `choose_kernel` picks one from the
// shape, the types and the alignment, never on a failure:
// - wgmma (every main-path site), one CTA of three warpgroups an output
//   tile. Warpgroup 0 gives up its registers (setmaxnreg) and one of its
//   threads keeps a ring of shared-memory stages filled by TMA
//   (cp.async.bulk.tensor.2d, full/empty mbarriers); warpgroups 1 and 2
//   take 64 rows each of the first operand and run wgmma.mma_async with
//   the accumulators in registers. x arrives 128B-swizzled, 128 bytes of K a row. TMA zero-fills
//   rows past M and F and columns past K; the epilogue masks its stores.
//   TMA asks 16-byte-aligned bases and rows a multiple of 16 bytes: K % 16.
//   Two arrangements, each with 128 x 128 or 128 x 256 tiles:
//   * rs (weight-only, bf16 x): the swapped product out^T = W . x^T. Each
//     consumer thread converts the codes of its own A fragments (two W
//     rows, 32 codes a stage, read from a 64B-swizzled tile) into bf16
//     registers without going through float (int8: byte_perm into 0x43xx,
//     then (128 + low7) - (128 or 256) in bf16x2; e4m3: cvt to f16x2, the
//     bits shifted into the bf16 fields, times 2^112), and wgmma m64nNk16
//     takes A from registers and x's tile as B. Nothing converted touches
//     shared memory. (Converting into a swizzled bf16 tile in shared
//     memory for an all-shared-memory product took 27% (int8) and 33%
//     (e4m3) more time over a forward on an H100 80GB HBM3 at 700 W,
//     PERF.md: the tile's round trip nearly doubles the shared-memory
//     traffic a stage.)
//   * ss (act mode, int8 x): both int8 tiles arrive 128B-swizzled and go
//     from shared memory to wgmma m64nNk32 s8 as they are.
// - general (ragged K, misaligned bases, f32 x): 128 x 128 tiles per
//   256-thread CTA (8 warps of 64 x 32), mma.sync m16n8k16 bf16 or
//   m16n8k32 s8, k-tiles of 64 bytes a row double-buffered in shared
//   memory with the next tile's global loads held in registers across the
//   current tile's products, fragments read with 32-bit shared loads from
//   rows padded to 80 bytes. Tiles past M, F and K are zero-filled, so any
//   shape works.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>
#include <type_traits>

#include "hopper_common.cuh"

namespace {

using namespace vitax;

using bf16 = __nv_bfloat16;

enum XKind { X_BF16 = 0, X_F32 = 1, X_S8 = 2 };
enum WKind { W_S8 = 0, W_E4M3 = 1 };

constexpr int BM = 128, BN = 128, THREADS = 256;
constexpr int WARPS_N = 4;                 // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;            // warp tile
constexpr int MT = WM / 16, NT = WN / 8;   // mma tiles per warp
constexpr int ROW_BYTES = 64;              // a k-tile row: 32 bf16 or 64 int8
constexpr int SROW = ROW_BYTES + 16;       // padded shared row stride

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);    // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two stored weight codes (low 16 bits, lower k in the low byte) -> two
// bf16, exactly.
template <int WK>
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t two) {
  if constexpr (WK == W_S8) {
    return pack_bf16(static_cast<float>(static_cast<int8_t>(two & 0xffu)),
                     static_cast<float>(static_cast<int8_t>((two >> 8) & 0xffu)));
  } else {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(two & 0xffffu),
                                                     __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    return pack_bf16(f.x, f.y);
  }
}

template <int WK>
__device__ __forceinline__ float code_to_float(unsigned char c) {
  if constexpr (WK == W_S8) {
    return static_cast<float>(static_cast<int8_t>(c));
  } else {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(c), __NV_E4M3)));
  }
}

// 16 bytes of row `gr` (zero if gr >= rows) starting at element k of an
// ES-byte type; elements at or past K read as zero. `vec`: every row base
// is 16-byte aligned, so a chunk wholly inside K is one 16-byte load.
template <int ES>
__device__ __forceinline__ uint4 load_chunk(const unsigned char* base, int64_t row_bytes, int gr,
                                            int rows, int k, int K, bool vec) {
  constexpr int E = 16 / ES;
  if (gr >= rows) return make_uint4(0u, 0u, 0u, 0u);
  const unsigned char* p = base + (int64_t)gr * row_bytes + (int64_t)k * ES;
  if (vec && k + E <= K) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (k + e < K) {
      const uint32_t v = ES == 1 ? (uint32_t)p[e] : (uint32_t)*reinterpret_cast<const uint16_t*>(p + 2 * e);
      w[(e * ES) / 4] |= v << (8 * ((e * ES) % 4));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulators. Fragment
// layout (g = lane / 4, t = lane % 4): a = {(g, 2t..2t+1), (g+8, 2t..),
// (g, 2t+8..), (g+8, 2t+8..)}; b = {(k 2t..2t+1, n g), (k 2t+8.., n g)};
// d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a (16x32, row) * b (32x8, col), int8 in, int32 accumulators. Four
// k-consecutive bytes per register: a = {(g, 4t..4t+3), (g+8, 4t..),
// (g, 16+4t..), (g+8, 16+4t..)}; b = {(k 4t..4t+3, n g), (k 16+4t.., n g)};
// d as above.
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// The general kernel, tensor cores through mma.sync: weight-only bf16 (ACT
// false) and act int8 x int8 (ACT true), any shape
// ---------------------------------------------------------------------------

template <bool ACT>
struct TileRegs {
  // x: 128 rows x 4 chunks = 512 chunks, 2 a thread. W: act 128 x 4 chunks
  // (2 a thread), weight-only 128 rows x 2 chunks of 16 codes (1 a thread).
  static constexpr int WCH = ACT ? 2 : 1;
  uint4 x[2];
  uint4 w[WCH];
};

template <bool ACT>
__device__ __forceinline__ void load_tiles(TileRegs<ACT>& r, const unsigned char* x, const unsigned char* w,
                                           int m0, int n0, int k0, int M, int K, int F, bool vec_x,
                                           bool vec_w) {
  constexpr int XES = ACT ? 1 : 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int row = idx >> 2, c = idx & 3;
    r.x[i] = load_chunk<XES>(x, (int64_t)K * XES, m0 + row, M, k0 + c * (16 / XES), K, vec_x);
  }
#pragma unroll
  for (int i = 0; i < TileRegs<ACT>::WCH; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int row = ACT ? idx >> 2 : idx >> 1;
    const int c = ACT ? idx & 3 : idx & 1;
    r.w[i] = load_chunk<1>(w, K, n0 + row, F, k0 + c * 16, K, vec_w);
  }
}

template <bool ACT, int WK>
__device__ __forceinline__ void store_tiles(const TileRegs<ACT>& r, unsigned char* xs, unsigned char* ws) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    *reinterpret_cast<uint4*>(xs + (idx >> 2) * SROW + (idx & 3) * 16) = r.x[i];
  }
  if constexpr (ACT) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      *reinterpret_cast<uint4*>(ws + (idx >> 2) * SROW + (idx & 3) * 16) = r.w[i];
    }
  } else {
    // 16 codes -> 16 bf16 (32 bytes): the dequantized tile exists only here
    const int idx = threadIdx.x;
    const uint4 c = r.w[0];
    const uint4 lo = make_uint4(codes_to_bf16x2<WK>(c.x), codes_to_bf16x2<WK>(c.x >> 16),
                                codes_to_bf16x2<WK>(c.y), codes_to_bf16x2<WK>(c.y >> 16));
    const uint4 hi = make_uint4(codes_to_bf16x2<WK>(c.z), codes_to_bf16x2<WK>(c.z >> 16),
                                codes_to_bf16x2<WK>(c.w), codes_to_bf16x2<WK>(c.w >> 16));
    unsigned char* dst = ws + (idx >> 1) * SROW + (idx & 1) * 32;
    *reinterpret_cast<uint4*>(dst) = lo;
    *reinterpret_cast<uint4*>(dst + 16) = hi;
  }
}

template <bool ACT, int WK>
__global__ void __launch_bounds__(THREADS)
dequant_matmul_tc_kernel(const unsigned char* __restrict__ x, const unsigned char* __restrict__ w,
                         const float* __restrict__ scale, const float* __restrict__ sx,
                         float* __restrict__ out, int M, int K, int F, int vec_x, int vec_w) {
  using Acc = std::conditional_t<ACT, int, float>;
  constexpr int BK = ACT ? ROW_BYTES : ROW_BYTES / 2;   // k per tile
  __shared__ __align__(16) unsigned char Xs[2][BM * SROW];
  __shared__ __align__(16) unsigned char Ws[2][BN * SROW];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  Acc acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  TileRegs<ACT> regs;
  load_tiles<ACT>(regs, x, w, m0, n0, 0, M, K, F, vec_x, vec_w);
  store_tiles<ACT, WK>(regs, Xs[0], Ws[0]);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load_tiles<ACT>(regs, x, w, m0, n0, (kt + 1) * BK, M, K, F, vec_x, vec_w);
    const unsigned char* xs = Xs[buf];
    const unsigned char* ws = Ws[buf];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {     // two mma k-steps of 32 bytes a row
      const int kb = ks * 32 + 4 * t;
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned char* p = xs + (wm * WM + mt * 16 + g) * SROW + kb;
        a[mt][0] = lds32(p);
        a[mt][1] = lds32(p + 8 * SROW);
        a[mt][2] = lds32(p + 16);
        a[mt][3] = lds32(p + 8 * SROW + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned char* q = ws + (wn * WN + nt * 8 + g) * SROW + kb;
        b[nt][0] = lds32(q);
        b[nt][1] = lds32(q + 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], a[mt], b[nt]);
    }
    if (kt + 1 < nk) store_tiles<ACT, WK>(regs, Xs[buf ^ 1], Ws[buf ^ 1]);
    __syncthreads();
  }

  // epilogue: (float(acc) * sx) * s[f]; weight-only has sx = 1, exact
  const float sxv = ACT ? *sx : 1.f;
  const bool pairs = (F & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + wn * WN + nt * 8 + 2 * t;
    if (n >= F) continue;
    const bool two = n + 1 < F;
    const float s0 = scale[n];
    const float s1 = two ? scale[n + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * WM + mt * 16 + g + 8 * h;
        if (m >= M) continue;
        float v0, v1;
        if constexpr (ACT) {
          v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h]), sxv), s0);
          v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + 1]), sxv), s1);
        } else {
          v0 = __fmul_rn(acc[mt][nt][2 * h], s0);
          v1 = __fmul_rn(acc[mt][nt][2 * h + 1], s1);
        }
        float* o = out + (int64_t)m * F + n;
        if (two && pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (two) o[1] = v1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 x: CUDA cores, exact f32 FMAs
// ---------------------------------------------------------------------------

constexpr int FB = 64;    // 64 x 64 output tile, 4 x 4 per thread
constexpr int FK = 16;

template <int WK>
__global__ void __launch_bounds__(THREADS)
dequant_matmul_f32_kernel(const float* __restrict__ x, const unsigned char* __restrict__ w,
                          const float* __restrict__ scale, float* __restrict__ out, int M, int K, int F) {
  __shared__ float Xs[FK][FB + 4];     // k-major: a thread's 4 rows are adjacent
  __shared__ float Ws[FK][FB + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * FB, n0 = blockIdx.x * FB;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int i = threadIdx.x; i < FB * FK; i += THREADS) {
      const int row = i / FK, kk = i % FK;
      const int m = m0 + row, n = n0 + row, k = k0 + kk;
      Xs[kk][row] = (m < M && k < K) ? x[(int64_t)m * K + k] : 0.f;
      Ws[kk][row] = (n < F && k < K) ? code_to_float<WK>(w[(int64_t)n * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Xs[kk][ty * 4 + i];
        b[i] = Ws[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < F) out[(int64_t)m * F + n] = __fmul_rn(acc[i][j], scale[n]);
    }
  }
}

// ---------------------------------------------------------------------------
// The wgmma kernel: TMA-fed ring, warp-specialised, K % 16 == 0
// ---------------------------------------------------------------------------

#define ACC8(c, d, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define ACC32(c, d, i) ACC8(c, d, i), ACC8(c, d, i + 8), ACC8(c, d, i + 16), ACC8(c, d, i + 24)
#define ACC64(c, d) ACC32(c, d, 0), ACC32(c, d, 32)
#define ACC128(c, d) ACC32(c, d, 0), ACC32(c, d, 32), ACC32(c, d, 64), ACC32(c, d, 96)

// d (64 x N, s32) += A (64 x 32, s8, shared, descriptor da) * B (N x 32, s8,
// shared, descriptor db), both K-major. Register i of a thread holds row
// 16 * warp + lane / 4 + 8 * (i / 2 % 2), column 8 * (i / 4) + 2 * (lane %
// 4) + i % 2 (the mma.sync m16n8 layout, four warps stacked).
__device__ __forceinline__ void wgmma_s8_128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : ACC64("+r", d)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : ACC128("+r", d)
      : "l"(da), "l"(db), "r"(1));
}

// The same with A in registers (four bf16x2 a thread: rows g and g + 8 of
// its warp's 16, k 2t..2t+1 and 2t+8..2t+9, the mma.sync A layout).
__device__ __forceinline__ void wgmma_rs_128(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db) {
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : ACC64("+f", d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_256(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : ACC128("+f", d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Four weight codes (lower k in the lower byte) -> four bf16 in two words,
// exactly, without float arithmetic.
template <int WK>
__device__ __forceinline__ void codes4_to_bf16(uint32_t c, uint32_t& lo, uint32_t& hi) {
  if constexpr (WK == W_S8) {
    // byte b -> bf16 bits 0x43bb: 128 + (b & 127) in a, 128 or 256 (sign) in
    // b; a - b is the int8 value, exact (integers below 2^8 are bf16s).
    const uint32_t p0 = __byte_perm(c, 0x43434343u, 0x4140);
    const uint32_t p1 = __byte_perm(c, 0x43434343u, 0x4342);
    lo = bf16x2_sub(p0 & 0xff7fff7fu, p0 & 0xff80ff80u);
    hi = bf16x2_sub(p1 & 0xff7fff7fu, p1 & 0xff80ff80u);
  } else {
    // e4m3 -> f16 (exact, every nonzero value normal in f16); the f16 bits
    // shifted right by 3 are a bf16 with the f16's exponent field, so
    // 2^(e - 127) x 1.m; times 2^112 (bits 0x7780) is the value. Zero stays.
    const __half2_raw h0 = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(c & 0xffffu), __NV_E4M3);
    const __half2_raw h1 = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(c >> 16), __NV_E4M3);
    const uint32_t u0 = (uint32_t)h0.x | ((uint32_t)h0.y << 16);
    const uint32_t u1 = (uint32_t)h1.x | ((uint32_t)h1.y << 16);
    lo = bf16x2_mul(((u0 >> 3) & 0x0fff0fffu) | (u0 & 0x80008000u), 0x77807780u);
    hi = bf16x2_mul(((u1 >> 3) & 0x0fff0fffu) | (u1 & 0x80008000u), 0x77807780u);
  }
}

// The ring both arrangements share: STAGES stages of an x tile (X_BYTES,
// 1024-aligned for the 128B swizzle) and a W tile (W_BYTES), each with a
// full barrier (the producer's expect_tx, completed by TMA's bytes) and an
// empty one (one thread of each consumer warpgroup).
template <int STAGES, int X_BYTES, int W_BYTES>
struct Ring {
  static constexpr int SMEM = 1024 + STAGES * (X_BYTES + W_BYTES) + 2 * STAGES * 8;
  static_assert(STAGES >= 3, "the ring holds at least three stages");
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
  unsigned char* xs;
  unsigned char* ws;
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ explicit Ring(unsigned char* smem) {
    xs = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
    ws = xs + STAGES * X_BYTES;
    full = reinterpret_cast<uint64_t*>(ws + STAGES * W_BYTES);
    empty = full + STAGES;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 2);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
  }

  // The producer (one thread): nk stages of bk columns, x's box at row
  // x_row and W's at row w_row, each stage once its last readers let it go.
  __device__ __forceinline__ void produce(const CUtensorMap* tx, const CUtensorMap* tw, int x_row, int w_row, int nk,
                                          int bk) {
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
      mbar_expect_tx(&full[s], X_BYTES + W_BYTES);
      tma_load_2d(xs + s * X_BYTES, tx, kt * bk, x_row, &full[s]);
      tma_load_2d(ws + s * W_BYTES, tw, kt * bk, w_row, &full[s]);
    }
  }

  __device__ __forceinline__ void wait_full(int kt) { mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1); }
  __device__ __forceinline__ void release(int kt) { mbar_arrive(&empty[kt % STAGES]); }
};

// The ss epilogue's second half: a warpgroup's finished (ROWS x COLS) f32
// block, staged row-major in shared memory at a padded STRIDE, goes to
// out[(r0 + r) * F + c0 + c] in 16-byte pieces, each warp writing 512
// contiguous bytes; masked at M and F. (Stored straight from the
// accumulator layout, each warp instruction writes 32-byte runs of 8 rows:
// act mode over a forward took 17% more time that way on an H100 80GB HBM3
// at 700 W, PERF.md.) tid is the thread's index in its warpgroup.
template <int ROWS, int COLS, int STRIDE>
__device__ __forceinline__ void store_staged(const float* st, float* out, int r0, int c0, int M, int F, int tid) {
  constexpr int Q = COLS / 4;
  const bool vec = (F & 3) == 0;
#pragma unroll 4
  for (int i = tid; i < ROWS * Q; i += 128) {
    const int r = i / Q, q = i % Q;
    const int m = r0 + r, n = c0 + 4 * q;
    if (m >= M || n >= F) continue;
    const float4 v = *reinterpret_cast<const float4*>(st + r * STRIDE + 4 * q);
    float* o = out + (int64_t)m * F + n;
    if (vec) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      o[0] = v.x;
      if (n + 1 < F) o[1] = v.y;
      if (n + 2 < F) o[2] = v.z;
      if (n + 3 < F) o[3] = v.w;
    }
  }
}

// ss, act mode: both int8 tiles, 128 bytes of K a row and 128B-swizzled,
// straight from the ring into wgmma m64nNk32 s8.
template <int BN_>
struct SsCfg {
  static constexpr int BM = 128, BN = BN_, BK = 128;
  static constexpr int X_BYTES = BM * BK, W_BYTES = BN * BK;
  static constexpr int STAGES = 229376 / (X_BYTES + W_BYTES) < 6 ? 229376 / (X_BYTES + W_BYTES) : 6;
  using R = Ring<STAGES, X_BYTES, W_BYTES>;
  static_assert(2 * 64 * (BN + 8) * 4 <= STAGES * (X_BYTES + W_BYTES), "the epilogue's staging fits the ring");
};

template <int BN>
__global__ void __launch_bounds__(384, 1)
dequant_matmul_wgmma_ss_kernel(const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ CUtensorMap tmap_w,
                               const float* __restrict__ scale, const float* __restrict__ sx,
                               float* __restrict__ out, int M, int K, int F) {
  using C = SsCfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  typename C::R ring(smem_raw);
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * BN;   // M tiles fastest: a wave shares W tiles
  const int nk = (K + C::BK - 1) / C::BK;

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) ring.produce(&tmap_x, &tmap_w, m0, n0, nk, C::BK);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x - 128;            // 0..255
    const int c = ct >> 7;                       // rows 64c .. 64c + 63 of the tile
    const int lane = ct & 31, warp = (ct >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    pin(acc);
    for (int kt = 0; kt < nk; ++kt) {
      ring.wait_full(kt);
      const int s = kt % C::STAGES;
      const uint64_t da = sw128_desc(ring.xs + s * C::X_BYTES + c * 64 * 128);
      const uint64_t db = sw128_desc(ring.ws + s * C::W_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)          // 32 bytes of K a step: +2 in the address field
        if constexpr (BN == 256)
          wgmma_s8_256(acc, da + 2 * kk, db + 2 * kk);
        else
          wgmma_s8_128(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();                        // stage kt - 1's products are done: free it
      pin(acc);
      if (kt > 0 && (ct & 127) == 0) ring.release(kt - 1);
    }
    wgmma_wait<0>();
    pin(acc);

    // epilogue: (float(acc) * sx) * s[f], rounded in the reference's order,
    // staged through the ring's shared memory once both warpgroups are done
    // with it
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    constexpr int STRIDE = BN + 8;            // a warp's float2 writes hit every bank once per half
    float* st = reinterpret_cast<float*>(ring.xs) + c * 64 * STRIDE;
    const float sxv = *sx;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      const float s0 = n < F ? scale[n] : 0.f;
      const float s1 = n + 1 < F ? scale[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sxv), s0);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sxv), s1);
        *reinterpret_cast<float2*>(st + (16 * warp + g + 8 * h) * STRIDE + 8 * j + 2 * t) = make_float2(v0, v1);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
    store_staged<64, BN, STRIDE>(st, out, m0 + 64 * c, n0, M, F, ct & 127);
  }
}

// rs, weight-only: the swapped product out^T = W . x^T. The codes arrive
// 64B-swizzled, 64 a row; each consumer thread converts the codes of its own
// A fragments (two W rows, 32 codes a stage) straight into registers, and
// wgmma reads x's TMA tile as B. Nothing converted goes through shared
// memory; each warpgroup works alone on its 64 W rows. A thread's fragment
// registers must stay put until the products reading them are done, so two
// sets alternate, each pinned until the wait that retires its products.
template <int BN_>
struct RsCfg {
  static constexpr int BF = 128, BN = BN_, BK = 64;      // W rows, x rows (wgmma N), k a stage
  static constexpr int X_BYTES = BN * 128;             // x tile, 128B-swizzled
  static constexpr int W_BYTES = BF * 64;              // codes, 64B-swizzled
  static constexpr int STAGES = 229376 / (X_BYTES + W_BYTES) < 8 ? 229376 / (X_BYTES + W_BYTES) : 8;
  using R = Ring<STAGES, X_BYTES, W_BYTES>;
};

template <int WK, int BN>
__global__ void __launch_bounds__(384, 1)
dequant_matmul_wgmma_rs_kernel(const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ CUtensorMap tmap_w,
                               const float* __restrict__ scale, float* __restrict__ out, int M, int K, int F) {
  using C = RsCfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  typename C::R ring(smem_raw);
  const int m0 = blockIdx.x * BN, f0 = blockIdx.y * C::BF;   // x tiles fastest: a wave shares W tiles
  const int nk = (K + C::BK - 1) / C::BK;

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) ring.produce(&tmap_x, &tmap_w, m0, f0, nk, C::BK);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x - 128;
    const int c = ct >> 7, lane = ct & 31, warp = (ct >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = 64 * c + 16 * warp + g;                   // this thread's W rows r0, r0 + 8 of the tile
    const uint32_t pick = (t & 1) ? 0x7632u : 0x5410u;
    float acc[BN / 2];
    uint32_t fa[16], fb[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) fb[i] = 0u;

    auto stage = [&](int kt, uint32_t (&a)[16], uint32_t (&prev)[16]) {
      ring.wait_full(kt);
      const int s = kt % C::STAGES;
      const unsigned char* wt = ring.ws + s * C::W_BYTES;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {         // 16 codes: k16 step ch
          const uint4 v = *reinterpret_cast<const uint4*>(wt + r * 64 + ((ch ^ ((r >> 1) & 3)) << 4));
          const uint32_t c4 = __byte_perm((t & 2) ? v.y : v.x, (t & 2) ? v.w : v.z, pick);
          codes4_to_bf16<WK>(c4, a[4 * ch + h], a[4 * ch + 2 + h]);
        }
      }
      const uint64_t db = sw128_desc(ring.xs + s * C::X_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (BN == 256)
          wgmma_rs_256(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], db + 2 * kk);
        else
          wgmma_rs_128(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], db + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();                           // stage kt - 1's products are done
      pin(acc);
      pin(prev);                                 // ... so its fragments may be overwritten
      if (kt > 0 && (ct & 127) == 0) ring.release(kt - 1);
    };
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    pin(acc);
    for (int kt = 0; kt < nk; kt += 2) {
      stage(kt, fa, fb);
      if (kt + 1 < nk) stage(kt + 1, fb, fa);
    }
    wgmma_wait<0>();
    pin(acc);
    pin(fa);
    pin(fb);

    // epilogue: out[m, f] = acc * s[f]; this thread holds W rows f, f + 8
    // and x rows 8j + 2t + e. Stored straight from the registers: each warp
    // instruction writes 32-byte runs of 4 rows (staging through shared
    // memory, as the ss kernel does, measured slower here).
    const int f = f0 + r0;
    const float s0 = f < F ? scale[f] : 0.f;
    const float s1 = f + 8 < F ? scale[f + 8] : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        if (m >= M) continue;
        float* o = out + (int64_t)m * F + f;
        if (f < F) o[0] = __fmul_rn(acc[4 * j + e], s0);
        if (f + 8 < F) o[8] = __fmul_rn(acc[4 * j + 2 + e], s1);
      }
    }
  }
}

// A row-major (rows, cols) matrix of `es`-byte elements, boxes of (box_rows,
// box_cols), zeros out of bounds.
bool encode_2d(CUtensorMap* map, const void* base, int es, int rows, int cols, int box_rows, int box_cols,
               CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || !context_current(base)) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * es};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
            const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch_ss(const void* x, const void* w, const float* scale, const float* sx, float* out, int M, int K, int F,
              cudaStream_t st) {
  using C = SsCfg<BN>;
  CUtensorMap tx, tw;
  if (!encode_2d(&tx, x, 1, M, K, C::BM, C::BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&tw, w, 1, F, K, BN, C::BK, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorNotSupported;
  static const cudaError_t attr = cudaFuncSetAttribute(dequant_matmul_wgmma_ss_kernel<BN>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::R::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((M + C::BM - 1) / C::BM, (F + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  dequant_matmul_wgmma_ss_kernel<BN><<<grid, 384, C::R::SMEM, st>>>(tx, tw, scale, sx, out, M, K, F);
  return (int)cudaGetLastError();
}

template <int WK, int BN>
int launch_rs(const void* x, const void* w, const float* scale, float* out, int M, int K, int F, cudaStream_t st) {
  using C = RsCfg<BN>;
  CUtensorMap tx, tw;
  if (!encode_2d(&tx, x, 2, M, K, BN, C::BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&tw, w, 1, F, K, C::BF, C::BK, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorNotSupported;
  static const cudaError_t attr = cudaFuncSetAttribute(dequant_matmul_wgmma_rs_kernel<WK, BN>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::R::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((M + BN - 1) / BN, (F + C::BF - 1) / C::BF);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  dequant_matmul_wgmma_rs_kernel<WK, BN><<<grid, 384, C::R::SMEM, st>>>(tx, tw, scale, out, M, K, F);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// out (M, F) f32 = epilogue(x (M, K) @ W (F, K)^T). x_kind: 0 bfloat16,
// 1 float32, 2 int8 (act mode: W must be int8 and sx a device float32
// scalar); w_kind: 0 int8, 1 float8 e4m3 (bits). kernel: 0 the general
// kernel; the wgmma kernel, ss arrangement (int8 x) with 128 x 128 (1) or
// 128 x 256 (2) tiles, rs arrangement (bfloat16 x) with 128 x 128 (3) or
// 256 x 128 (4) tiles. The wgmma kernel needs 16-byte-aligned x and w and
// K % 16 == 0; anything else is refused, never sent elsewhere.
// Every operand contiguous on the card; scale (F,) float32. Returns a
// cudaError_t (0 = success); the launch is asynchronous on `stream`.
int vitax_dequant_matmul(const void* x, int x_kind, const void* w, int w_kind, const float* scale,
                         const float* sx, float* out, int M, int K, int F, int kernel, void* stream) {
  if (M < 1 || K < 1 || F < 1 || (w_kind != W_S8 && w_kind != W_E4M3)) return (int)cudaErrorInvalidValue;
  if (x_kind == X_S8 && (w_kind != W_S8 || sx == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const unsigned char*>(x);
  const auto* wb = static_cast<const unsigned char*>(w);
  if (kernel == 1 || kernel == 2 || kernel == 3 || kernel == 4) {
    if (!aligned16(x) || !aligned16(w) || K % 16 != 0) return (int)cudaErrorInvalidValue;
    if (kernel <= 2) {                                   // ss: act mode
      if (x_kind != X_S8) return (int)cudaErrorInvalidValue;
      return kernel == 2 ? launch_ss<256>(x, w, scale, sx, out, M, K, F, st)
                         : launch_ss<128>(x, w, scale, sx, out, M, K, F, st);
    }
    if (x_kind != X_BF16) return (int)cudaErrorInvalidValue;     // rs: weight-only
    if (w_kind == W_E4M3)
      return kernel == 4 ? launch_rs<W_E4M3, 256>(x, w, scale, out, M, K, F, st)
                         : launch_rs<W_E4M3, 128>(x, w, scale, out, M, K, F, st);
    return kernel == 4 ? launch_rs<W_S8, 256>(x, w, scale, out, M, K, F, st)
                       : launch_rs<W_S8, 128>(x, w, scale, out, M, K, F, st);
  }
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  if (x_kind == X_F32) {
    const dim3 grid((F + FB - 1) / FB, (M + FB - 1) / FB);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const auto* xf = static_cast<const float*>(x);
    if (w_kind == W_S8)
      dequant_matmul_f32_kernel<W_S8><<<grid, THREADS, 0, st>>>(xf, wb, scale, out, M, K, F);
    else
      dequant_matmul_f32_kernel<W_E4M3><<<grid, THREADS, 0, st>>>(xf, wb, scale, out, M, K, F);
    return (int)cudaGetLastError();
  }
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int vec_w = aligned16(w) && K % 16 == 0;
  if (x_kind == X_S8) {
    const int vec_x = aligned16(x) && K % 16 == 0;
    dequant_matmul_tc_kernel<true, W_S8><<<grid, THREADS, 0, st>>>(xb, wb, scale, sx, out, M, K, F, vec_x, vec_w);
  } else if (x_kind == X_BF16) {
    const int vec_x = aligned16(x) && K % 8 == 0;
    if (w_kind == W_S8)
      dequant_matmul_tc_kernel<false, W_S8><<<grid, THREADS, 0, st>>>(xb, wb, scale, sx, out, M, K, F, vec_x, vec_w);
    else
      dequant_matmul_tc_kernel<false, W_E4M3><<<grid, THREADS, 0, st>>>(xb, wb, scale, sx, out, M, K, F, vec_x, vec_w);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* vitax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
