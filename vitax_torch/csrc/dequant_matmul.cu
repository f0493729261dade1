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
//   bf16, so the weight tile is converted to bf16 in registers between its
//   global load and its shared-memory store, and mma.sync m16n8k16 bf16
//   runs with f32 accumulators. bf16 x bf16 products are exact in f32, so
//   the result differs from the f32 reference only in summation order. The
//   dequantized weight never reaches device memory. sx is 1.
// - weight-only, f32 x: CUDA-core FMAs, exact f32 (the port's f32 checks).
// - act: int8 x int8 through mma.sync m16n8k32 s8.s8.s32, exact int32 sums
//   (|acc| <= K * 127^2 < 2^31 for K <= 133,144, checked by the wrapper).
//   The epilogue spells both multiplies as rounded intrinsics in the
//   reference's order, so nvcc contracts nothing and it is bitwise equal
//   to the plain version.
//
// What bounds it on the card: at the 10B serve shapes (M = 2048 rows of a
// bucket-8 batch, K x F = 5120 x 15360 ... 20480 x 5120) one call does
// 107-430 GFLOP against 26-150 MB, far above the H100's ~295 FLOP a byte:
// it is bound by operations (989 TFLOP/s bf16, 1979 TOP/s int8). The head
// (M = 1..8, F = 1000) is bound by its 5.2 MB of weight bytes. The design
// is a simple, right one: 128 x 128 output tiles per 256-thread CTA (8
// warps of 64 x 32), k-tiles of 64 bytes a row double-buffered in shared
// memory with the next tile's global loads held in registers across the
// current tile's products, fragments read with 32-bit shared loads from
// rows padded to 80 bytes (a warp's 8 rows x 4 lanes hit 32 distinct
// banks). Tiles past M, F and K are zero-filled, so any shape works.
// wgmma, TMA and a deeper ring are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>
#include <type_traits>

namespace {

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
// Tensor cores: weight-only bf16 (ACT false) and act int8 x int8 (ACT true)
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// out (M, F) f32 = epilogue(x (M, K) @ W (F, K)^T). x_kind: 0 bfloat16,
// 1 float32, 2 int8 (act mode: W must be int8 and sx a device float32
// scalar); w_kind: 0 int8, 1 float8 e4m3 (bits). Every operand contiguous
// on the card; scale (F,) float32. Returns a cudaError_t (0 = success); the
// launch is asynchronous on `stream`.
int vitax_dequant_matmul(const void* x, int x_kind, const void* w, int w_kind, const float* scale,
                         const float* sx, float* out, int M, int K, int F, void* stream) {
  if (M < 1 || K < 1 || F < 1 || (w_kind != W_S8 && w_kind != W_E4M3)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const unsigned char*>(x);
  const auto* wb = static_cast<const unsigned char*>(w);
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
    if (w_kind != W_S8 || sx == nullptr) return (int)cudaErrorInvalidValue;
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
