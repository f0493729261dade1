// Helpers shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): bf16 tensor-core fragments through mma.sync
// m16n8k16, 64-row tile copies from strided (B, N, H, Dh) views into
// shared memory, and the attention-dropout keep decision. Each kernel
// source is its own shared library; this header is compiled into each of
// them.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace vitax {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;        // sequence rows per tile (queries or keys)

// Shared row stride of a bf16 tile: DH + 8 keeps the 4-byte fragment loads
// of a warp's 8 row groups, and the eight 16-byte rows of an ldmatrix
// phase, on distinct banks.
template <int DH>
__host__ __device__ constexpr int tc_row_stride() { return DH + 8; }

// Shared row stride of a float32 tile: DH + 4 keeps rows 16-byte aligned
// and spreads the 8 rows a warp reads over all banks.
template <int DH>
__host__ __device__ constexpr int f32_row_stride() { return DH + 4; }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 matrices from shared memory, each transposed on the way in;
// lane L passes the address of row L % 8 of matrix L / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);    // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col), bf16 inputs, f32 accumulators.
// Fragment layout (g = lane / 4, t = lane % 4): a = {(g, 2t..2t+1),
// (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}; b = {(k 2t..2t+1, n g),
// (k 2t+8.., n g)}; d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy TILE sequence rows from n0 into shared memory as [row][d] with the
// padded row stride, zero past N. `vec` means 16-byte aligned rows (8
// elements per load).
template <int DH, int THREADS>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* base, int64_t s_n, int n0,
                                               int N, bool vec) {
  constexpr int DS = tc_row_stride<DH>();
  if (vec) {
    constexpr int C = DH / 8;
    for (int i = threadIdx.x; i < TILE * C; i += THREADS) {
      const int row = i / C;
      const int c = i - row * C;
      const int n = n0 + row;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n < N) val = *reinterpret_cast<const uint4*>(base + (int64_t)n * s_n + c * 8);
      *reinterpret_cast<uint4*>(dst + row * DS + c * 8) = val;
    }
  } else {
    for (int i = threadIdx.x; i < TILE * DH; i += THREADS) {
      const int row = i / DH;
      const int d = i - row * DH;
      const int n = n0 + row;
      dst[row * DS + d] = n < N ? base[(int64_t)n * s_n + d] : __float2bfloat16(0.f);
    }
  }
}

template <int DH, int THREADS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* base, int64_t s_n, int n0, int N) {
  constexpr int KS = f32_row_stride<DH>();
  for (int i = threadIdx.x; i < TILE * DH; i += THREADS) {
    const int row = i / DH;
    const int d = i - row * DH;
    const int n = n0 + row;
    dst[row * KS + d] = n < N ? base[(int64_t)n * s_n + d] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Attention dropout: the counter hash of vitax/ops/attention.py
// dropout_keep_mask (:78-132). Score element (q, k) of block bh (b * H + h
// with the call's whole head count) is kept when
//   fmix32(fmix32(((q + q0) * GOLD_Q + (k + k0) * GOLD_K + bh * GOLD_BH) ^ seed))
//     >= threshold
// in uint32 arithmetic, with threshold = min(int(rate * 2^32), 2^32 - 1)
// computed on the host as the JAX package does. A kernel sums the terms it
// hoists out of its loops (the row's q or k term and the bh term) once per
// row, and adds the other per element: two fmix32 and a compare. Compiled
// (sm_90a SASS), an element takes about 12 ALU-pipe instructions (4 SHF,
// 5 LOP3, the ISETP, the mask's select) and 4 IMADs on the FMA pipe: the
// compiler cancels the first fmix32's last xor-shift against the second's
// first and folds the two multiplies left adjacent into one. Bit identity
// with the JAX package forbids sharing one hash among several elements.
// ---------------------------------------------------------------------------

constexpr uint32_t FMIX_C1 = 0x85EBCA6Bu;
constexpr uint32_t FMIX_C2 = 0xC2B2AE35u;
constexpr uint32_t GOLD_Q = 0x9E3779B1u;
constexpr uint32_t GOLD_K = 0x85EBCA77u;
constexpr uint32_t GOLD_BH = 0xC2B2AE3Du;

struct Dropout {
  uint32_t seed, q0, k0, threshold;
  float keep_prob;        // float32(1 - rate): o = acc / (l * keep_prob)
  float inv_keep_prob;    // 1 / keep_prob rounded to float32: a kept element's mask / (1 - rate)
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= FMIX_C1;
  x ^= x >> 13;
  x *= FMIX_C2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t drop_q_term(const Dropout& d, int q) { return ((uint32_t)q + d.q0) * GOLD_Q; }
__device__ __forceinline__ uint32_t drop_k_term(const Dropout& d, int k) { return ((uint32_t)k + d.k0) * GOLD_K; }
__device__ __forceinline__ uint32_t drop_bh_term(int bh) { return (uint32_t)bh * GOLD_BH; }

// The keep decision for the element whose terms sum to x (the q term, the
// k term and the bh term).
__device__ __forceinline__ bool drop_keep(const Dropout& d, uint32_t x) {
  return fmix32(fmix32(x ^ d.seed)) >= d.threshold;
}

// 16-byte row loads need every base 16-byte aligned and every stride a
// multiple of 8 elements (true of slices of a fresh qkv projection).
inline bool rows_vectorizable(const void* const* ptrs, int n_ptrs, const int64_t* strides, int n_strides) {
  uintptr_t bits = 0;
  for (int i = 0; i < n_ptrs; ++i) bits |= reinterpret_cast<uintptr_t>(ptrs[i]);
  bool ok = (bits % 16) == 0;
  for (int i = 0; i < n_strides; ++i) ok = ok && (strides[i] % 8 == 0);
  return ok;
}

}  // namespace vitax
