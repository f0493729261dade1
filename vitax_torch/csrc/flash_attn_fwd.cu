// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces vitax/ops/attention.py:_fwd4_kernel (the TPU kernel behind
// flash4_with_lse): per (batch, head), o = softmax(q k^T * scale) v and the
// row logsumexp lse = m + log(l), in float32. With the DROP template flag it
// replaces _fwd4_kernel_drop (and, on (B*H, N, 1, Dh) views, the BH kernels
// _fwd_kernel and _fwd_kernel_drop): attention dropout on the softmax
// probabilities, o = (P * mask) v / (l * (1 - rate)), with the keep-mask of
// the counter hash in flash_common.cuh. The online softmax keeps m and l
// unmasked; only the PV accumulator takes the masked P, so lse stays
// m + log(l) of the unmasked scores, as in the JAX kernels. Past 2048
// tokens the same kernels serve the streaming entries (ops/flash_blocked.py,
// the counterpart of vitax/ops/flash_blocked.py:_fwd_kernel).
//
// What bounds it on the card: at the 10B serve shape (B=8, N=256, H=32,
// Dh=160, bf16) the call does 10.74 GFLOP against 84.1 MB of q, k, v, o and
// lse traffic, 128 FLOP per byte, below the H100's ~295 in bf16: it is
// memory-bound. At the long-context shape (N 4096 and 9216, Dh 64) it does
// N/16 FLOP a byte and is bound by the tensor cores (989 TFLOP/s bf16), and
// at Dh 64 nearly as much by the exponentials (one MUFU op a score, 16 a
// clock an SM). The design keeps the (N, N) scores out of device memory:
// each CTA owns a query tile, streams K/V tiles through shared memory and
// keeps the running max m, the running sum l and the f32 output
// accumulator on chip (online softmax), dividing by l once at the end.
//
// q, k, v are strided (B, N, H, Dh) views (the model passes slices of the
// (B, N, 3, H, Dh) qkv projection output, never copied); the last axis must
// be contiguous. o is written contiguous (B, N, H, Dh) in the input type,
// lse contiguous (B, H, N) in float32. Any N >= 1 works: rows and key
// columns past N are masked.
//
// Three kernels; ops/attention.py `choose_fwd_kernel` picks one from the
// type, the head dim, the alignment, the strides and the scale's sign,
// never on a failure:
// - wgmma (bfloat16, Dh 64, 128 and 160, scale > 0: every main path), one
//   CTA of three warpgroups a 128-query tile of one (b, h). Warpgroup 0
//   gives up its registers (setmaxnreg) and one of its threads loads Q once
//   and keeps a ring of K/V stages filled by TMA (4-D tensor maps over the
//   strided views: no copy; full barriers for K and V apart, one empty
//   barrier a stage). Warpgroups 1 and 2 take 64 query rows each: S = Q K^T
//   by wgmma m64nBNk16 from shared memory (both K-major), the online
//   softmax in registers, then O += P V by wgmma with P straight from the
//   score registers (a chunk of S's accumulators packed to bf16 pairs is the
//   A fragment of a k16 step) and V read as it was loaded, keys by rows
//   with Dh contiguous: wgmma's MN-major B. Dh 64 and 128 arrive in boxes of
//   64 columns with TMA's 128-byte swizzle, Dh 160 in five boxes of 32
//   with the 64-byte swizzle (no padding to 192). The output goes through
//   the warpgroup's own rows of the Q tile to 16-byte row stores. The two
//   consumer warpgroups run unsynchronised, so one's softmax and hash run
//   under the other's products. The max is taken on the raw scores and the
//   scale goes into the exponent (2^x, one FFMA a score), hence scale > 0.
//   Tiles, swizzle and the loop were chosen by measurement (PERF.md): a
//   pipelined loop with warpgroup ping-pong and three consumer warpgroups
//   measured no better on an H100 80GB HBM3 at 700 W.
// - general bfloat16 (other head dims, misaligned bases or strides):
//   tensor cores through mma.sync m16n8k16 with f32 accumulation; 4 warps,
//   16 query rows each, 64-key tiles loaded synchronously into padded
//   shared rows; V read with ldmatrix.trans as the PV product's B operand.
// - float32: CUDA-core FMAs from shared memory, exact f32 throughout.
// Numerics: A1 normalises P before the PV product; these kernels divide by
// l after it (and round the unnormalised P to bf16 for the bf16 products),
// which differs by about one bf16 ulp of the output.
//
// Dropout costs integer instructions: each score element needs its own hash
// (two fmix32; compiled, about 12 ALU-pipe instructions beside 4 IMADs on
// the FMA pipe), 0.79 G ALU instructions at the train shape, under the
// call's bytes bound on the card's ALU lanes.
// The row's hash terms are computed once per row; the per-element part sits
// in the softmax loop, after the row sum, where P is cleared for dropped
// keys. At long N the wgmma kernel under dropout runs at that INT32 floor.

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace vitax;

constexpr int BM = TILE;        // query rows per CTA
constexpr int BN = TILE;        // key rows per K/V tile

// ---------------------------------------------------------------------------
// bfloat16, the general kernel: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps x 16 query rows

template <int DH>
constexpr size_t tc_smem_bytes() {
  return (size_t)(3 * 64 * tc_row_stride<DH>()) * sizeof(bf16);
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(TC_THREADS)
flash_attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int N, int H,
                           int64_t q_sb, int64_t q_sn, int64_t q_sh,
                           int64_t k_sb, int64_t k_sn, int64_t k_sh,
                           int64_t v_sb, int64_t v_sn, int64_t v_sh,
                           float scale, int vec, Dropout drop) {
  static_assert(DH % 16 == 0, "head dim must be a multiple of the mma k-step (16)");
  constexpr int DS = tc_row_stride<DH>();
  constexpr int NT_S = BN / 8;         // score n-tiles per key tile
  constexpr int NT_O = DH / 8;         // output n-tiles

  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* Ks = Qs + 64 * DS;
  bf16* Vs = Ks + 64 * DS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;             // fragment row group
  const int t = lane & 3;              // thread in group
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // This lane's row address in an ldmatrix_x4_trans of V: matrices 0 and 1
  // are keys 0-7 and 8-15 of a 16-key step at output columns [8j, 8j + 8),
  // matrices 2 and 3 the same keys at [8j + 8, 8j + 16).
  const int v_lane = ((lane & 7) + (lane & 8)) * DS + (lane >> 4) * 8;

  load_tile_bf16<DH, TC_THREADS>(Qs, q + (int64_t)b * q_sb + (int64_t)h * q_sh, q_sn, q0, N, vec);

  float m_r[2] = {-INFINITY, -INFINITY};   // rows g and g + 8 of this warp
  float l_r[2] = {0.f, 0.f};
  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t row_x[2] = {0u, 0u};          // dropout: q and bh terms of rows g and g + 8
  if constexpr (DROP) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      row_x[r] = drop_q_term(drop, q0 + warp * 16 + g + 8 * r) + drop_bh_term(b * H + h);
  }

  const bf16* qw = Qs + (warp * 16 + g) * DS + t * 2;
  const int n_tiles = (N + BN - 1) / BN;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BN;
    __syncthreads();                   // the previous tile's K and V are consumed
    load_tile_bf16<DH, TC_THREADS>(Ks, k + (int64_t)b * k_sb + (int64_t)h * k_sh, k_sn, k0, N, vec);
    load_tile_bf16<DH, TC_THREADS>(Vs, v + (int64_t)b * v_sb + (int64_t)h * v_sh, v_sn, k0, N, vec);
    __syncthreads();

    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      const uint32_t a[4] = {ld32(qw + kk), ld32(qw + 8 * DS + kk), ld32(qw + kk + 8),
                             ld32(qw + 8 * DS + kk + 8)};
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const bf16* kp = Ks + (j * 8 + g) * DS + kk + t * 2;
        const uint32_t bb[2] = {ld32(kp), ld32(kp + 8)};
        mma_16816(s[j], a, bb);
      }
    }

    // Online softmax over this tile; every tile holds a valid column (k0 < N).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t * 2 + (e & 1);
        s[j][e] = key < N ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_r[e >> 1]);
        rs[e >> 1] += s[j][e];
        if constexpr (DROP) {
          const int key = k0 + j * 8 + t * 2 + (e & 1);
          if (!drop_keep(drop, row_x[e >> 1] + drop_k_term(drop, key))) s[j][e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_r[r] = l_r[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      acc[j][0] *= alpha[0]; acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1]; acc[j][3] *= alpha[1];
    }

    // acc += P V: the score accumulators of n-tiles 2kt and 2kt + 1 are the
    // A fragment of keys [16 kt, 16 kt + 16); one transposed ldmatrix gives
    // the B fragments of output n-tiles j and j + 1.
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      const uint32_t a[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                             pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                             pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                             pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int j = 0; j < NT_O; j += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vs + kt * 16 * DS + j * 8 + v_lane);
        const uint32_t b0[2] = {bv[0], bv[1]};
        const uint32_t b1[2] = {bv[2], bv[3]};
        mma_16816(acc[j], a, b0);
        mma_16816(acc[j + 1], a, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + warp * 16 + g + 8 * r;
    if (n >= N) continue;
    const float inv_l = 1.f / (DROP ? l_r[r] * drop.keep_prob : l_r[r]);
    bf16* orow = o + (((int64_t)b * N + n) * H + h) * DH + t * 2;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(acc[j][2 * r] * inv_l, acc[j][2 * r + 1] * inv_l);
    }
    if (t == 0) lse[((int64_t)b * H + h) * N + n] = m_r[r] + logf(l_r[r]);
  }
}

// ---------------------------------------------------------------------------
// bfloat16, the wgmma kernel: TMA-fed K/V ring, warp-specialised
// ---------------------------------------------------------------------------

// The tile of each head dim the kernel is built for: key rows a K/V tile
// (BN) and the swizzle span of a TMA box row in bytes (SW; a box holds SW /
// 2 columns). Measured on an H100 80GB HBM3 at 700 W, PERF.md.
template <int DH>
struct WgTile;
template <>
struct WgTile<64> { static constexpr int BN = 128, SW = 128; };
template <>
struct WgTile<128> { static constexpr int BN = 128, SW = 128; };
template <>
struct WgTile<160> { static constexpr int BN = 128, SW = 64; };

template <int DH>
struct WgCfg {
  static constexpr int BM = 128;                        // query rows a CTA: 64 a consumer warpgroup
  static constexpr int BN = WgTile<DH>::BN, SW = WgTile<DH>::SW;
  static constexpr int BC = SW / 2;                     // head-dim columns a TMA box
  static constexpr int NB = (DH + BC - 1) / BC;         // boxes across the head dim
  static constexpr int DP = NB * BC;                    // the head dim in whole boxes (TMA zero-fills past DH)
  static constexpr int Q_BYTES = BM * DP * 2, KV_BYTES = BN * DP * 2;
  static constexpr int FREE = 232448 - 1024 - Q_BYTES - 8 * 16;
  static constexpr int STAGES = FREE / (2 * KV_BYTES) < 4 ? FREE / (2 * KV_BYTES) : 4;
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 3 * STAGES);
  static_assert(DH % 16 == 0 && DP % 16 == 0 && BN % 16 == 0, "whole k16 steps");
  static_assert(STAGES >= 2, "the K/V ring holds at least two stages");
};

template <int DH, bool DROP>
__global__ void __launch_bounds__(384, 1)
flash_attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                            float* __restrict__ lse, int N, int H, float scale, Dropout drop) {
  using C = WgCfg<DH>;
  constexpr int BM = C::BM, BN = C::BN, SW = C::SW, BC = C::BC, NB = C::NB, DP = C::DP, ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* kv = qs + C::Q_BYTES;                  // stage s: K at kv + 2 s KV_BYTES, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv + 2 * ST * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (N + BN - 1) / BN;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 2);                          // one thread of each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {                              // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int j = 0; j < NB; ++j) tma_load_4d(qs + j * BM * SW, &tq, j * BC, h, q0, b, q_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) - 1) & 1);
        unsigned char* ks = kv + 2 * s * C::KV_BYTES;
        mbar_expect_tx(&k_full[s], C::KV_BYTES);
        for (int j = 0; j < NB; ++j) tma_load_4d(ks + j * BN * SW, &tk, j * BC, h, it * BN, b, &k_full[s]);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
        for (int j = 0; j < NB; ++j)
          tma_load_4d(ks + C::KV_BYTES + j * BN * SW, &tv, j * BC, h, it * BN, b, &v_full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = (threadIdx.x >> 7) - 1;               // query rows 64 wg .. 64 wg + 63 of the tile
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * warp + g;               // this thread's rows r0 and r0 + 8
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};                // running max of the raw scores
  float l_r[2] = {0.f, 0.f};                            // this thread's share of the running sum
  uint32_t row_x[2] = {0u, 0u};                         // dropout: q and bh terms of the two rows
  if constexpr (DROP) {
#pragma unroll
    for (int r = 0; r < 2; ++r) row_x[r] = drop_q_term(drop, q0 + r0 + 8 * r) + drop_bh_term(b * H + h);
  }
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * SW;
  const float sl2 = scale * LOG2E;                      // scale > 0: the max of the raw scores is the max
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST;
    const uint32_t ph = (it / ST) & 1;
    const uint32_t k_addr = smem_u32(kv) + 2 * s * C::KV_BYTES, v_addr = k_addr + C::KV_BYTES;
    float sc[BN / 2];
    mbar_wait(&k_full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {               // a k16 step: box kk / (BC / 16), +32 bytes within it
      const uint32_t off = (kk / (BC / 16)) * SW, step = (kk % (BC / 16)) * 32;
      wgmma_ss<BN>(sc, wgmma_desc<SW>(q_addr + off * BM + step, 16, 8 * SW),
                   wgmma_desc<SW>(k_addr + off * BN + step, 16, 8 * SW), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);

    // Online softmax over this tile; every tile holds a valid column (k0 < N).
    // The scale goes into the exponent: p = 2^(s scale log2(e) - m scale
    // log2(e)), one FFMA a score, m the running max of the raw scores.
    const int k0 = it * BN;
    if (k0 + BN > N) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= N) sc[i] = -INFINITY;
    }
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float alpha[2], mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2((m_r[r] - mx[r]) * sl2);
      m_r[r] = mx[r];
      mb[r] = mx[r] * sl2;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      float p = ex2(fmaf(sc[i], sl2, -mb[r]));
      rs[r] += p;
      if constexpr (DROP) {
        if (!drop_keep(drop, row_x[r] + drop_k_term(drop, k0 + 8 * (i / 4) + 2 * t + (i & 1)))) p = 0.f;
      }
      sc[i] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: the score accumulators of keys [16 kt, 16 kt + 16) are the
    // A fragment of k16 step kt; V's 16 key rows of that step start 16 SW
    // bytes further, its column boxes BN SW bytes apart (LBO).
    uint32_t pa[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    mbar_wait(&v_full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt)
      wgmma_rs_vt<DP>(acc, pa[4 * kt], pa[4 * kt + 1], pa[4 * kt + 2], pa[4 * kt + 3],
                      wgmma_desc<SW>(v_addr + kt * 16 * SW, BN * SW, 8 * SW));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(pa);
    if (tid == 0) mbar_arrive(&empty[s]);               // this warpgroup is done with stage s
  }

  // Epilogue: the row sums across the quad, o = acc / l (l (1 - rate) under
  // dropout) staged in this warpgroup's own rows of the Q tile (its last
  // product has read them), then 16-byte row stores; lse by row.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const float inv_l = 1.f / (DROP ? l_r[r] * drop.keep_prob : l_r[r]);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      *reinterpret_cast<uint32_t*>(qs + tile_off<SW, BM>(r0 + 8 * r, 8 * j + 2 * t)) =
          pack_bf16(acc[4 * j + 2 * r] * inv_l, acc[4 * j + 2 * r + 1] * inv_l);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  constexpr int CH = DH / 8;                            // 16-byte chunks of an output row
  for (int i = tid; i < 64 * CH; i += 128) {
    const int rr = 64 * wg + i / CH, c = i % CH;
    const int n = q0 + rr;
    if (n < N)
      *reinterpret_cast<uint4*>(o + (((int64_t)b * N + n) * H + h) * DH + 8 * c) =
          *reinterpret_cast<const uint4*>(qs + tile_off<SW, BM>(rr, 8 * c));
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = q0 + r0 + 8 * r;
      if (n < N) lse[((int64_t)b * H + h) * N + n] = m_r[r] * scale + logf(l_r[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;
constexpr int TPR = F32_THREADS / BM;   // threads per query row (4, within one warp)
constexpr int PS = BN + 4;              // shared row stride of the P tile (floats)

template <int DH>
constexpr size_t f32_smem_bytes() {
  // Q, K and V tiles with the padded row stride, plus the P tile.
  return (size_t)(3 * 64 * f32_row_stride<DH>() + BM * PS) * sizeof(float);
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(F32_THREADS)
flash_attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int N, int H,
                          int64_t q_sb, int64_t q_sn, int64_t q_sh,
                          int64_t k_sb, int64_t k_sn, int64_t k_sh,
                          int64_t v_sb, int64_t v_sn, int64_t v_sh,
                          float scale, int /*vec*/, Dropout drop) {
  static_assert(DH % 16 == 0, "each of a row's 4 threads owns DH/16 float4 groups");
  constexpr int KS = f32_row_stride<DH>();
  constexpr int G = DH / 16;           // float4 column groups per thread
  constexpr int SC = BN / TPR;         // score columns per thread (16)

  extern __shared__ __align__(16) float smem_f32[];
  float* Qs = smem_f32;
  float* Ks = Qs + 64 * KS;
  float* Vs = Ks + 64 * KS;
  float* Ps = Vs + 64 * KS;

  const int tid = threadIdx.x;
  const int r = tid / TPR;             // this thread's query row in the tile
  const int cg = tid % TPR;            // its column slot within the row
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  load_tile_f32<DH, F32_THREADS>(Qs, q + (int64_t)b * q_sb + (int64_t)h * q_sh, q_sn, q0, N);

  float m_i = -INFINITY;
  float l_i = 0.f;
  float4 acc[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) acc[gi] = make_float4(0.f, 0.f, 0.f, 0.f);
  const uint32_t row_x = DROP ? drop_q_term(drop, q0 + r) + drop_bh_term(b * H + h) : 0u;

  const int n_tiles = (N + BN - 1) / BN;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BN;
    __syncthreads();                   // previous tile's K, V, P are consumed
    load_tile_f32<DH, F32_THREADS>(Ks, k + (int64_t)b * k_sb + (int64_t)h * k_sh, k_sn, k0, N);
    load_tile_f32<DH, F32_THREADS>(Vs, v + (int64_t)b * v_sb + (int64_t)h * v_sh, v_sn, k0, N);
    __syncthreads();

    // S row r, columns cg, cg + 4, ..., cg + 60 of this key tile.
    float s[SC];
#pragma unroll
    for (int j = 0; j < SC; ++j) s[j] = 0.f;
    const float* qrow = Qs + r * KS;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + (cg + TPR * j) * KS + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      s[j] = (k0 + cg + TPR * j) < N ? s[j] * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float rs = 0.f;
    float* prow = Ps + r * PS;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const float p = expf(s[j] - m_new);
      rs += p;
      if constexpr (DROP) {
        const int key = k0 + cg + TPR * j;
        prow[cg + TPR * j] = drop_keep(drop, row_x + drop_k_term(drop, key)) ? p : 0.f;
      } else {
        prow[cg + TPR * j] = p;
      }
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_i = l_i * alpha + rs;
    m_i = m_new;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      acc[gi].x *= alpha; acc[gi].y *= alpha; acc[gi].z *= alpha; acc[gi].w *= alpha;
    }
    __syncwarp();                      // a row's 4 threads share one warp

    // acc += P[r, :] V, over this thread's column groups cg + 4 gi.
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      const float p = prow[kk];
      const float* vrow = Vs + kk * KS;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * (cg + TPR * gi));
        acc[gi].x = fmaf(p, vv.x, acc[gi].x);
        acc[gi].y = fmaf(p, vv.y, acc[gi].y);
        acc[gi].z = fmaf(p, vv.z, acc[gi].z);
        acc[gi].w = fmaf(p, vv.w, acc[gi].w);
      }
    }
  }

  const int n = q0 + r;
  if (n < N) {
    const float inv_l = 1.f / (DROP ? l_i * drop.keep_prob : l_i);
    float* orow = o + (((int64_t)b * N + n) * H + h) * DH;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int c = 4 * (cg + TPR * gi);
      *reinterpret_cast<float4*>(orow + c) =
          make_float4(acc[gi].x * inv_l, acc[gi].y * inv_l, acc[gi].z * inv_l, acc[gi].w * inv_l);
    }
    if (cg == 0) lse[((int64_t)b * H + h) * N + n] = m_i + logf(l_i);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int DH, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int N, int H, const int64_t* st, float scale, int vec,
                   const Dropout& drop, cudaStream_t stream) {
  constexpr bool TC = sizeof(T) == 2;
  constexpr size_t smem = TC ? tc_smem_bytes<DH>() : f32_smem_bytes<DH>();
  constexpr int threads = TC ? TC_THREADS : F32_THREADS;
  void (*kern)(const T*, const T*, const T*, T*, float*, int, int, int64_t, int64_t, int64_t,
               int64_t, int64_t, int64_t, int64_t, int64_t, int64_t, float, int, Dropout);
  if constexpr (TC) {
    kern = flash_attn_fwd_bf16_kernel<DH, DROP>;
  } else {
    kern = flash_attn_fwd_f32_kernel<DH, DROP>;
  }
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BM - 1) / BM, H, B);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, N, H,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, vec, drop);
  return cudaGetLastError();
}

template <typename T, bool DROP>
cudaError_t dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int N, int H, const int64_t* st,
                        float scale, int vec, const Dropout& d, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16, DROP>(q, k, v, o, lse, B, N, H, st, scale, vec, d, stream);
    case 32: return launch<T, 32, DROP>(q, k, v, o, lse, B, N, H, st, scale, vec, d, stream);
    case 64: return launch<T, 64, DROP>(q, k, v, o, lse, B, N, H, st, scale, vec, d, stream);
    case 80: return launch<T, 80, DROP>(q, k, v, o, lse, B, N, H, st, scale, vec, d, stream);
    case 128: return launch<T, 128, DROP>(q, k, v, o, lse, B, N, H, st, scale, vec, d, stream);
    case 160: return launch<T, 160, DROP>(q, k, v, o, lse, B, N, H, st, scale, vec, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int N, int H, const int64_t* st,
                     float scale, int vec, int drop, const Dropout& d, cudaStream_t stream) {
  if (drop) return dispatch_dh<T, true>(dh, q, k, v, o, lse, B, N, H, st, scale, vec, d, stream);
  return dispatch_dh<T, false>(dh, q, k, v, o, lse, B, N, H, st, scale, vec, d, stream);
}

template <int DH, bool DROP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int N, int H,
                         const int64_t* st, float scale, const Dropout& drop, cudaStream_t stream) {
  using C = WgCfg<DH>;
  CUtensorMap tq, tk, tv;
  if (!encode_view<C::SW>(&tq, q, DH, H, N, B, st[0], st[1], st[2], C::BM) ||
      !encode_view<C::SW>(&tk, k, DH, H, N, B, st[3], st[4], st[5], C::BN) ||
      !encode_view<C::SW>(&tv, v, DH, H, N, B, st[6], st[7], st[8], C::BN))
    return cudaErrorNotSupported;
  static const cudaError_t attr = cudaFuncSetAttribute(flash_attn_fwd_wgmma_kernel<DH, DROP>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + C::BM - 1) / C::BM, H, B);      // query tiles of a head fastest: they share its K/V in L2
  flash_attn_fwd_wgmma_kernel<DH, DROP><<<grid, 384, C::SMEM, stream>>>(tq, tk, tv, static_cast<bf16*>(o), lse,
                                                                        N, H, scale, drop);
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t dispatch_wgmma(int dh, const void* q, const void* k, const void* v, void* o, float* lse, int B, int N,
                           int H, const int64_t* st, float scale, const Dropout& d, cudaStream_t stream) {
  switch (dh) {
    case 64: return launch_wgmma<64, DROP>(q, k, v, o, lse, B, N, H, st, scale, d, stream);
    case 128: return launch_wgmma<128, DROP>(q, k, v, o, lse, B, N, H, st, scale, d, stream);
    case 160: return launch_wgmma<160, DROP>(q, k, v, o, lse, B, N, H, st, scale, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 9 element strides, (batch,
// sequence, head) for q, then k, then v. drop != 0 runs the dropout
// instantiation with the seed, the global offsets q0 and k0 of the first
// query and key row, the uint32 threshold, float32(1 - rate) and its
// float32 reciprocal. kernel: 0 the general kernel (mma.sync for bfloat16,
// CUDA cores for float32), 1 the wgmma kernel (bfloat16, Dh 64, 128 or 160,
// a finite scale > 0, what TMA takes: tma_takes); operands a kernel does
// not take are refused, never sent elsewhere. Returns a cudaError_t (0 = success); the launch is
// asynchronous on `stream`.
int vitax_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int dtype, int B, int N, int H, int dh,
                         const int64_t* strides, float scale, int drop, uint32_t seed,
                         uint32_t q0, uint32_t k0, uint32_t threshold, float keep_prob,
                         float inv_keep_prob, int kernel, void* stream) {
  if (B < 1 || N < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[3] = {q, k, v};
  const vitax::Dropout d{seed, q0, k0, threshold, keep_prob, inv_keep_prob};
  if (kernel == 1) {
    if (dtype != 1 || !(scale > 0.f && scale < INFINITY) || !vitax::tma_takes(ptrs, 3, strides, B, N, H))
      return (int)cudaErrorInvalidValue;
    if (drop) return (int)dispatch_wgmma<true>(dh, q, k, v, o, lse, B, N, H, strides, scale, d, s);
    return (int)dispatch_wgmma<false>(dh, q, k, v, o, lse, B, N, H, strides, scale, d, s);
  }
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  const int vec = vitax::rows_vectorizable(ptrs, 3, strides, 9);
  if (dtype == 0) return (int)dispatch<float>(dh, q, k, v, o, lse, B, N, H, strides, scale, vec, drop, d, s);
  if (dtype == 1) return (int)dispatch<vitax::bf16>(dh, q, k, v, o, lse, B, N, H, strides, scale, vec, drop, d, s);
  return (int)cudaErrorInvalidValue;
}

const char* vitax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
