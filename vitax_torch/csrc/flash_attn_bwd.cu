// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces vitax/ops/attention.py:_bwd4_kernel (the TPU kernel behind the
// custom VJP of flash4_with_lse). Per (batch, head), from q, k, v, the
// forward's o and lse, the cotangent dO and the lse cotangent dlse:
//   P = exp(S - lse) with S = q k^T * scale (recomputed, never stored)
//   dV = P^T dO,  dP = dO V^T,  delta = rowsum(dO * O)
//   dS = P * (dP - delta + dlse) * scale
//   dQ = dS K,  dK = dS^T Q
// Cast points follow _bwd4_kernel: score and softmax math in float32; P
// and dS rounded to the input type before their products; dO enters its
// products in the input type; every product accumulates in float32.
//
// With the DROP template flag the kernels replace _bwd4_kernel_drop (and,
// on (B*H, N, 1, Dh) views, the BH kernels _bwd_kernel and
// _bwd_kernel_drop): each of the dK/dV and dQ kernels regenerates the
// forward's keep-mask from the counter hash in flash_common.cuh, and with
// ms = mask / (1 - rate)
//   dV = (P * ms)^T dO,  dS = P * (dP * ms - delta + dlse) * scale,
// delta unchanged (rowsum(dO * O) = rowsum(dP_probs * P) still holds; the
// derivation is at vitax/ops/attention.py:484-488). In the dK/dV kernel the
// score tile is held as S^T, keys as rows: the hash takes each element's
// key from its row and its query from its column. The rate-0
// instantiations are the code they were before dropout existed.
//
// What bounds it on the card: at the 10B train shape (B 32, N 256, H 32,
// Dh 160, bf16) the call reads q, k, v, o, dO and writes dq, dk, dv (8 x
// 83.9 MB, plus lse and dlse) against 107.4 GFLOP: 160 FLOP per byte,
// below the H100's ~295 in bf16, so it is memory-bound. Past 2048 tokens
// (the streaming entries, ViT-L's Dh 64) it does N/8 FLOP a byte and is
// bound by the tensor cores. The TPU kernel held a whole (N, hb*Dh) head
// group in VMEM; at Dh 160 that does not fit in 227 KB of shared memory,
// and the card needs many CTAs in flight. So the work is split into three
// launches, deterministic and with no atomics:
//   1. delta: D = rowsum(f32(dO) * f32(O)) - dlse, four threads a row
//      with 16-byte loads where the rows allow them, else a warp a row,
//      into a (B, H, N) float32 scratch the wrapper allocates;
//   2. dK/dV: one CTA per (b, h, K/V tile) loops over the query tiles,
//      recomputes P^T and dS^T and accumulates dK and dV on chip;
//   3. dQ: one CTA per (b, h, query tile) loops over the K/V tiles and
//      accumulates dQ on chip.
// Each of q, k, v, o and dO is read once per tile of the other operand;
// dq, dk and dv are written once, by one CTA each. Recomputing S and dP in
// both 2 and 3 costs 14 B H N^2 Dh FLOP where one pass accumulating dQ with
// atomics would do 10, but keeps the result bitwise repeatable.
//
// Inputs are strided (B, N, H, Dh) views with a contiguous head axis (the
// model passes slices of its (B, N, 3, H, Dh) qkv output and whatever
// layout autograd hands over for dO); lse, dlse and the outputs are
// contiguous: lse and dlse (B, H, N) float32 (dlse may be null, meaning
// zero), dq, dk, dv (B, N, H, Dh) in the input type, allocated by the
// wrapper. Any N >= 1 works: rows past N are zero-filled and masked.
//
// Three kernel families; ops/attention.py `choose_bwd_kernel` picks one
// from the type, the head dim, the alignment, the strides and the scale's
// sign, never on a failure:
// - wgmma (bfloat16, Dh 64, 128 and 160, scale > 0: every main path), the
//   forward's design turned to the backward. Each kernel is a CTA of three
//   warpgroups: warpgroup 0 gives up its registers (setmaxnreg) and loads
//   the CTA's own 128-row tiles of two operands once and keeps a ring of
//   tiles of the other two filled by TMA (4-D tensor maps over the strided
//   views, full and empty mbarriers); warpgroups 1 and 2 own 64 rows each.
//   In the dK/dV kernel they own K/V rows and stream (Q, dO) tiles with
//   their lse and delta: S^T = K Q^T and dP^T = V dO^T by wgmma from shared
//   memory, then dV += (P^T ms) dO and dK += dS^T Q with A straight from
//   the score registers packed to bf16 and dO, Q read as loaded (wgmma's
//   MN-major B, as the forward reads V). In the dQ kernel they own query
//   rows and stream (K, V) tiles: S = Q K^T, dP = dO V^T, dQ += dS K. The
//   exponent takes the scale, p = 2^(s scale log2 e - lse log2 e), one FFMA
//   a score, hence scale > 0. P is computed while the dP products run.
//   Outputs go through the warpgroup's own rows of an owned tile to 16-byte
//   row stores. Tiles (BwdTile) were chosen by measurement (PERF.md).
// - general bfloat16 (other head dims, misaligned bases or strides):
//   tensor cores through mma.sync m16n8k16. In the dK/dV kernel each of 4
//   warps owns 16 K/V rows and walks a loaded 64-row query tile 16 rows at
//   a time, so its live state is the 16 x Dh dK and dV accumulators (160
//   registers a thread at Dh 160) plus a 16 x 16 score and dP tile. P^T and
//   dS^T go from the score accumulators straight into the A operand of the
//   dV and dK products; dO and Q stay row-major in shared memory and
//   ldmatrix.trans reads them as B operands.
// - float32: CUDA-core FMAs from shared memory, exact f32 throughout.

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace vitax;

constexpr int TC_THREADS = 128;   // 4 warps x 16 rows
constexpr int F32_THREADS = 256;  // 4 threads per row of a 64-row tile
constexpr int TPR = F32_THREADS / TILE;
constexpr int PS = TILE + 4;      // shared row stride of the f32 P / dS tiles

// Element strides (batch, sequence, head) of q, k, v, o, dO.
struct Strides {
  int64_t s[15];
};
enum { Q_ = 0, K_ = 3, V_ = 6, O_ = 9, DO_ = 12 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ const T* head_base(const T* x, const Strides& st, int which, int b, int h) {
  return x + (int64_t)b * st.s[which] + (int64_t)h * st.s[which + 2];
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O) - dlse
// ---------------------------------------------------------------------------

constexpr int DELTA_THREADS = 256;
// Threads a row: four with 16-byte loads where o's and dout's rows allow
// them (bfloat16, 16-byte aligned, strides a multiple of 8 elements, as
// every wgmma call's are), else a warp a row.
constexpr int DELTA_TPR_VEC = 4, DELTA_TPR = 32;

template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ dlse,
             float* __restrict__ delta, int B, int N, int H, int DH, Strides st, int vec) {
  const int tpr = vec ? DELTA_TPR_VEC : DELTA_TPR;
  const int64_t row = ((int64_t)blockIdx.x * DELTA_THREADS + threadIdx.x) / tpr;
  const int j = threadIdx.x % tpr;
  const bool live = row < (int64_t)B * N * H;          // every lane takes part in the shuffles
  const int h = (int)(row % H);
  const int n = (int)((row / H) % N);
  const int b = (int)(row / ((int64_t)H * N));
  float acc = 0.f;
  if (live) {
    const T* orow = head_base(o, st, O_, b, h) + (int64_t)n * st.s[O_ + 1];
    const T* drow = head_base(dout, st, DO_, b, h) + (int64_t)n * st.s[DO_ + 1];
    if constexpr (sizeof(T) == 2) {
      if (vec) {
        for (int c = j; c < DH / 8; c += DELTA_TPR_VEC) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
          const uint4 dv = *reinterpret_cast<const uint4*>(drow + 8 * c);
          const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(op[e]), df = __bfloat1622float2(dp[e]);
            acc = fmaf(df.x, of.x, acc);
            acc = fmaf(df.y, of.y, acc);
          }
        }
      }
    }
    if (!vec)
      for (int d = j; d < DH; d += DELTA_TPR) acc += to_f32(drow[d]) * to_f32(orow[d]);
  }
  for (int off = 1; off < tpr; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && j == 0) {
    const int64_t idx = ((int64_t)b * H + h) * N + n;
    delta[idx] = acc - (dlse != nullptr ? dlse[idx] : 0.f);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync)
// ---------------------------------------------------------------------------

template <int DH>
constexpr size_t tc_smem_bytes() {
  // four bf16 tiles (two of each operand pair), plus lse and delta of a tile
  return (size_t)(4 * TILE * tc_row_stride<DH>()) * sizeof(bf16) + 2 * TILE * sizeof(float);
}

// 2. dK, dV for one 64-row K/V tile.
template <int DH, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, 1)
bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int N, int H, Strides st, float scale, int vec, Dropout drop) {
  static_assert(DH % 16 == 0, "head dim must be a multiple of the mma k-step (16)");
  constexpr int DS = tc_row_stride<DH>();
  constexpr int NT_D = DH / 8;         // head-dim n-tiles of the dK / dV accumulators

  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* Vs = Ks + TILE * DS;
  bf16* Qs = Vs + TILE * DS;
  bf16* Os = Qs + TILE * DS;           // dO
  float* lse_s = reinterpret_cast<float*>(Os + TILE * DS);
  float* del_s = lse_s + TILE;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kv0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // ldmatrix_x4_trans row address of this lane in a 16-row block of a
  // row-major [row][d] tile: matrices 0 and 1 are rows 0-7 and 8-15 at
  // columns [8j, 8j + 8), matrices 2 and 3 the same rows at [8j + 8, 8j + 16).
  const int t_lane = ((lane & 7) + (lane & 8)) * DS + (lane >> 4) * 8;

  load_tile_bf16<DH, TC_THREADS>(Ks, head_base(k, st, K_, b, h), st.s[K_ + 1], kv0, N, vec);
  load_tile_bf16<DH, TC_THREADS>(Vs, head_base(v, st, V_, b, h), st.s[V_ + 1], kv0, N, vec);

  float acc_dk[NT_D][4], acc_dv[NT_D][4];
#pragma unroll
  for (int j = 0; j < NT_D; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  }

  const bf16* kw = Ks + (warp * 16 + g) * DS + t * 2;   // this warp's K/V rows, as A
  const bf16* vw = Vs + (warp * 16 + g) * DS + t * 2;
  uint32_t key_x[2] = {0u, 0u};        // dropout: k and bh terms of K/V rows g and g + 8
  if constexpr (DROP) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      key_x[r] = drop_k_term(drop, kv0 + warp * 16 + g + 8 * r) + drop_bh_term(b * H + h);
  }
  const float* lse_bh = lse + ((int64_t)b * H + h) * N;
  const float* del_bh = delta + ((int64_t)b * H + h) * N;
  const int n_tiles = (N + TILE - 1) / TILE;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * TILE;
    __syncthreads();                   // the previous query tile is consumed
    load_tile_bf16<DH, TC_THREADS>(Qs, head_base(q, st, Q_, b, h), st.s[Q_ + 1], q0, N, vec);
    load_tile_bf16<DH, TC_THREADS>(Os, head_base(dout, st, DO_, b, h), st.s[DO_ + 1], q0, N, vec);
    for (int i = threadIdx.x; i < TILE; i += TC_THREADS) {
      const bool valid = q0 + i < N;
      lse_s[i] = valid ? lse_bh[q0 + i] : INFINITY;   // P = 0 past N
      del_s[i] = valid ? del_bh[q0 + i] : 0.f;
    }
    __syncthreads();

    const int q_rows = min(TILE, N - q0);
    for (int qs = 0; qs < q_rows; qs += 16) {
      // S^T = K Q^T and dP^T = V dO^T over this warp's 16 K/V rows and
      // query rows [qs, qs + 16) of the tile.
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        const uint32_t a[4] = {ld32(kw + kk), ld32(kw + 8 * DS + kk), ld32(kw + kk + 8),
                               ld32(kw + 8 * DS + kk + 8)};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bf16* qp = Qs + (qs + j * 8 + g) * DS + kk + t * 2;
          const uint32_t bb[2] = {ld32(qp), ld32(qp + 8)};
          mma_16816(s[j], a, bb);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        const uint32_t a[4] = {ld32(vw + kk), ld32(vw + 8 * DS + kk), ld32(vw + kk + 8),
                               ld32(vw + 8 * DS + kk + 8)};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bf16* op = Os + (qs + j * 8 + g) * DS + kk + t * 2;
          const uint32_t bb[2] = {ld32(op), ld32(op + 8)};
          mma_16816(dp[j], a, bb);
        }
      }
      // P^T = exp(S^T * scale - lse), dS^T = P^T (dP^T - delta) * scale,
      // column c of the 16 is query row qs + c (row e >> 1 of the fragment
      // is this thread's K/V row g or g + 8). Under dropout P^T becomes
      // P^T * ms for dV, and dP^T becomes dP^T * ms.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = qs + j * 8 + t * 2 + (e & 1);
          const float p = expf(s[j][e] * scale - lse_s[c]);
          if constexpr (DROP) {
            const float ms = drop_keep(drop, key_x[e >> 1] + drop_q_term(drop, q0 + c)) ? drop.inv_keep_prob : 0.f;
            dp[j][e] = p * (dp[j][e] * ms - del_s[c]) * scale;
            s[j][e] = p * ms;
          } else {
            dp[j][e] = p * (dp[j][e] - del_s[c]) * scale;
            s[j][e] = p;
          }
        }
      }
      const uint32_t ap[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      const uint32_t ad[4] = {pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
                              pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
      // dV += P^T dO and dK += dS^T Q over these 16 query rows.
#pragma unroll
      for (int j = 0; j < NT_D; j += 2) {
        uint32_t bo[4], bq[4];
        ldmatrix_x4_trans(bo, Os + qs * DS + j * 8 + t_lane);
        ldmatrix_x4_trans(bq, Qs + qs * DS + j * 8 + t_lane);
        const uint32_t bo0[2] = {bo[0], bo[1]}, bo1[2] = {bo[2], bo[3]};
        const uint32_t bq0[2] = {bq[0], bq[1]}, bq1[2] = {bq[2], bq[3]};
        mma_16816(acc_dv[j], ap, bo0);
        mma_16816(acc_dv[j + 1], ap, bo1);
        mma_16816(acc_dk[j], ad, bq0);
        mma_16816(acc_dk[j + 1], ad, bq1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = kv0 + warp * 16 + g + 8 * r;
    if (n >= N) continue;
    const int64_t off = (((int64_t)b * N + n) * H + h) * DH + t * 2;
#pragma unroll
    for (int j = 0; j < NT_D; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + j * 8) = pack_bf16(acc_dk[j][2 * r], acc_dk[j][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + j * 8) = pack_bf16(acc_dv[j][2 * r], acc_dv[j][2 * r + 1]);
    }
  }
}

// 3. dQ for one 64-row query tile.
template <int DH, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, 1)
bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int N, int H, Strides st, float scale, int vec, Dropout drop) {
  constexpr int DS = tc_row_stride<DH>();
  constexpr int NT_S = TILE / 8;       // key n-tiles of a score tile
  constexpr int NT_D = DH / 8;

  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* Os = Qs + TILE * DS;           // dO
  bf16* Ks = Os + TILE * DS;
  bf16* Vs = Ks + TILE * DS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t_lane = ((lane & 7) + (lane & 8)) * DS + (lane >> 4) * 8;

  load_tile_bf16<DH, TC_THREADS>(Qs, head_base(q, st, Q_, b, h), st.s[Q_ + 1], q0, N, vec);
  load_tile_bf16<DH, TC_THREADS>(Os, head_base(dout, st, DO_, b, h), st.s[DO_ + 1], q0, N, vec);

  float lse_r[2], del_r[2];           // rows g and g + 8 of this warp
  uint32_t row_x[2] = {0u, 0u};       // dropout: their q and bh terms
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + warp * 16 + g + 8 * r;
    const int64_t idx = ((int64_t)b * H + h) * N + n;
    lse_r[r] = n < N ? lse[idx] : INFINITY;
    del_r[r] = n < N ? delta[idx] : 0.f;
    if constexpr (DROP) row_x[r] = drop_q_term(drop, n) + drop_bh_term(b * H + h);
  }
  float acc[NT_D][4];
#pragma unroll
  for (int j = 0; j < NT_D; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const bf16* qw = Qs + (warp * 16 + g) * DS + t * 2;
  const bf16* ow = Os + (warp * 16 + g) * DS + t * 2;
  const int n_tiles = (N + TILE - 1) / TILE;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * TILE;
    __syncthreads();                   // the previous K/V tile is consumed
    load_tile_bf16<DH, TC_THREADS>(Ks, head_base(k, st, K_, b, h), st.s[K_ + 1], k0, N, vec);
    load_tile_bf16<DH, TC_THREADS>(Vs, head_base(v, st, V_, b, h), st.s[V_ + 1], k0, N, vec);
    __syncthreads();

    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
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
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      const uint32_t a[4] = {ld32(ow + kk), ld32(ow + 8 * DS + kk), ld32(ow + kk + 8),
                             ld32(ow + 8 * DS + kk + 8)};
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const bf16* vp = Vs + (j * 8 + g) * DS + kk + t * 2;
        const uint32_t bb[2] = {ld32(vp), ld32(vp + 8)};
        mma_16816(dp[j], a, bb);
      }
    }
    // dS = P (dP - delta) * scale, keys past N masked to P = 0; under
    // dropout dS = P (dP * ms - delta) * scale.
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t * 2 + (e & 1);
        const float p = key < N ? expf(s[j][e] * scale - lse_r[e >> 1]) : 0.f;
        if constexpr (DROP) {
          const float ms = drop_keep(drop, row_x[e >> 1] + drop_k_term(drop, key)) ? drop.inv_keep_prob : 0.f;
          s[j][e] = p * (dp[j][e] * ms - del_r[e >> 1]) * scale;
        } else {
          s[j][e] = p * (dp[j][e] - del_r[e >> 1]) * scale;
        }
      }
    }
    // dQ += dS K: the dS accumulators of n-tiles 2kt and 2kt + 1 are the A
    // fragment of keys [16 kt, 16 kt + 16).
#pragma unroll
    for (int kt = 0; kt < TILE / 16; ++kt) {
      const uint32_t a[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                             pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                             pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                             pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int j = 0; j < NT_D; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, Ks + kt * 16 * DS + j * 8 + t_lane);
        const uint32_t b0[2] = {bk[0], bk[1]};
        const uint32_t b1[2] = {bk[2], bk[3]};
        mma_16816(acc[j], a, b0);
        mma_16816(acc[j + 1], a, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + warp * 16 + g + 8 * r;
    if (n >= N) continue;
    bf16* row = dq + (((int64_t)b * N + n) * H + h) * DH + t * 2;
#pragma unroll
    for (int j = 0; j < NT_D; ++j) {
      *reinterpret_cast<uint32_t*>(row + j * 8) = pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16, the wgmma kernels: TMA-fed rings, warp-specialised
// ---------------------------------------------------------------------------

// The tiles of each head dim the kernels are built for: the head dim's TMA
// boxes (SW-byte rows of BC = SW / 2 columns, NB boxes across it; Dh 64 and
// 128 take the 128-byte swizzle, Dh 160 five 32-column boxes with the
// 64-byte swizzle, as the forward), the query rows a ring stage of the dK/dV
// kernel streams (BQ) and the key rows a ring stage of the dQ kernel
// streams (BK). Each CTA owns 128 rows of the other operand, 64 a consumer
// warpgroup. Measured on an H100 80GB HBM3 at 700 W (PERF.md).
template <int DH>
struct BwdTile;
template <>
struct BwdTile<64> { static constexpr int BQ = 64, BK = 128, SW = 128; };
template <>
struct BwdTile<128> { static constexpr int BQ = 64, BK = 128, SW = 128; };
template <>
struct BwdTile<160> { static constexpr int BQ = 32, BK = 64, SW = 64; };

constexpr int SMEM_MAX = 232448;     // shared memory a block may use on the card
constexpr int BR = 128;              // rows a CTA owns: K/V rows (dK/dV), query rows (dQ)

// A ring that streams tiles of RING rows of two operands past OWN-row tiles
// of two others, with EXTRA bytes a stage beside them.
template <int DH, int RING, int EXTRA>
struct BwdCfg {
  static constexpr int SW = BwdTile<DH>::SW, BC = SW / 2, NB = (DH + BC - 1) / BC, DP = NB * BC;
  static constexpr int OWN_BYTES = BR * DP * 2, RING_BYTES = RING * DP * 2;
  static constexpr int FREE = SMEM_MAX - 1024 - 2 * OWN_BYTES - 8 * 16;
  static constexpr int STAGES = FREE / (2 * RING_BYTES + EXTRA) < 4 ? FREE / (2 * RING_BYTES + EXTRA) : 4;
  static constexpr int SMEM = 1024 + 2 * OWN_BYTES + STAGES * (2 * RING_BYTES + EXTRA) + 8 * (1 + 2 * STAGES);
  static_assert(DH % 16 == 0 && DP % 16 == 0 && RING % 16 == 0, "whole k16 steps");
  static_assert(STAGES >= 2, "the ring holds at least two stages");
};
template <int DH>
using DkdvCfg = BwdCfg<DH, BwdTile<DH>::BQ, 8 * BwdTile<DH>::BQ>;   // a stage: Q, dO, lse and delta of BQ rows
template <int DH>
using DqCfg = BwdCfg<DH, BwdTile<DH>::BK, 0>;                       // a stage: K and V

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// 2. dK, dV for one 128-row K/V tile of one (b, h). Warpgroup 0 is the
// producer: thread 0 loads K and V once and keeps a ring of (Q, dO) tiles of
// BQ rows filled by TMA; warp 1 puts each stage's lse (times log2 e, +inf
// past N, so P = 0 there) and delta (0 past N) beside them. Warpgroups 1 and
// 2 own 64 K/V rows each: S^T = K Q^T and dP^T = V dO^T by wgmma from
// shared memory (both K-major), then P^T and dS^T in registers, then dV +=
// (P^T ms) dO and dK += dS^T Q with A straight from those registers and
// dO, Q read as loaded (queries by rows, Dh contiguous: MN-major B). The
// hash takes each element's key from its row and its query from its column.
template <int DH, bool DROP>
__global__ void __launch_bounds__(384, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int N, int H, float scale, Dropout drop) {
  using C = DkdvCfg<DH>;
  constexpr int BQ = BwdTile<DH>::BQ, SW = C::SW, BC = C::BC, NB = C::NB, DP = C::DP, ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);
  unsigned char* vs = ks + C::OWN_BYTES;
  unsigned char* ring = vs + C::OWN_BYTES;             // stage s: Q at ring + 2 s RING_BYTES, dO after it
  float* lse2_s = reinterpret_cast<float*>(ring + 2 * ST * C::RING_BYTES);   // [ST][BQ]
  float* del_s = lse2_s + ST * BQ;                                           // [ST][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(del_s + ST * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;
  const int kv0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (N + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1 + 32);                     // the TMA thread and warp 1's lanes
      mbar_init(&empty[s], 2);                         // one thread of each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * C::OWN_BYTES);
      for (int j = 0; j < NB; ++j) tma_load_4d(ks + j * BR * SW, &tk, j * BC, h, kv0, b, kv_full);
      for (int j = 0; j < NB; ++j) tma_load_4d(vs + j * BR * SW, &tv, j * BC, h, kv0, b, kv_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) - 1) & 1);
        unsigned char* qs = ring + 2 * s * C::RING_BYTES;
        mbar_expect_tx(&full[s], 2 * C::RING_BYTES);
        for (int j = 0; j < NB; ++j) tma_load_4d(qs + j * BQ * SW, &tq, j * BC, h, it * BQ, b, &full[s]);
        for (int j = 0; j < NB; ++j)
          tma_load_4d(qs + C::RING_BYTES + j * BQ * SW, &tdo, j * BC, h, it * BQ, b, &full[s]);
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      const int lane = threadIdx.x - 32;
      const float* lse_bh = lse + ((int64_t)b * H + h) * N;
      const float* del_bh = delta + ((int64_t)b * H + h) * N;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) - 1) & 1);
        for (int c = lane; c < BQ; c += 32) {
          const int n = it * BQ + c;
          lse2_s[s * BQ + c] = n < N ? lse_bh[n] * LOG2E : INFINITY;
          del_s[s * BQ + c] = n < N ? del_bh[n] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = (threadIdx.x >> 7) - 1;               // K/V rows 64 wg .. 64 wg + 63 of the tile
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * warp + g;               // this thread's rows r0 and r0 + 8
  float acc_dk[DP / 2], acc_dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  uint32_t key_x[2] = {0u, 0u};                         // dropout: k and bh terms of the two rows
  if constexpr (DROP) {
#pragma unroll
    for (int r = 0; r < 2; ++r) key_x[r] = drop_k_term(drop, kv0 + r0 + 8 * r) + drop_bh_term(b * H + h);
  }
  const uint32_t k_addr = smem_u32(ks) + wg * 64 * SW, v_addr = smem_u32(vs) + wg * 64 * SW;
  const float sl2 = scale * LOG2E;
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST;
    const uint32_t ph = (it / ST) & 1;
    const uint32_t q_addr = smem_u32(ring) + 2 * s * C::RING_BYTES, do_addr = q_addr + C::RING_BYTES;
    const float* l2 = lse2_s + s * BQ;
    const float* dl = del_s + s * BQ;
    float st[BQ / 2], dpt[BQ / 2];
    mbar_wait(&full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {              // a k16 step: box kk / (BC / 16), +32 bytes within it
      const uint32_t off = (kk / (BC / 16)) * SW, step = (kk % (BC / 16)) * 32;
      wgmma_ss<BQ>(st, wgmma_desc<SW>(k_addr + off * BR + step, 16, 8 * SW),
                   wgmma_desc<SW>(q_addr + off * BQ + step, 16, 8 * SW), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / (BC / 16)) * SW, step = (kk % (BC / 16)) * 32;
      wgmma_ss<BQ>(dpt, wgmma_desc<SW>(v_addr + off * BR + step, 16, 8 * SW),
                   wgmma_desc<SW>(do_addr + off * BQ + step, 16, 8 * SW), kk > 0);
    }
    wgmma_commit();
    // Under the products: the keep bits of the tile (bit i % 32 of word i /
    // 32 keeps score register i), then P^T = 2^(S^T scale log2 e - lse
    // log2 e) under the dP^T products; column c of the tile is query it BQ
    // + c.
    uint32_t keep[(BQ / 2 + 31) / 32] = {};
    if constexpr (DROP) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const uint32_t x = key_x[(i >> 1) & 1] + drop_q_term(drop, it * BQ + 8 * (i / 4) + 2 * t + (i & 1));
        keep[i / 32] |= (uint32_t)drop_keep(drop, x) << (i % 32);
      }
    }
    wgmma_wait<1>();
    pin(st);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = ex2(fmaf(st[i], sl2, -l2[8 * (i / 4) + 2 * t + (i & 1)]));
    wgmma_wait<0>();
    pin(dpt);
    // dS^T = P^T (dP^T - delta) scale; under dropout P^T becomes P^T ms
    // for dV and dP^T becomes dP^T ms.
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int c = 8 * (i / 4) + 2 * t + (i & 1);
      if constexpr (DROP) {
        const float ms = (keep[i / 32] >> (i % 32)) & 1u ? drop.inv_keep_prob : 0.f;
        dpt[i] = st[i] * (dpt[i] * ms - dl[c]) * scale;
        st[i] *= ms;
      } else {
        dpt[i] = st[i] * (dpt[i] - dl[c]) * scale;
      }
    }
    // dV += P^T dO and dK += dS^T Q: the accumulators of queries [16 kt,
    // 16 kt + 16) are the A fragment of k16 step kt; dO's and Q's 16 rows of
    // that step start 16 SW bytes further, their column boxes BQ SW bytes
    // apart (LBO).
    uint32_t pa[BQ / 4], pd[BQ / 4];
#pragma unroll
    for (int i = 0; i < BQ / 4; ++i) {
      pa[i] = pack_bf16(st[2 * i], st[2 * i + 1]);
      pd[i] = pack_bf16(dpt[2 * i], dpt[2 * i + 1]);
    }
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BQ / 16; ++kt)
      wgmma_rs_vt<DP>(acc_dv, pa[4 * kt], pa[4 * kt + 1], pa[4 * kt + 2], pa[4 * kt + 3],
                      wgmma_desc<SW>(do_addr + kt * 16 * SW, BQ * SW, 8 * SW));
#pragma unroll
    for (int kt = 0; kt < BQ / 16; ++kt)
      wgmma_rs_vt<DP>(acc_dk, pd[4 * kt], pd[4 * kt + 1], pd[4 * kt + 2], pd[4 * kt + 3],
                      wgmma_desc<SW>(q_addr + kt * 16 * SW, BQ * SW, 8 * SW));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc_dv);
    pin(acc_dk);
    pin(pa);
    pin(pd);
    if (tid == 0) mbar_arrive(&empty[s]);               // this warpgroup is done with stage s
  }

  // Epilogue: dK and dV staged in this warpgroup's own rows of the K and V
  // tiles (only its own products read them), then 16-byte row stores.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const uint32_t off = tile_off<SW, BR>(r0 + 8 * r, 8 * j + 2 * t);
      *reinterpret_cast<uint32_t*>(ks + off) = pack_bf16(acc_dk[4 * j + 2 * r], acc_dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vs + off) = pack_bf16(acc_dv[4 * j + 2 * r], acc_dv[4 * j + 2 * r + 1]);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  constexpr int CH = DH / 8;                            // 16-byte chunks of an output row
  for (int i = tid; i < 64 * CH; i += 128) {
    const int rr = 64 * wg + i / CH, c = i % CH;
    const int n = kv0 + rr;
    if (n < N) {
      const int64_t o = (((int64_t)b * N + n) * H + h) * DH + 8 * c;
      const uint32_t off = tile_off<SW, BR>(rr, 8 * c);
      *reinterpret_cast<uint4*>(dk + o) = *reinterpret_cast<const uint4*>(ks + off);
      *reinterpret_cast<uint4*>(dv + o) = *reinterpret_cast<const uint4*>(vs + off);
    }
  }
}

// 3. dQ for one 128-row query tile of one (b, h): the forward's structure.
// Thread 0 of the producer warpgroup loads Q and dO once and keeps a ring of
// (K, V) tiles of BK rows filled by TMA. Warpgroups 1 and 2 own 64 query
// rows each: S = Q K^T and dP = dO V^T by wgmma from shared memory, dS in
// registers (keys past N cleared), then dQ += dS K with A from those
// registers and K read as loaded (MN-major B).
template <int DH, bool DROP>
__global__ void __launch_bounds__(384, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
                    int N, int H, float scale, Dropout drop) {
  using C = DqCfg<DH>;
  constexpr int BK = BwdTile<DH>::BK, SW = C::SW, BC = C::BC, NB = C::NB, DP = C::DP, ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* dos = qs + C::OWN_BYTES;
  unsigned char* ring = dos + C::OWN_BYTES;            // stage s: K at ring + 2 s RING_BYTES, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + 2 * ST * C::RING_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;
  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (N + BK - 1) / BK;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * C::OWN_BYTES);
      for (int j = 0; j < NB; ++j) tma_load_4d(qs + j * BR * SW, &tq, j * BC, h, q0, b, q_full);
      for (int j = 0; j < NB; ++j) tma_load_4d(dos + j * BR * SW, &tdo, j * BC, h, q0, b, q_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) - 1) & 1);
        unsigned char* kt = ring + 2 * s * C::RING_BYTES;
        mbar_expect_tx(&full[s], 2 * C::RING_BYTES);
        for (int j = 0; j < NB; ++j) tma_load_4d(kt + j * BK * SW, &tk, j * BC, h, it * BK, b, &full[s]);
        for (int j = 0; j < NB; ++j)
          tma_load_4d(kt + C::RING_BYTES + j * BK * SW, &tv, j * BC, h, it * BK, b, &full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = (threadIdx.x >> 7) - 1;               // query rows 64 wg .. 64 wg + 63 of the tile
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * warp + g;               // this thread's rows r0 and r0 + 8
  float lse2[2], del[2];                                // lse log2 e (+inf past N: P = 0) and delta
  uint32_t row_x[2] = {0u, 0u};                         // dropout: q and bh terms of the two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + r0 + 8 * r;
    const int64_t idx = ((int64_t)b * H + h) * N + n;
    lse2[r] = n < N ? lse[idx] * LOG2E : INFINITY;
    del[r] = n < N ? delta[idx] : 0.f;
    if constexpr (DROP) row_x[r] = drop_q_term(drop, n) + drop_bh_term(b * H + h);
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * SW, do_addr = smem_u32(dos) + wg * 64 * SW;
  const float sl2 = scale * LOG2E;
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST;
    const uint32_t ph = (it / ST) & 1;
    const uint32_t k_addr = smem_u32(ring) + 2 * s * C::RING_BYTES, v_addr = k_addr + C::RING_BYTES;
    const int k0 = it * BK;
    float sc[BK / 2], dp[BK / 2];
    mbar_wait(&full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / (BC / 16)) * SW, step = (kk % (BC / 16)) * 32;
      wgmma_ss<BK>(sc, wgmma_desc<SW>(q_addr + off * BR + step, 16, 8 * SW),
                   wgmma_desc<SW>(k_addr + off * BK + step, 16, 8 * SW), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / (BC / 16)) * SW, step = (kk % (BC / 16)) * 32;
      wgmma_ss<BK>(dp, wgmma_desc<SW>(do_addr + off * BR + step, 16, 8 * SW),
                   wgmma_desc<SW>(v_addr + off * BK + step, 16, 8 * SW), kk > 0);
    }
    wgmma_commit();
    // Under the products: the keep bits of the tile (bit i % 32 of word i /
    // 32 keeps score register i), then P under the dP products; keys past N
    // (zero rows of the last tile) give P = 0.
    uint32_t keep[(BK / 2 + 31) / 32] = {};
    if constexpr (DROP) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const uint32_t x = row_x[(i >> 1) & 1] + drop_k_term(drop, k0 + 8 * (i / 4) + 2 * t + (i & 1));
        keep[i / 32] |= (uint32_t)drop_keep(drop, x) << (i % 32);
      }
    }
    wgmma_wait<1>();
    pin(sc);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = ex2(fmaf(sc[i], sl2, -lse2[(i >> 1) & 1]));
    if (k0 + BK > N) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= N) sc[i] = 0.f;
    }
    wgmma_wait<0>();
    pin(dp);
    // dS = P (dP - delta) scale; under dropout dS = P (dP ms - delta) scale.
    uint32_t pd[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      if constexpr (DROP) {
        const float ms = (keep[i / 32] >> (i % 32)) & 1u ? drop.inv_keep_prob : 0.f;
        dp[i] = sc[i] * (dp[i] * ms - del[r]) * scale;
      } else {
        dp[i] = sc[i] * (dp[i] - del[r]) * scale;
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) pd[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    // dQ += dS K: K's 16 key rows of step kt start 16 SW bytes further, its
    // column boxes BK SW bytes apart (LBO).
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt)
      wgmma_rs_vt<DP>(acc, pd[4 * kt], pd[4 * kt + 1], pd[4 * kt + 2], pd[4 * kt + 3],
                      wgmma_desc<SW>(k_addr + kt * 16 * SW, BK * SW, 8 * SW));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(pd);
    if (tid == 0) mbar_arrive(&empty[s]);
  }

  // Epilogue: dQ staged in this warpgroup's own rows of the Q tile (its
  // products have read them), then 16-byte row stores.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      *reinterpret_cast<uint32_t*>(qs + tile_off<SW, BR>(r0 + 8 * r, 8 * j + 2 * t)) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  constexpr int CH = DH / 8;
  for (int i = tid; i < 64 * CH; i += 128) {
    const int rr = 64 * wg + i / CH, c = i % CH;
    const int n = q0 + rr;
    if (n < N)
      *reinterpret_cast<uint4*>(dq + (((int64_t)b * N + n) * H + h) * DH + 8 * c) =
          *reinterpret_cast<const uint4*>(qs + tile_off<SW, BR>(rr, 8 * c));
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

template <int DH>
constexpr size_t f32_dkdv_smem_bytes() {
  // K, V, Q, dO tiles; P^T and dS^T tiles; lse and delta of a query tile
  return (size_t)(4 * TILE * f32_row_stride<DH>() + 2 * TILE * PS + 2 * TILE) * sizeof(float);
}

template <int DH>
constexpr size_t f32_dq_smem_bytes() {
  return (size_t)(4 * TILE * f32_row_stride<DH>() + TILE * PS) * sizeof(float);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// Thread (r, cg) owns row r of the resident tile and, of the streamed
// tile, rows cg, cg + 4, ..., cg + 60 for the scores and the column groups
// cg + 4 gi for its accumulators.
template <int DH, bool DROP>
__global__ void __launch_bounds__(F32_THREADS, 1)
bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv,
                    int N, int H, Strides st, float scale, int /*vec*/, Dropout drop) {
  static_assert(DH % 16 == 0, "each of a row's 4 threads owns DH/16 float4 groups");
  constexpr int KS = f32_row_stride<DH>();
  constexpr int G = DH / 16;
  constexpr int SC = TILE / TPR;

  extern __shared__ __align__(16) float smem_f32[];
  float* Ks = smem_f32;
  float* Vs = Ks + TILE * KS;
  float* Qs = Vs + TILE * KS;
  float* Os = Qs + TILE * KS;
  float* Ps = Os + TILE * KS;
  float* Ds = Ps + TILE * PS;
  float* lse_s = Ds + TILE * PS;
  float* del_s = lse_s + TILE;

  const int r = threadIdx.x / TPR;
  const int cg = threadIdx.x % TPR;
  const int kv0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  load_tile_f32<DH, F32_THREADS>(Ks, head_base(k, st, K_, b, h), st.s[K_ + 1], kv0, N);
  load_tile_f32<DH, F32_THREADS>(Vs, head_base(v, st, V_, b, h), st.s[V_ + 1], kv0, N);

  float4 acc_dk[G], acc_dv[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) acc_dk[gi] = acc_dv[gi] = make_float4(0.f, 0.f, 0.f, 0.f);

  const float* lse_bh = lse + ((int64_t)b * H + h) * N;
  const float* del_bh = delta + ((int64_t)b * H + h) * N;
  const float* krow = Ks + r * KS;
  const float* vrow = Vs + r * KS;
  float* prow = Ps + r * PS;
  float* drow = Ds + r * PS;
  const uint32_t key_x = DROP ? drop_k_term(drop, kv0 + r) + drop_bh_term(b * H + h) : 0u;
  const int n_tiles = (N + TILE - 1) / TILE;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * TILE;
    __syncthreads();
    load_tile_f32<DH, F32_THREADS>(Qs, head_base(q, st, Q_, b, h), st.s[Q_ + 1], q0, N);
    load_tile_f32<DH, F32_THREADS>(Os, head_base(dout, st, DO_, b, h), st.s[DO_ + 1], q0, N);
    for (int i = threadIdx.x; i < TILE; i += F32_THREADS) {
      const bool valid = q0 + i < N;
      lse_s[i] = valid ? lse_bh[q0 + i] : INFINITY;
      del_s[i] = valid ? del_bh[q0 + i] : 0.f;
    }
    __syncthreads();

    float s[SC], dp[SC];
#pragma unroll
    for (int j = 0; j < SC; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
      const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = cg + TPR * j;
        s[j] = dot4(kv, *reinterpret_cast<const float4*>(Qs + c * KS + d), s[j]);
        dp[j] = dot4(vv, *reinterpret_cast<const float4*>(Os + c * KS + d), dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int c = cg + TPR * j;
      const float p = expf(s[j] * scale - lse_s[c]);
      if constexpr (DROP) {
        const float ms = drop_keep(drop, key_x + drop_q_term(drop, q0 + c)) ? drop.inv_keep_prob : 0.f;
        prow[c] = p * ms;
        drow[c] = p * (dp[j] * ms - del_s[c]) * scale;
      } else {
        prow[c] = p;
        drow[c] = p * (dp[j] - del_s[c]) * scale;
      }
    }
    __syncwarp();                      // a row's 4 threads share one warp

#pragma unroll 4
    for (int qq = 0; qq < TILE; ++qq) {
      const float p = prow[qq];
      const float ds = drow[qq];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int c = 4 * (cg + TPR * gi);
        axpy4(acc_dv[gi], p, *reinterpret_cast<const float4*>(Os + qq * KS + c));
        axpy4(acc_dk[gi], ds, *reinterpret_cast<const float4*>(Qs + qq * KS + c));
      }
    }
  }

  const int n = kv0 + r;
  if (n < N) {
    const int64_t off = (((int64_t)b * N + n) * H + h) * DH;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int c = 4 * (cg + TPR * gi);
      *reinterpret_cast<float4*>(dk + off + c) = acc_dk[gi];
      *reinterpret_cast<float4*>(dv + off + c) = acc_dv[gi];
    }
  }
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(F32_THREADS, 1)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int N, int H, Strides st, float scale, int /*vec*/, Dropout drop) {
  constexpr int KS = f32_row_stride<DH>();
  constexpr int G = DH / 16;
  constexpr int SC = TILE / TPR;

  extern __shared__ __align__(16) float smem_f32[];
  float* Qs = smem_f32;
  float* Os = Qs + TILE * KS;
  float* Ks = Os + TILE * KS;
  float* Vs = Ks + TILE * KS;
  float* Ds = Vs + TILE * KS;

  const int r = threadIdx.x / TPR;
  const int cg = threadIdx.x % TPR;
  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  load_tile_f32<DH, F32_THREADS>(Qs, head_base(q, st, Q_, b, h), st.s[Q_ + 1], q0, N);
  load_tile_f32<DH, F32_THREADS>(Os, head_base(dout, st, DO_, b, h), st.s[DO_ + 1], q0, N);
  const int n = q0 + r;
  const int64_t idx = ((int64_t)b * H + h) * N + n;
  const float lse_r = n < N ? lse[idx] : INFINITY;
  const float del_r = n < N ? delta[idx] : 0.f;
  const uint32_t row_x = DROP ? drop_q_term(drop, n) + drop_bh_term(b * H + h) : 0u;

  float4 acc[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) acc[gi] = make_float4(0.f, 0.f, 0.f, 0.f);

  const float* qrow = Qs + r * KS;
  const float* orow = Os + r * KS;
  float* drow = Ds + r * PS;
  const int n_tiles = (N + TILE - 1) / TILE;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * TILE;
    __syncthreads();
    load_tile_f32<DH, F32_THREADS>(Ks, head_base(k, st, K_, b, h), st.s[K_ + 1], k0, N);
    load_tile_f32<DH, F32_THREADS>(Vs, head_base(v, st, V_, b, h), st.s[V_ + 1], k0, N);
    __syncthreads();

    float s[SC], dp[SC];
#pragma unroll
    for (int j = 0; j < SC; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
      const float4 ov = *reinterpret_cast<const float4*>(orow + d);
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = cg + TPR * j;
        s[j] = dot4(qv, *reinterpret_cast<const float4*>(Ks + c * KS + d), s[j]);
        dp[j] = dot4(ov, *reinterpret_cast<const float4*>(Vs + c * KS + d), dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int c = cg + TPR * j;
      const float p = (k0 + c) < N ? expf(s[j] * scale - lse_r) : 0.f;
      if constexpr (DROP) {
        const float ms = drop_keep(drop, row_x + drop_k_term(drop, k0 + c)) ? drop.inv_keep_prob : 0.f;
        drow[c] = p * (dp[j] * ms - del_r) * scale;
      } else {
        drow[c] = p * (dp[j] - del_r) * scale;
      }
    }
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
      const float ds = drow[kk];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        axpy4(acc[gi], ds, *reinterpret_cast<const float4*>(Ks + kk * KS + 4 * (cg + TPR * gi)));
      }
    }
  }

  if (n < N) {
    float* row = dq + (((int64_t)b * N + n) * H + h) * DH;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      *reinterpret_cast<float4*>(row + 4 * (cg + TPR * gi)) = acc[gi];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float *lse, *dlse;
  void *dq, *dk, *dv;
  float* delta;
  int B, N, H;
  Strides st;
  float scale;
  int vec;
  Dropout drop;
};

// The pre-pass both kernel families run first.
template <typename T>
cudaError_t launch_delta(const Args& a, int dh, cudaStream_t stream) {
  const void* ptrs[2] = {a.o, a.dout};
  const int64_t* s = a.st.s;
  const int64_t row_strides[6] = {s[O_], s[O_ + 1], s[O_ + 2], s[DO_], s[DO_ + 1], s[DO_ + 2]};
  const int vec = sizeof(T) == 2 && dh % 8 == 0 && vitax::rows_vectorizable(ptrs, 2, row_strides, 6);
  const int64_t threads = (int64_t)a.B * a.N * a.H * (vec ? DELTA_TPR_VEC : DELTA_TPR);
  delta_kernel<T><<<(unsigned)((threads + DELTA_THREADS - 1) / DELTA_THREADS), DELTA_THREADS, 0, stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.dlse, a.delta, a.B, a.N, a.H, dh, a.st, vec);
  return cudaGetLastError();
}

template <typename T, int DH, bool DROP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err = launch_delta<T>(a, DH, stream);
  if (err != cudaSuccess) return err;

  const dim3 grid((a.N + TILE - 1) / TILE, a.H, a.B);
  constexpr bool TC = sizeof(T) == 2;
  constexpr int threads = TC ? TC_THREADS : F32_THREADS;
  constexpr size_t smem_dkdv = TC ? tc_smem_bytes<DH>() : f32_dkdv_smem_bytes<DH>();
  constexpr size_t smem_dq = TC ? tc_smem_bytes<DH>() : f32_dq_smem_bytes<DH>();
  void (*dkdv)(const T*, const T*, const T*, const T*, const float*, const float*, T*, T*, int, int,
               Strides, float, int, Dropout);
  void (*dqk)(const T*, const T*, const T*, const T*, const float*, const float*, T*, int, int,
              Strides, float, int, Dropout);
  if constexpr (TC) {
    dkdv = bwd_dkdv_bf16_kernel<DH, DROP>;
    dqk = bwd_dq_bf16_kernel<DH, DROP>;
  } else {
    dkdv = bwd_dkdv_f32_kernel<DH, DROP>;
    dqk = bwd_dq_f32_kernel<DH, DROP>;
  }
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  dkdv<<<grid, threads, smem_dkdv, stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
                                             static_cast<T*>(a.dv), a.N, a.H, a.st, a.scale, a.vec, a.drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  dqk<<<grid, threads, smem_dq, stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq),
                                          a.N, a.H, a.st, a.scale, a.vec, a.drop);
  return cudaGetLastError();
}

template <typename T, bool DROP>
cudaError_t dispatch_dh(int dh, const Args& a, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16, DROP>(a, stream);
    case 32: return launch<T, 32, DROP>(a, stream);
    case 64: return launch<T, 64, DROP>(a, stream);
    case 80: return launch<T, 80, DROP>(a, stream);
    case 128: return launch<T, 128, DROP>(a, stream);
    case 160: return launch<T, 160, DROP>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int dh, int drop, const Args& a, cudaStream_t stream) {
  return drop ? dispatch_dh<T, true>(dh, a, stream) : dispatch_dh<T, false>(dh, a, stream);
}

// The wgmma kernels: four tensor maps each (the streamed operands in boxes
// of the ring's rows, the owned ones in boxes of BR rows), after the delta
// pre-pass.
template <int DH, bool DROP>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  using D = DkdvCfg<DH>;
  using Q = DqCfg<DH>;
  constexpr int SW = D::SW, BQ = BwdTile<DH>::BQ, BK = BwdTile<DH>::BK;
  const int64_t* s = a.st.s;
  CUtensorMap kq, kk, kv, kdo, qq, qk, qv, qdo;
  auto view = [&](CUtensorMap* map, const void* base, int which, int rows) {
    return encode_view<SW>(map, base, DH, a.H, a.N, a.B, s[which], s[which + 1], s[which + 2], rows);
  };
  if (!view(&kq, a.q, Q_, BQ) || !view(&kk, a.k, K_, BR) || !view(&kv, a.v, V_, BR) ||
      !view(&kdo, a.dout, DO_, BQ) || !view(&qq, a.q, Q_, BR) || !view(&qk, a.k, K_, BK) ||
      !view(&qv, a.v, V_, BK) || !view(&qdo, a.dout, DO_, BR))
    return cudaErrorNotSupported;
  cudaError_t err = launch_delta<bf16>(a, DH, stream);
  if (err != cudaSuccess) return err;
  static const cudaError_t attr_dkdv = cudaFuncSetAttribute(
      bwd_dkdv_wgmma_kernel<DH, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, D::SMEM);
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      bwd_dq_wgmma_kernel<DH, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::SMEM);
  if (attr_dkdv != cudaSuccess) return attr_dkdv;
  if (attr_dq != cudaSuccess) return attr_dq;
  const dim3 grid((a.N + BR - 1) / BR, a.H, a.B);
  bwd_dkdv_wgmma_kernel<DH, DROP><<<grid, 384, D::SMEM, stream>>>(
      kq, kk, kv, kdo, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.N, a.H, a.scale,
      a.drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_wgmma_kernel<DH, DROP><<<grid, 384, Q::SMEM, stream>>>(
      qq, qk, qv, qdo, a.lse, a.delta, static_cast<bf16*>(a.dq), a.N, a.H, a.scale, a.drop);
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t dispatch_wgmma(int dh, const Args& a, cudaStream_t stream) {
  switch (dh) {
    case 64: return launch_wgmma<64, DROP>(a, stream);
    case 128: return launch_wgmma<128, DROP>(a, stream);
    case 160: return launch_wgmma<160, DROP>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 15 element strides, (batch,
// sequence, head) for q, k, v, o, then dout. dlse may be null (zero).
// delta is a (B, H, N) float32 scratch. drop != 0 runs the dropout
// instantiations with the forward's seed, offsets q0 and k0, threshold,
// float32(1 - rate) and its float32 reciprocal. kernel: 0 the general
// kernels (mma.sync for bfloat16, CUDA cores for float32), 1 the wgmma
// kernels (bfloat16, Dh 64, 128 or 160, a finite scale > 0, what TMA takes
// of q, k, v, o and dout: tma_takes); operands a kernel does not take are
// refused, never sent elsewhere. Returns a cudaError_t (0 = success); the
// three launches are asynchronous on `stream`.
int vitax_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, const float* dlse,
                         void* dq, void* dk, void* dv, float* delta,
                         int dtype, int B, int N, int H, int dh,
                         const int64_t* strides, float scale, int drop, uint32_t seed,
                         uint32_t q0, uint32_t k0, uint32_t threshold, float keep_prob,
                         float inv_keep_prob, int kernel, void* stream) {
  if (B < 1 || N < 1 || H < 1) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, lse, dlse, dq, dk, dv, delta, B, N, H, {}, scale, 0,
         {seed, q0, k0, threshold, keep_prob, inv_keep_prob}};
  for (int i = 0; i < 15; ++i) a.st.s[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 1) {
    const void* views[5] = {q, k, v, o, dout};
    if (dtype != 1 || !(scale > 0.f && scale < INFINITY) || !vitax::tma_takes(views, 5, strides, B, N, H))
      return (int)cudaErrorInvalidValue;
    return (int)(drop ? dispatch_wgmma<true>(dh, a, s) : dispatch_wgmma<false>(dh, a, s));
  }
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, dout};
  const int64_t tile_strides[12] = {strides[0], strides[1], strides[2], strides[3], strides[4],
                                    strides[5], strides[6], strides[7], strides[8], strides[12],
                                    strides[13], strides[14]};
  a.vec = vitax::rows_vectorizable(ptrs, 4, tile_strides, 12);
  if (dtype == 0) return (int)dispatch<float>(dh, drop, a, s);
  if (dtype == 1) return (int)dispatch<vitax::bf16>(dh, drop, a, s);
  return (int)cudaErrorInvalidValue;
}

const char* vitax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
