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
// m + log(l) of the unmasked scores, as in the JAX kernels. The rate-0
// instantiations are the code they were before dropout existed.
//
// What bounds it on the card: at the 10B serve shape (B=8, N=256, H=32,
// Dh=160, bf16) the call does 10.74 GFLOP against 84.1 MB of q, k, v, o and
// lse traffic, 128 FLOP per byte, below the H100's ~295 in bf16: it is
// memory-bound. The design keeps the (N, N) scores out of device memory:
// each CTA owns a 64-query tile, streams 64-key K/V tiles through shared
// memory and keeps the running max m, the running sum l and the f32 output
// accumulator on chip (online softmax), dividing by l once at the end. So
// device memory sees q, k, v read once per query tile and o, lse written once.
//
// q, k, v are strided (B, N, H, Dh) views (the model passes slices of the
// (B, N, 3, H, Dh) qkv projection output, never copied); the last axis must
// be contiguous. o is written contiguous (B, N, H, Dh) in the input type,
// lse contiguous (B, H, N) in float32. Any N >= 1 works: rows and key
// columns past N are masked.
//
// Two kernels, one per input type:
// - bfloat16 (the serve path): tensor cores through mma.sync m16n8k16 with
//   f32 accumulation; 4 warps, 16 query rows each; scores, softmax state
//   and the output accumulator live in registers, and P goes from the score
//   accumulators straight into the PV product's A operand. V stays
//   row-major in shared memory, as loaded; ldmatrix.trans reads it as the
//   PV product's B operand.
// - float32: CUDA-core FMAs from shared memory, exact f32 throughout.
// wgmma, TMA and a pipelined K/V ring are later work. Numerics: A1
// normalises P before the PV product; these kernels divide by l after it
// (and round the unnormalised P to bf16 for the bf16 product), which differs
// by about one bf16 ulp of the output.
//
// Dropout costs integer instructions: each score element needs its own hash
// (two fmix32, about 19 INT32 operations), 1.28 G operations at the train
// shape, which is near the call's bytes bound on the card's INT32 lanes. The row's
// hash terms are computed once per row; the per-element part sits in the
// softmax loop, after the row sum, where P is cleared for dropped keys.

#include "flash_common.cuh"

namespace {

using namespace vitax;

constexpr int BM = TILE;        // query rows per CTA
constexpr int BN = TILE;        // key rows per K/V tile

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync)
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 9 element strides, (batch,
// sequence, head) for q, then k, then v. drop != 0 runs the dropout
// instantiation with the seed, the global offsets q0 and k0 of the first
// query and key row, the uint32 threshold, float32(1 - rate) and its
// float32 reciprocal. Returns a cudaError_t (0 = success); the launch is
// asynchronous on `stream`.
int vitax_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int dtype, int B, int N, int H, int dh,
                         const int64_t* strides, float scale, int drop, uint32_t seed,
                         uint32_t q0, uint32_t k0, uint32_t threshold, float keep_prob,
                         float inv_keep_prob, void* stream) {
  if (B < 1 || N < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[3] = {q, k, v};
  const int vec = vitax::rows_vectorizable(ptrs, 3, strides, 9);
  const vitax::Dropout d{seed, q0, k0, threshold, keep_prob, inv_keep_prob};
  if (dtype == 0) return (int)dispatch<float>(dh, q, k, v, o, lse, B, N, H, strides, scale, vec, drop, d, s);
  if (dtype == 1) return (int)dispatch<vitax::bf16>(dh, q, k, v, o, lse, B, N, H, strides, scale, vec, drop, d, s);
  return (int)cudaErrorInvalidValue;
}

const char* vitax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
