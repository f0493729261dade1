// Fused clip + AdamW for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces vitax/ops/fused_optimizer.py:fused_adamw_kernel (the TPU kernel
// fused_clip_adamw launches once per leaf group). Per float32 element of
// every parameter leaf, in optax's operand order:
//   g  <- g * clip_scale
//   mu <- (1 - b1) * g + b1 * mu
//   nu <- (1 - b2) * (g * g) + b2 * nu
//   p  <- p + ((-lr) * ((mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p)) * m
// with bc1 = 1 - b1^t, bc2 = 1 - b2^t and m the leaf's lr multiplier:
// optax's masked scale after AdamW, finetune's --backbone_lr_mult on the
// backbone's leaves and 1 elsewhere (x * 1 is exact, so m = 1 is the
// unscaled step bit for bit). p, mu and nu are updated in place: the port
// keeps one copy of the optimizer state, where the JAX package aliased its
// outputs onto its inputs.
//
// What bounds it on the card: 28 bytes an element (read p, g, mu, nu;
// write p, mu, nu) against ~20 FLOP, so it is memory-bound, at 21.12 ms
// for the 2.53B parameters of the 10B-width depth-8 model on an H100. The
// design moves each byte once: one launch per optimizer step covers every
// leaf through a small device table of (p, g, mu, nu, numel, first block,
// multiplier) rows; each 256-thread block updates one 4096-element chunk
// of one leaf with 16-byte loads where the leaf's four bases are 16-byte
// aligned, and scalar loads for the tail. The per-step scalars [clip_scale, lr, bc1,
// bc2] are read from a 4-float device tensor that the wrapper computes on
// the card from the global grad norm and the step count, so the step never
// waits on the host. b1, b2, eps and wd are kernel arguments.
//
// Every operation is an explicitly rounded single op (__fmul_rn, ...), so
// nvcc contracts nothing into an FMA and the result equals the plain
// PyTorch version, which runs each operation as its own kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t CHUNK = THREADS * 4 * 4;   // elements per block: 4 float4 per thread

struct Leaf {
  float* p;
  const float* g;
  float* mu;
  float* nu;
  int64_t numel;
  int64_t block0;   // first block of this leaf in the grid
  float mult;       // the lr multiplier, in the low half of the row's last int64
  int32_t pad;
};
static_assert(sizeof(Leaf) == 56, "the wrapper packs a leaf as 7 int64");

struct Hparams {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

__device__ __forceinline__ void adamw(float& p, float g, float& mu, float& nu, float clip, float neg_lr,
                                      float bc1, float bc2, float mult, const Hparams& hp) {
  g = __fmul_rn(g, clip);
  mu = __fadd_rn(__fmul_rn(hp.one_minus_b1, g), __fmul_rn(hp.b1, mu));
  nu = __fadd_rn(__fmul_rn(hp.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(hp.b2, nu));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), hp.eps);
  const float upd = __fadd_rn(__fdiv_rn(__fdiv_rn(mu, bc1), denom), __fmul_rn(hp.wd, p));
  p = __fadd_rn(p, __fmul_rn(__fmul_rn(neg_lr, upd), mult));
}

__global__ void __launch_bounds__(THREADS)
fused_adamw_kernel(const Leaf* __restrict__ leaves, int n_leaves, const float* __restrict__ scal,
                   Hparams hp) {
  __shared__ int leaf_idx;
  if (threadIdx.x == 0) {
    // the last leaf whose first block is at or before this one
    int lo = 0, hi = n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (leaves[mid].block0 <= (int64_t)blockIdx.x) lo = mid; else hi = mid - 1;
    }
    leaf_idx = lo;
  }
  __syncthreads();
  const Leaf L = leaves[leaf_idx];
  const float clip = scal[0];
  const float neg_lr = -scal[1];
  const float bc1 = scal[2];
  const float bc2 = scal[3];
  const int64_t start = ((int64_t)blockIdx.x - L.block0) * CHUNK;
  const int64_t end = start + CHUNK < L.numel ? start + CHUNK : L.numel;

  int64_t scalar_from = start;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(L.p) | reinterpret_cast<uintptr_t>(L.g) |
                          reinterpret_cast<uintptr_t>(L.mu) | reinterpret_cast<uintptr_t>(L.nu);
  if (bases % 16 == 0) {               // chunk starts are multiples of 4 elements
    const int64_t vec_end = start + ((end - start) & ~(int64_t)3);
    for (int64_t i = start + 4 * (int64_t)threadIdx.x; i < vec_end; i += 4 * THREADS) {
      float4 p = *reinterpret_cast<const float4*>(L.p + i);
      const float4 g = *reinterpret_cast<const float4*>(L.g + i);
      float4 mu = *reinterpret_cast<const float4*>(L.mu + i);
      float4 nu = *reinterpret_cast<const float4*>(L.nu + i);
      adamw(p.x, g.x, mu.x, nu.x, clip, neg_lr, bc1, bc2, L.mult, hp);
      adamw(p.y, g.y, mu.y, nu.y, clip, neg_lr, bc1, bc2, L.mult, hp);
      adamw(p.z, g.z, mu.z, nu.z, clip, neg_lr, bc1, bc2, L.mult, hp);
      adamw(p.w, g.w, mu.w, nu.w, clip, neg_lr, bc1, bc2, L.mult, hp);
      *reinterpret_cast<float4*>(L.p + i) = p;
      *reinterpret_cast<float4*>(L.mu + i) = mu;
      *reinterpret_cast<float4*>(L.nu + i) = nu;
    }
    scalar_from = vec_end;
  }
  for (int64_t i = scalar_from + threadIdx.x; i < end; i += THREADS) {
    float p = L.p[i], mu = L.mu[i], nu = L.nu[i];
    adamw(p, L.g[i], mu, nu, clip, neg_lr, bc1, bc2, L.mult, hp);
    L.p[i] = p;
    L.mu[i] = mu;
    L.nu[i] = nu;
  }
}

}  // namespace

extern "C" {

// Elements one block updates; the wrapper numbers each leaf's blocks
// (block0) with it.
int64_t vitax_fused_adamw_chunk() { return CHUNK; }

// leaves: device array of n_leaves rows (p, g, mu, nu, numel, block0,
// multiplier) as int64, the multiplier's float32 bits in the low half of
// the last, every numel > 0, block0 ascending; n_blocks = the last block0 plus
// that leaf's chunk count. scal: device float32[4] = [clip_scale, lr, 1 -
// b1^t, 1 - b2^t]. Returns a cudaError_t (0 = success); the launch is
// asynchronous on `stream`.
int vitax_fused_adamw(const void* leaves, int n_leaves, int64_t n_blocks, const float* scal,
                      float b1, float one_minus_b1, float b2, float one_minus_b2, float eps,
                      float wd, void* stream) {
  if (n_leaves < 1 || n_blocks < 1 || n_blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const Hparams hp{b1, one_minus_b1, b2, one_minus_b2, eps, wd};
  fused_adamw_kernel<<<(unsigned)n_blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), n_leaves, scal, hp);
  return (int)cudaGetLastError();
}

const char* vitax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
