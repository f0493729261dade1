"""Attention core: the Hopper flash-attention kernels and their plain versions.

Counterpart of vitax/ops/attention.py. The kernels take the model's
(B, N, H, Dh) layout. On a CUDA tensor a dispatcher launches the
hand-written kernel (vitax_torch/csrc/flash_attn_fwd.cu for the forward,
flash_attn_bwd.cu for the backward) or raises; on a CPU tensor it runs the
plain version. There is no fallback from the card to the plain version.
`flash4_with_lse` is the differentiable core (the port of the JAX
package's custom-VJP flash4_with_lse): an autograd Function whose forward
and backward are those dispatchers.

Attention dropout runs inside the same kernels (a compile-time flag of
each): the keep-mask of score element (b, h, q, k) is the JAX package's
counter hash of (seed, b*H + h, q + q0, k + k0) (`dropout_keep_mask`), so
the backward regenerates the forward's mask and both are bit for bit the
JAX kernels' decisions. `flash4_dropout_lse` (kernels A6c/A6d) is the 4D
entry point. The BH entry points (`flash_bh_with_lse`, A3/A3b, and
`flash_bh_dropout_lse`, A6a/A6b) run the same kernels on (B*H, N, 1, Dh)
views of a (B*H, N, Dh) input, where the kernel's block index b*H + h is
the BH row, as the TPU kernel's program_id(0) is.

Past MAX_SEQ_IN_VMEM tokens `make_attention_impl` takes the streaming
entries of vitax_torch/ops/flash_blocked.py (the counterparts of the TPU
kernels A4, A5a and A5b), as the JAX package's `_select_path` does.

Each source holds two kernel families for bfloat16: the wgmma kernels (TMA
and wgmma, every main path) and the general mma.sync ones (float32 has its
own CUDA-core kernels, counted as general). `choose_fwd_kernel` and
`choose_bwd_kernel` pick one from the types, the head dim, the bases'
alignment, the strides and the scale's sign; a kernel forced on operands
it does not take raises, and nothing gives way to another kernel on a
failure.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vitax_torch.ops import _build

KERNEL = "flash_attn_fwd"
BWD_KERNEL = "flash_attn_bwd"
DROP_KERNEL = "flash_attn_fwd_drop"        # launch counters of the dropout instantiations
DROP_BWD_KERNEL = "flash_attn_bwd_drop"
# head dims the kernels are instantiated for (dispatch_dh in csrc/flash_attn_{fwd,bwd}.cu)
SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 128, 160)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The forward's and the backward's kernels (the C entries' `kernel`
# argument) and the head dims their wgmma kernels are built for
# (dispatch_wgmma in csrc/flash_attn_{fwd,bwd}.cu); the others take the
# general kernels.
FWD_KERNELS = {"general": 0, "wgmma": 1}
BWD_KERNELS = {"general": 0, "wgmma": 1}
WGMMA_HEAD_DIMS = (64, 128, 160)
TMA_ALIGN = 16                                  # bytes: TMA's base alignment and stride unit
_F32_MAX = float(np.finfo(np.float32).max)      # the C entry takes the scale as a float32
# The kernels' grid is (ceil(N / tile), H, B); CUDA caps its y and z sizes.
MAX_GRID_YZ = 65535
# vitax/ops/attention.py:41: past this many tokens the JAX package streams
# K/V blocks (vitax/ops/flash_blocked.py) instead of holding (N, N) scores.
MAX_SEQ_IN_VMEM = 2048
# Launch counters, (whole-N, whole-N dropout, streaming, streaming dropout),
# of the forward and of the backward call.
_FWD_KEYS = (KERNEL, DROP_KERNEL, *_build.STREAM_KERNELS[0::2])
_BWD_KEYS = (BWD_KERNEL, DROP_BWD_KERNEL, *_build.STREAM_KERNELS[1::2])

# ---------------------------------------------------------------------------
# in-kernel dropout RNG (vitax/ops/attention.py:78-132)
# ---------------------------------------------------------------------------
# The keep/drop decision of score element (q, k) of block bh is
#   fmix32(fmix32(((q+q0)*GOLD_Q + (k+k0)*GOLD_K + bh*GOLD_BH) ^ seed)) >= T
# in uint32 arithmetic, with T = min(int(rate * 2**32), 2**32 - 1). The
# kernels compute it in csrc/flash_common.cuh. Here uint32 values are held
# in int64 (torch has no uint32 >> on the CPU) and every product is taken
# in 16-bit halves, so nothing overflows int64.

_FMIX_C1 = 0x85EBCA6B
_FMIX_C2 = 0xC2B2AE35
_GOLD_Q = 0x9E3779B1
_GOLD_K = 0x85EBCA77
_GOLD_BH = 0xC2B2AE3D
_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for uint32 values x held in int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, _FMIX_C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _FMIX_C2)
    return x ^ (x >> 16)


def fold_shard_seed(index: int, seed: int) -> int:
    """Fold a shard's linearized index into a uint32 dropout seed (vitax
    fold_shard_seed): every rank sees the same local (batch, head) block
    indices, so without the fold two ranks would draw the same masks. The
    index is the rank's coordinate over the mesh dims that carry the batch
    (parallel/mesh.py batch_shard), as vitax linearizes its shard_map axes
    of size > 1; index 0 (one rank) leaves the seed as it is."""
    bits = _fmix32(_mul32(torch.tensor(int(index) & _MASK32), _GOLD_BH))
    return (int(seed) ^ int(bits)) & _MASK32


def dropout_threshold(rate: float) -> int:
    """T with P(bits < T) = rate, computed in Python as the JAX package does."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _keep(seed: int, bh: torch.Tensor, qi: torch.Tensor, kj: torch.Tensor, rate: float) -> torch.Tensor:
    """Bool keep decisions for broadcastable int64 block indices `bh`, query
    positions `qi` and key positions `kj` (global: offsets already added)."""
    x = (_mul32(qi & _MASK32, _GOLD_Q) + _mul32(kj & _MASK32, _GOLD_K)
         + _mul32(bh & _MASK32, _GOLD_BH)) & _MASK32
    bits = _fmix32(_fmix32(x ^ (int(seed) & _MASK32)))
    return bits >= dropout_threshold(rate)


def dropout_keep_mask(seed: int, bh_index: int, nq: int, nk: int, rate: float, transposed: bool = False,
                      q0: int = 0, k0: int = 0, device=None) -> torch.Tensor:
    """float32 {0, 1} keep-mask of one (batch, head) score block: (nq, nk),
    or (nk, nq) with the same element decisions when transposed (the 4D
    TPU kernel's score space). q0 and k0 offset the rows and columns to
    global token positions."""
    qi = torch.arange(nq, dtype=torch.int64, device=device) + q0
    kj = torch.arange(nk, dtype=torch.int64, device=device) + k0
    bh = torch.tensor(bh_index, dtype=torch.int64, device=device)
    if transposed:
        return _keep(seed, bh, qi[None, :], kj[:, None], rate).float()
    return _keep(seed, bh, qi[:, None], kj[None, :], rate).float()


class Dropout(NamedTuple):
    """Attention dropout of one call: the uint32 seed, the rate in (0, 1),
    and the global offsets of the call's first query and key row."""
    seed: int
    rate: float
    q0: int = 0
    k0: int = 0


def _seedvec(seed: int, q0: int = 0, k0: int = 0) -> Tuple[int, int, int]:
    """(seed, q0, k0) as uint32 values, the JAX package's seed vector."""
    return int(seed) & _MASK32, int(q0) & _MASK32, int(k0) & _MASK32


def keep_mask_bhqk(drop: Dropout, b: int, h: int, nq: int, nk: int, device) -> torch.Tensor:
    """float32 {0, 1} (B, H, Nq, Nk) keep-mask: block (b, h) has index
    b*H + h, as in both TPU kernel families (and the BH row of a (B*H, N,
    1, Dh) view)."""
    bh = torch.arange(b * h, dtype=torch.int64, device=device).view(b, h, 1, 1)
    qi = torch.arange(nq, dtype=torch.int64, device=device).view(nq, 1) + drop.q0
    kj = torch.arange(nk, dtype=torch.int64, device=device) + drop.k0
    return _keep(drop.seed, bh, qi, kj, drop.rate).float()


def _kernel_dropout_args(drop: Optional[Dropout]):
    """The dropout scalars of the kernels' C entry points: flag, seed, q0,
    k0, threshold, keep probability and its reciprocal, both float32 as the
    JAX kernels round them (1 - rate, and mask / (1 - rate) for a kept
    element)."""
    if drop is None:
        return 0, 0, 0, 0, 0, 1.0, 1.0
    seed, q0, k0 = _seedvec(drop.seed, drop.q0, drop.k0)
    keep_prob = np.float32(1.0 - drop.rate)
    return 1, seed, q0, k0, dropout_threshold(drop.rate), float(keep_prob), float(np.float32(1.0) / keep_prob)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense attention core, (B, N, H, Dh) -> (B, N, H, Dh): f32 scores,
    softmax, probabilities cast to the input type, then PV in that type
    (vitax/ops/attention.py reference_attention and the model's dense path)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def make_dense_dropout(rate: float) -> Callable:
    """Dense full-sequence attention with the kernels' counter-hash mask:
    (q, k, v, seed) -> o on (B, N, H, Dh), vitax/ops/attention.py
    make_dense_dropout: f32 softmax probabilities masked and scaled by
    1/(1 - rate), PV in f32, cast to the input type."""
    def dense_drop(q, k, v, seed):
        b, n, h, dh = q.shape
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh ** -0.5
        p = torch.softmax(s, dim=-1)
        mask = keep_mask_bhqk(Dropout(seed, rate), b, h, n, n, q.device)
        o = torch.einsum("bhqk,bkhd->bqhd", p * mask / (1.0 - rate), v.float())
        return o.to(q.dtype)
    return dense_drop


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """float32 for bf16/f32 inputs (the kernels' accumulation type); float64
    stays float64, so the plain path can be gradchecked."""
    return torch.promote_types(x.dtype, torch.float32)


def attention_fwd_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                           dropout: Optional[Dropout] = None,
                           normalize_first: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: f32 scores, max, exp, sum, PV
    with f32 accumulation; o (B, N, H, Dh) in the input type and the
    unmasked lse (B, H, N) float32. With normalize_first (the 4D kernels A1
    and A6c, vitax/ops/attention.py _fwd4_kernel / _fwd4_kernel_drop) P is
    normalised, masked and scaled by 1/(1 - rate) before its cast to the
    input type; without it (the BH kernels A3 and A6a, _fwd_kernel /
    _fwd_kernel_drop) the masked P is cast, and the product divided by
    l (1 - rate) afterwards."""
    acc = _acc_dtype(q)
    b, n, h, _ = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout is not None:
        mask = keep_mask_bhqk(dropout, b, h, n, k.shape[1], q.device).to(acc)
    if normalize_first:
        pn = p / l if dropout is None else (p * mask) / (l * (1.0 - dropout.rate))
        o = torch.einsum("bhqk,bkhd->bqhd", pn.to(v.dtype).to(acc), v.to(acc))
    else:
        pm = p if dropout is None else p * mask
        o = torch.einsum("bhqk,bkhd->bhqd", pm.to(v.dtype).to(acc), v.to(acc))
        o = (o / (l if dropout is None else l * (1.0 - dropout.rate))).transpose(1, 2)
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def attention_bwd_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                           lse: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor],
                           scale: float, dropout: Optional[Dropout] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel, in A2's order and at A2's cast
    points (vitax/ops/attention.py _bwd4_kernel :318-345): P = exp(S - lse)
    from f32 scores; P and dO rounded to the input type for dV = P^T dO;
    dP = dO V^T; delta = rowsum(dO * O) in f32; dS = P (dP - delta + dlse)
    * scale, rounded to the input type for dQ = dS K and dK = dS^T Q; every
    product accumulates in f32. dlse None means zero. With dropout (A6b and
    A6d, _bwd_kernel_drop / _bwd4_kernel_drop) the regenerated mask scaled
    by 1/(1 - rate), ms, enters twice: dV = (P ms)^T dO and dS = P (dP ms -
    delta + dlse) * scale; delta needs no change. Returns dq, dk, dv
    (B, N, H, Dh) in the input type."""
    acc = _acc_dtype(q)
    dt = q.dtype
    b, n, h, _ = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    p = torch.exp(s - lse.to(acc)[..., None])                                # (B, H, Nq, Nk)
    if dropout is not None:
        ms = keep_mask_bhqk(dropout, b, h, n, k.shape[1], q.device).to(acc) / (1.0 - dropout.rate)
    a = p if dropout is None else p * ms
    dob = do.to(dt).to(acc)
    dv = torch.einsum("bhqk,bqhd->bkhd", a.to(dt).to(acc), dob)
    dp = torch.einsum("bqhd,bkhd->bhqk", dob, v.to(acc))
    if dropout is not None:
        dp = dp * ms
    delta = (do.to(acc) * o.to(acc)).sum(dim=-1).transpose(1, 2)            # (B, H, Nq)
    g = dp - delta[..., None]
    if dlse is not None:
        g = g + dlse.to(acc)[..., None]
    ds = (p * g * scale).to(dt).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(acc))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc))
    return dq.to(dt), dk.to(dt), dv.to(dt)


def check_grid(kernel: str, b: int, n: int, h: int) -> None:
    """Raise unless a (B, N, H, Dh) call fits the kernels' grid (ceil(N /
    tile), H, B): B and H at most MAX_GRID_YZ each. On a (B*H, N, 1, Dh) BH
    view, B is the B*H row count."""
    if b > MAX_GRID_YZ or h > MAX_GRID_YZ:
        raise ValueError(f"{kernel}: batch {b} and heads {h} must each be <= {MAX_GRID_YZ}, the CUDA "
                         f"grid's y/z limit (grid (ceil(N/tile), H, B); on a BH view B is the B*H rows)")


def _check_kernel_inputs(kernel: str, **xs: torch.Tensor) -> None:
    """The (B, N, H, Dh) operands a kernel takes: one CUDA device, one type
    (float32 or bfloat16), one shape, a built head dim, a contiguous head
    axis, a shape that fits the grid."""
    names = ", ".join(xs)
    ts = list(xs.values())
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"{kernel}: CUDA tensors only, got {q.device}")
    if any(x.device != q.device for x in ts):
        raise ValueError(f"{kernel}: {names} on different devices {[str(x.device) for x in ts]}")
    if any(x.dtype != q.dtype for x in ts) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{kernel}: takes float32 or bfloat16 {names} of one type, "
                         f"got {[x.dtype for x in ts]}")
    if q.dim() != 4 or any(x.shape != q.shape for x in ts):
        raise ValueError(f"{kernel}: {names} must share one (B, N, H, Dh) shape, "
                         f"got {[tuple(x.shape) for x in ts]}")
    b, n, h, dh = q.shape
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{kernel}: head dim {dh} not built (supported: {SUPPORTED_HEAD_DIMS})")
    if min(b, n, h) < 1:
        raise ValueError(f"{kernel}: empty input {tuple(q.shape)}")
    check_grid(kernel, b, n, h)
    for name, x in xs.items():
        if x.stride(3) != 1:
            raise ValueError(f"{kernel}: {name}'s head axis must be contiguous, strides {x.stride()}")


_DROPOUT_ARGTYPES = [ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                     ctypes.c_float, ctypes.c_float]


def launch_key(n: int, dropout: Optional[Dropout], backward: bool) -> str:
    """The `_build.LAUNCHES` key a kernel call of sequence length n counts
    under: the whole-N keys up to MAX_SEQ_IN_VMEM tokens, the streaming ones
    (`_build.STREAM_KERNELS`) past it, where make_attention_impl takes the
    streaming entries; each with its dropout twin."""
    keys = _BWD_KEYS if backward else _FWD_KEYS
    return keys[2 * (n > MAX_SEQ_IN_VMEM) + (dropout is not None)]


def _wgmma_operands(xs, head_dim: int, scale: Optional[float]) -> bool:
    """Whether a wgmma kernel takes these (B, N, H, Dh) views: bfloat16, a
    head dim it is built for, a finite scale > 0 (it puts the scale into the
    exponent; None is the default Dh ** -0.5), and what TMA asks of each
    view: a 16-byte-aligned base and the stride of every dimension longer
    than 1 a multiple of 16 bytes (8 elements)."""
    if any(x.dtype != torch.bfloat16 for x in xs) or head_dim not in WGMMA_HEAD_DIMS:
        return False
    if scale is not None and not (0.0 < scale <= _F32_MAX and np.float32(scale) > 0):   # as the C entry sees it
        return False
    unit = TMA_ALIGN // xs[0].element_size()
    return all(x.data_ptr() % TMA_ALIGN == 0
               and all(size == 1 or stride % unit == 0 for size, stride in zip(x.shape[:3], x.stride()[:3]))
               for x in xs)


def wgmma_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None) -> bool:
    """Whether the forward's wgmma kernel takes these (B, N, H, Dh)
    operands (`_wgmma_operands`: it takes the max of the raw scores and
    puts the scale into the exponent). Reads types, shapes, strides and
    addresses only, so it works on tensors of any device."""
    return _wgmma_operands((q, k, v), q.shape[-1], scale)


def bwd_wgmma_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
                    scale: Optional[float] = None) -> bool:
    """Whether the backward's wgmma kernels take these (B, N, H, Dh)
    operands: `_wgmma_operands` of q, k, v, o and dO. dO's layout is the one
    autograd hands over (`_FlashWithLse.backward`), so it is read like the
    others."""
    return _wgmma_operands((q, k, v, o, do), q.shape[-1], scale)


def choose_fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None) -> str:
    """The forward kernel one launch takes, a plain host-side function of
    the types, the head dim, the alignment, the strides and the scale:
    "wgmma" where `wgmma_takes`, else "general" (the mma.sync kernel for
    bfloat16, the CUDA-core kernel for float32)."""
    return "wgmma" if wgmma_takes(q, k, v, scale) else "general"


def choose_bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
                      scale: Optional[float] = None) -> str:
    """The backward kernels one call takes, as `choose_fwd_kernel`:
    "wgmma" where `bwd_wgmma_takes`, else "general"."""
    return "wgmma" if bwd_wgmma_takes(q, k, v, o, do, scale) else "general"


_forced = {KERNEL: None, BWD_KERNEL: None}


@contextlib.contextmanager
def _forcing(which: str, names, kernel: Optional[str]) -> Iterator[None]:
    if kernel is not None and kernel not in names:
        raise ValueError(f"{which}: no kernel {kernel!r}; one of {sorted(names)}")
    before, _forced[which] = _forced[which], kernel
    try:
        yield
    finally:
        _forced[which] = before


def forced_fwd_kernel(kernel: Optional[str]):
    """Every forward launch inside the block takes `kernel` (a FWD_KERNELS
    name; None restores `choose_fwd_kernel`), through whichever entry calls
    it: the checks and timings that hold each kernel in turn. A launch whose
    operands the kernel does not take raises."""
    return _forcing(KERNEL, FWD_KERNELS, kernel)


def forced_bwd_kernel(kernel: Optional[str]):
    """`forced_fwd_kernel` for the backward calls (a BWD_KERNELS name)."""
    return _forcing(BWD_KERNEL, BWD_KERNELS, kernel)


def _resolve(which: str, names, kernel: Optional[str], chosen: Callable[[], str], takes: Callable[[], bool],
             operands: str) -> str:
    kernel = kernel or _forced[which]
    if kernel is None:
        return chosen()
    if kernel not in names:
        raise ValueError(f"{which}: no kernel {kernel!r}; one of {sorted(names)}")
    if kernel == "wgmma" and not takes():
        raise ValueError(f"{which}: wgmma does not take {operands} (it needs bfloat16, Dh in {WGMMA_HEAD_DIMS}, a "
                         f"finite scale > 0, {TMA_ALIGN}-byte-aligned bases and strides a multiple of "
                         f"{TMA_ALIGN} bytes)")
    return kernel


def _described(xs, scale) -> str:
    return (f"{xs[0].dtype} (B, N, H, Dh) {tuple(xs[0].shape)} with strides {[x.stride() for x in xs]} and "
            f"scale {scale}")


def resolve_fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kernel: Optional[str] = None,
                       scale: Optional[float] = None) -> str:
    """`kernel` (or the one `forced_fwd_kernel` set) checked against what it
    takes, else `choose_fwd_kernel`'s choice. An unknown name, or the wgmma
    kernel asked for operands it does not take, raises: nothing is sent
    elsewhere."""
    return _resolve(KERNEL, FWD_KERNELS, kernel, lambda: choose_fwd_kernel(q, k, v, scale),
                    lambda: wgmma_takes(q, k, v, scale), _described((q, k, v), scale))


def resolve_bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
                       kernel: Optional[str] = None, scale: Optional[float] = None) -> str:
    """`resolve_fwd_kernel` for the backward: `kernel` (or the one
    `forced_bwd_kernel` set) checked against `bwd_wgmma_takes`, else
    `choose_bwd_kernel`'s choice."""
    return _resolve(BWD_KERNEL, BWD_KERNELS, kernel, lambda: choose_bwd_kernel(q, k, v, o, do, scale),
                    lambda: bwd_wgmma_takes(q, k, v, o, do, scale), _described((q, k, v, o, do), scale))


def flash_attn_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                        dropout: Optional[Dropout] = None,
                        kernel: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch a Hopper forward kernel on strided (B, N, H, Dh) CUDA views,
    its dropout instantiation when `dropout` is given: `kernel` (a
    FWD_KERNELS name) or `resolve_fwd_kernel`'s choice. Returns (o
    contiguous (B, N, H, Dh) in the input type, lse (B, H, N) f32). The
    launch counts under `launch_key` and under its kernel's key."""
    _check_kernel_inputs(KERNEL, q=q, k=k, v=v)
    kernel = resolve_fwd_kernel(q, k, v, kernel, float(scale))
    b, n, h, dh = q.shape
    lib = _build.load(KERNEL)
    fn = lib.vitax_flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, *_DROPOUT_ARGTYPES, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty((b, n, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 9)(*(s for x in (q, k, v) for s in x.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 _DTYPE_CODES[q.dtype], b, n, h, dh, strides, float(scale), *_kernel_dropout_args(dropout),
                 FWD_KERNELS[kernel], stream)
    _build.check(lib, KERNEL, err)
    _build.LAUNCHES[launch_key(n, dropout, backward=False)] += 1
    _build.LAUNCHES[f"{KERNEL}_{kernel}"] += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
                        dropout: Optional[Dropout] = None,
                        normalize_first: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward dispatcher, (B, N, H, Dh) -> (o, lse (B, H, N)), not
    differentiable. A CUDA tensor goes to the kernel or raises; a CPU
    tensor goes to the plain version (normalize_first picks the TPU
    kernel family whose order it follows; the card has one kernel)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return flash_attn_fwd_cuda(q, k, v, scale, dropout)
    if q.device.type == "cpu":
        return attention_fwd_with_lse(q, k, v, scale, dropout, normalize_first)
    raise ValueError(f"{KERNEL}: no path for device {q.device}")


def flash_attn_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor],
                        scale: float, dropout: Optional[Dropout] = None, kernel: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch a Hopper backward (one call = the delta pre-pass, the dK/dV
    kernel and the dQ kernel) on strided (B, N, H, Dh) CUDA views, their
    dropout instantiations when `dropout` is given: `kernel` (a BWD_KERNELS
    name) or `resolve_bwd_kernel`'s choice. dlse None means zero. Returns
    dq, dk, dv contiguous (B, N, H, Dh) in the input type. The call counts
    under `launch_key` and under its kernel's key."""
    _check_kernel_inputs(BWD_KERNEL, q=q, k=k, v=v, o=o, do=do)
    b, n, h, dh = q.shape
    for name, x in (("lse", lse), ("dlse", dlse)):
        if x is not None and (x.shape != (b, h, n) or x.dtype != torch.float32
                              or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{BWD_KERNEL}: {name} must be contiguous float32 ({b}, {h}, {n}) on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    kernel = resolve_bwd_kernel(q, k, v, o, do, kernel, float(scale))
    lib = _build.load(BWD_KERNEL)
    fn = lib.vitax_flash_attn_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, *_DROPOUT_ARGTYPES, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dq, dk, dv = (torch.empty((b, n, h, dh), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 15)(*(s for x in (q, k, v, o, do) for s in x.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), None if dlse is None else dlse.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                 _DTYPE_CODES[q.dtype], b, n, h, dh, strides, float(scale), *_kernel_dropout_args(dropout),
                 BWD_KERNELS[kernel], stream)
    _build.check(lib, BWD_KERNEL, err)
    _build.LAUNCHES[launch_key(n, dropout, backward=True)] += 1
    _build.LAUNCHES[f"{BWD_KERNEL}_{kernel}"] += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor],
                        scale: float, dropout: Optional[Dropout] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward dispatcher: a CUDA tensor goes to the kernel or raises;
    a CPU tensor goes to the plain version."""
    if q.device.type == "cuda":
        return flash_attn_bwd_cuda(q, k, v, o, lse, do, dlse, scale, dropout)
    if q.device.type == "cpu":
        return attention_bwd_with_lse(q, k, v, o, lse, do, dlse, scale, dropout)
    raise ValueError(f"{BWD_KERNEL}: no path for device {q.device}")


class _FlashWithLse(torch.autograd.Function):
    """(o, lse) from a forward dispatcher `fwd(q, k, v, scale, dropout)`;
    the backward dispatcher `bwd(q, k, v, o, lse, do, dlse, scale,
    dropout)` takes both cotangents. Saves (q, k, v, o, lse), as the JAX
    custom VJPs do; under dropout the backward regenerates the mask from
    the seed."""

    @staticmethod
    def forward(ctx, q, k, v, scale, dropout, fwd, bwd):
        o, lse = fwd(q, k, v, scale, dropout)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.dropout = dropout
        ctx.bwd = bwd
        ctx.set_materialize_grads(False)    # an unused lse passes None, not zeros
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        elif do.stride(-1) != 1:            # autograd picks the cotangents' layouts; the
            do = do.contiguous()            # kernel reads dO by rows and dlse contiguous
        if dlse is not None:
            dlse = dlse.contiguous()
        dq, dk, dv = ctx.bwd(q, k, v, o, lse, do, dlse, ctx.scale, ctx.dropout)
        return dq, dk, dv, None, None, None, None


def flash4_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, H, Dh) attention returning (o, lse (B, H, N)), differentiable
    in both outputs: the port of vitax's flash4_with_lse."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashWithLse.apply(q, k, v, float(scale), None, flash_attention_fwd, flash_attention_bwd)


def flash4_dropout_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seedvec: Tuple[int, int, int],
                       scale: float, rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, H, Dh) attention with in-kernel attention dropout, returning
    (o, lse (B, H, N)), differentiable in both outputs (kernels A6c/A6d).
    seedvec: (seed, q0, k0) (_seedvec)."""
    seed, q0, k0 = seedvec
    return _FlashWithLse.apply(q, k, v, float(scale), Dropout(seed, float(rate), q0, k0), flash_attention_fwd,
                               flash_attention_bwd)


def flash4_dropout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: int, scale: float, rate: float,
                   q0: int = 0, k0: int = 0) -> torch.Tensor:
    """(B, N, H, Dh) attention with in-kernel attention dropout."""
    return flash4_dropout_lse(q, k, v, _seedvec(seed, q0, k0), scale, rate)[0]


def _fwd_bh_order(q, k, v, scale, dropout):
    return flash_attention_fwd(q, k, v, scale, dropout, normalize_first=False)


def _bh_call(q, k, v, scale, dropout):
    """The kernels on (BH, N, 1, Dh) views of (BH, N, Dh) operands; the
    plain version on the CPU follows the BH kernels' order."""
    o, lse = _FlashWithLse.apply(q[:, :, None], k[:, :, None], v[:, :, None], float(scale), dropout,
                                 _fwd_bh_order, flash_attention_bwd)
    return o[:, :, 0], lse[:, 0]


def flash_bh_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, N, Dh) attention returning (o, lse (BH, N)), differentiable in
    both outputs: kernels A3/A3b, as A1/A2 on the BH view."""
    return _bh_call(q, k, v, scale, None)


def flash_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    return flash_bh_with_lse(q, k, v, scale)[0]


def flash_bh_dropout_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seedvec: Tuple[int, int, int],
                         scale: float, rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, N, Dh) attention with in-kernel attention dropout, returning
    (o, lse (BH, N)): kernels A6a/A6b. Row i of the BH layout is block
    index i of the mask."""
    seed, q0, k0 = seedvec
    return _bh_call(q, k, v, scale, Dropout(seed, float(rate), q0, k0))


def flash_bh_dropout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: int, scale: float, rate: float,
                     q0: int = 0, k0: int = 0) -> torch.Tensor:
    return flash_bh_dropout_lse(q, k, v, _seedvec(seed, q0, k0), scale, rate)[0]


def _to_bh(x: torch.Tensor) -> torch.Tensor:
    """(B, N, H, Dh) -> (B*H, N, Dh)."""
    b, n, h, dh = x.shape
    return x.transpose(1, 2).reshape(b * h, n, dh)


def _from_bh(x: torch.Tensor, shape) -> torch.Tensor:
    """(B*H, N, Dh) -> (B, N, H, Dh)."""
    b, n, h, dh = shape
    return x.reshape(b, h, n, dh).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The attention core the model plugs in: (B, N, H, Dh) -> (B, N, H, Dh)."""
    return flash4_with_lse(q, k, v)[0]


flash_attention.vitax_name = "whole-N"


def _select_path(n: int) -> str:
    """The streaming branch of vitax/ops/attention.py _select_path: the
    streaming entries past MAX_SEQ_IN_VMEM tokens, the whole-N ones up to
    it. The JAX package's VMEM-driven choice between its 4D and BH kernels
    at N <= MAX_SEQ_IN_VMEM has no counterpart: the 4D entry serves them."""
    return "streaming" if n > MAX_SEQ_IN_VMEM else "4d"


def _named(fn: Callable, name: str) -> Callable:
    """A new impl calling `fn`, tagged with a name for the startup log."""
    def impl(q, k, v):
        return fn(q, k, v)
    impl.vitax_name = name
    return impl


def make_attention_impl(cfg, device) -> Optional[Callable]:
    """The attention core for this config on `device`, mirroring
    vitax/ops/attention.py make_attention_impl on one device: None (the
    model's dense path) when the flag is off; else the whole-N flash core
    up to MAX_SEQ_IN_VMEM tokens and the streaming one past it
    (`_select_path`, as `_tpu_kernel` chooses), named by `vitax_name` for
    the startup log. With --att_dropout > 0 the returned core carries
    `vitax_dropout`, (q, k, v, seed) -> o through the dropout kernels of
    the same path (`_tpu_dropout_kernel`), which the model runs when it is
    given seeds. On the card the kernels must have the head dim built; that
    is checked here, once, instead of at the first step or request."""
    if not cfg.use_flash_attention:
        return None
    dh = cfg.embed_dim // cfg.num_heads
    if torch.device(device).type == "cuda" and dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"use_flash_attention: the {KERNEL} kernel has no head dim {dh} "
                         f"(supported: {SUPPORTED_HEAD_DIMS}); pass --no_flash_attention")
    rate = float(cfg.att_dropout)
    if _select_path(cfg.num_patches) == "streaming":
        from vitax_torch.ops.flash_blocked import blocked_dropout_attention, blocked_flash_attention
        kernel = blocked_flash_attention

        def drop(q, k, v, seed):
            return blocked_dropout_attention(q, k, v, seed, rate)
    else:
        kernel = flash_attention

        def drop(q, k, v, seed):
            return flash4_dropout(q, k, v, seed, q.shape[-1] ** -0.5, rate)
    if rate <= 0.0:
        return kernel
    impl = _named(kernel, kernel.vitax_name)
    impl.vitax_dropout = drop
    return impl
