"""Fused dequant matmul: the Hopper kernel and its plain versions.

Counterpart of vitax/ops/dequant_matmul.py. Every quantized Dense site of
the serve forward (qkv, proj, fc1, fc2 in each block, and the head)
computes

    out = (float(x @ W^T) * sx) * s        (float32, any leading dims of x)

from a stored int8 or float8 e4m3 weight W (the port's (out, in) layout)
and its per-output-channel float32 scale s, in one of two modes:

- weight-only: x as it comes (bfloat16 or float32), sx = 1;
- act: x quantized per tensor to int8 first (`quantize_activations`, plain
  PyTorch on the device, no host sync), then int8 x int8 summed exactly;
  int8 weights only.

On a CUDA tensor `dequant_matmul` launches vitax_torch/csrc/dequant_matmul.cu
or raises; on a CPU tensor it runs the plain version `dequant_matmul_plain`,
which is also the kernel's oracle on the card. The dequantized weight is
never materialised on the card's path.

The source holds two kernels. `choose_kernel` picks one on the host from
the shape, the types and the alignment alone: the wgmma kernel (TMA-fed,
warp-specialised) wherever TMA's rules hold, which every Dense site of the
serve models meets, and the general mma.sync kernel for ragged K,
misaligned bases and float32 x. A launch that fails raises; nothing falls
back to the other kernel or to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from vitax_torch.ops import _build

KERNEL = "dequant_matmul"

# stored weight types: int8 and the float8 e4m3 bit view (torch's only e4m3
# is e4m3fn; every finite code of the export's e4m3 decodes to the same value)
WEIGHT_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}
_X_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
# act mode sums K products of at most 127^2 in int32
MAX_ACT_K = (2 ** 31 - 1) // (127 * 127)
# The kernels of csrc/dequant_matmul.cu by their selector in the C entry
# point: the general kernel, and the wgmma kernel in two arrangements, each
# with 128 x 128 or 128 x 256 output tiles: "ss" (act mode, int8 x) reads
# both int8 operands from shared memory, "rs" (weight-only, bfloat16 x)
# converts the codes into registers as the A operand of the swapped product.
KERNELS = {"general": 0, "wgmma_ss_n128": 1, "wgmma_ss_n256": 2, "wgmma_rs_n128": 3, "wgmma_rs_n256": 4}
# TMA copies tiles from 16-byte-aligned bases whose rows are a multiple of
# 16 bytes apart: K % 16 for the 1-byte codes (and int8 x), K % 8 for bf16 x.
TMA_ALIGN = 16


def fused_dequant_active(cfg, device) -> bool:
    """Resolve --fused_dequant {auto,on,off} on `device` (vitax
    fused_dequant_active). On a CUDA device every quantized Dense site runs
    the kernel: auto and on mean on, and off raises, since the unfused path
    there would be a plain version on the main path. On the CPU, auto means
    off, as the JAX policy gives off a real-kernel backend, and on runs the
    kernel's plain version (the JAX package's interpret mode)."""
    if torch.device(device).type == "cuda":
        if cfg.fused_dequant == "off":
            raise ValueError(f"--fused_dequant off: the port's quantized serve matmuls on the card are "
                             f"the {KERNEL} kernel; the unfused path runs on the CPU only (--device cpu)")
        return True
    return cfg.fused_dequant == "on"


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor dynamic absmax quantization to int8 (vitax
    quantize_activations): sx = absmax / 127, or 1.0 for an all-zero
    tensor; codes round half to even and clip to [-127, 127]. sx stays a
    0-d float32 tensor on x's device: no host sync."""
    xf = x.float()
    absmax = xf.abs().amax()
    sx = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / 127.0)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def dequantize_leaf(w_q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`(w_q * scale)` in `dtype` (vitax/serve/quant.py dequantize_leaf);
    `scale` broadcasts against w_q. The unfused serve path's weight read."""
    return (w_q.to(dtype) * scale.to(dtype)).to(dtype)


def _matmul_plain(x2d: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  sx: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain versions of the kernel on 2-D operands. Weight-only:
    float32 operands and sums, then the epilogue. Act: every product is an
    integer of at most 127^2 and every partial sum stays below 2^53, so the
    float64 product is the exact integer sum, rounded once to float32 as
    the kernel's int32 -> float32 conversion rounds it."""
    if sx is None:
        return (x2d.float() @ w.float().t()) * scale
    acc = x2d.double() @ w.double().t()
    return (acc.float() * sx) * scale


def _check_kernel_inputs(x2d: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         sx: Optional[torch.Tensor]) -> None:
    ts = {"x": x2d, "w": w, "scale": scale} | ({"sx": sx} if sx is not None else {})
    if any(not t.is_contiguous() for t in ts.values()):
        raise ValueError(f"{KERNEL}: operands must be contiguous")
    if w.dtype not in WEIGHT_DTYPES or w.dim() != 2:
        raise ValueError(f"{KERNEL}: w must be a 2-D int8 or float8_e4m3fn (out, in) weight, "
                         f"got {w.dtype} {tuple(w.shape)}")
    if x2d.dim() != 2 or x2d.shape[1] != w.shape[1] or min(x2d.shape) < 1:
        raise ValueError(f"{KERNEL}: x {tuple(x2d.shape)} does not contract with w {tuple(w.shape)}")
    if scale.dtype != torch.float32 or scale.shape != (w.shape[0],):
        raise ValueError(f"{KERNEL}: scale must be float32 ({w.shape[0]},), got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if sx is None:
        if x2d.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{KERNEL}: weight-only mode takes bfloat16 or float32 x, got {x2d.dtype}")
    else:
        if x2d.dtype != torch.int8 or w.dtype != torch.int8:
            raise ValueError(f"{KERNEL}: act mode takes int8 x and int8 w, got {x2d.dtype} and {w.dtype}")
        if sx.dtype != torch.float32 or sx.numel() != 1:
            raise ValueError(f"{KERNEL}: sx must be a float32 scalar, got {sx.dtype} {tuple(sx.shape)}")
        if x2d.shape[1] > MAX_ACT_K:
            raise ValueError(f"{KERNEL}: act mode needs K <= {MAX_ACT_K} (int32 sums), got {x2d.shape[1]}")
    # the device last, so the checks above are reachable from a CPU test
    dev = x2d.device
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL}: CUDA tensors only, got {dev}")
    if any(t.device != dev for t in ts.values()):
        raise ValueError(f"{KERNEL}: operands on different devices {[str(t.device) for t in ts.values()]}")


def wgmma_takes(x2d: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether TMA's rules hold for these operands: bfloat16 or int8 x,
    16-byte-aligned bases, K % 16 == 0 (rows of codes a multiple of 16
    bytes)."""
    return (x2d.dtype in (torch.bfloat16, torch.int8) and x2d.shape[-1] % TMA_ALIGN == 0
            and x2d.data_ptr() % TMA_ALIGN == 0 and w.data_ptr() % TMA_ALIGN == 0)


# The time of a 128 x 256 tile over a 128 x 128 one, by arrangement,
# fitted to both tiles' times at the 10B model's four block sites at M 2048
# and M 256 (chip_smoke.py phase 4 on an H100 80GB HBM3 at 700 W, PERF.md);
# the SMs run whole waves of tiles.
TILE_256_COST = {"ss": 1.63, "rs": 1.47}
NUM_SMS = 132


def wgmma_tile(route: str, m: int, f: int) -> str:
    """The wgmma kernel's tile for an (m, f) output in arrangement `route`
    ("ss": 128 rows of x by 128 or 256 channels; "rs": 128 or 256 rows of
    x by 128 channels): the one whose waves over the H100's 132 SMs cost
    less, 256 on a tie."""
    def waves(n: int) -> int:
        tiles = -(-m // 128) * -(-f // n) if route == "ss" else -(-m // n) * -(-f // 128)
        return -(-tiles // NUM_SMS)
    return f"wgmma_{route}_n256" if TILE_256_COST[route] * waves(256) <= waves(128) else f"wgmma_{route}_n128"


def choose_kernel(x2d: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel one launch takes, a plain host-side function of the
    shape, the types and the alignment: where TMA's rules hold, the wgmma
    kernel, "rs" for bfloat16 x (weight-only) and "ss" for int8 x (act
    mode); elsewhere the general kernel. Works on tensors of any device."""
    if wgmma_takes(x2d, w):
        return wgmma_tile("rs" if x2d.dtype == torch.bfloat16 else "ss", x2d.shape[0], w.shape[0])
    return "general"


def kernel_takes(kernel: str, x2d: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether `kernel` (a KERNELS name) takes these operands: the general
    kernel takes every type the wrapper does, the wgmma kernel what TMA's
    rules allow, "rs" with bfloat16 x and "ss" with int8 x."""
    if kernel == "general":
        return True
    route = "rs" if x2d.dtype == torch.bfloat16 else "ss"
    return wgmma_takes(x2d, w) and kernel.startswith(f"wgmma_{route}_")


def resolve_kernel(x2d: torch.Tensor, w: torch.Tensor, kernel: Optional[str] = None) -> str:
    """`kernel` checked against what it takes, or `choose_kernel`'s choice
    when None. An unknown name, or a kernel asked for operands it does not
    take, raises: nothing is sent elsewhere."""
    if kernel is None:
        return choose_kernel(x2d, w)
    if kernel not in KERNELS:
        raise ValueError(f"{KERNEL}: no kernel {kernel!r}; one of {sorted(KERNELS)}")
    if not kernel_takes(kernel, x2d, w):
        raise ValueError(f"{KERNEL}: {kernel} does not take {x2d.dtype} x with K {x2d.shape[1]} (the wgmma kernel "
                         f"needs K % {TMA_ALIGN} == 0, {TMA_ALIGN}-byte-aligned x and w, and bfloat16 x for rs, "
                         f"int8 x for ss)")
    return kernel


def dequant_matmul_cuda(x2d: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                        sx: Optional[torch.Tensor] = None, kernel: Optional[str] = None) -> torch.Tensor:
    """One launch of the Hopper kernel: (M, K) x (F, K) -> (M, F) float32.
    sx None is weight-only (x bfloat16 or float32); a float32 scalar sx on
    the card is act mode (x int8 codes, int8 w). `kernel` (a KERNELS name)
    overrides `choose_kernel`, for checks and timing; a wgmma kernel asked
    for operands it does not take raises."""
    _check_kernel_inputs(x2d, w, scale, sx)
    kernel = resolve_kernel(x2d, w, kernel)
    m, k = x2d.shape
    f = w.shape[0]
    lib = _build.load(KERNEL)
    fn = lib.vitax_dequant_matmul
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((m, f), dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = fn(x2d.data_ptr(), _X_CODES[x2d.dtype], w.data_ptr(), WEIGHT_DTYPES[w.dtype],
                 scale.data_ptr(), sx.data_ptr() if sx is not None else None, out.data_ptr(), m, k, f,
                 KERNELS[kernel], stream)
    _build.check(lib, KERNEL, err)
    _build.LAUNCHES[KERNEL] += 1
    _build.LAUNCHES[KERNEL + ("_general" if kernel == "general" else "_wgmma")] += 1
    return out


def _prepare(x: torch.Tensor, w: torch.Tensor, act: bool):
    if w.dim() != 2:
        raise ValueError(f"{KERNEL}: wants a 2-D (out, in) weight, got {tuple(w.shape)}")
    if act and w.dtype != torch.int8:
        raise ValueError(f"{KERNEL}: act-quant needs int8 weights (the other int8 operand), got {w.dtype}")
    x2d = x.reshape(-1, x.shape[-1])
    if act:
        return quantize_activations(x2d)
    return x2d, None


def dequant_matmul_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, *,
                         act: bool = False) -> torch.Tensor:
    """The plain version of the whole call, leading dims kept: the CPU path,
    and the oracle `chip_smoke.py` holds the kernel to on the card."""
    x2d, sx = _prepare(x, w, act)
    return _matmul_plain(x2d, w, scale, sx).reshape(*x.shape[:-1], w.shape[0])


def dequant_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, *,
                   act: bool = False) -> torch.Tensor:
    """``x @ (W * scale)^T`` for a quantized (out, in) weight, without
    materialising the dequantized weight; float32 out with x's leading
    dims. act=True quantizes x per tensor and runs int8 x int8 (int8 weights
    only). A CUDA tensor goes to the kernel or raises; a CPU tensor goes to
    the plain version."""
    with _build.dispatch(KERNEL):
        if x.device.type == "cuda":
            x2d, sx = _prepare(x, w, act)
            return dequant_matmul_cuda(x2d.contiguous(), w, scale, sx).reshape(*x.shape[:-1], w.shape[0])
        if x.device.type == "cpu":
            return dequant_matmul_plain(x, w, scale, act=act)
        raise ValueError(f"{KERNEL}: no path for device {x.device}")


def make_quant_matmul(cfg) -> Callable:
    """The quant_matmul closure the model's QuantLinear calls (vitax
    make_quant_matmul): act mode resolved from cfg once; act=False sites
    (the head, whose f32 logits feed softmax) stay weight-only always."""
    act_mode = cfg.serve_act_quant == "int8"

    def quant_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, act: bool = True) -> torch.Tensor:
        return dequant_matmul(x, w, scale, act=act_mode and act)

    return quant_matmul
