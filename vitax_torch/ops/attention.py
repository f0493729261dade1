"""Attention core: the Hopper flash-attention forward and its plain version.

Counterpart of vitax/ops/attention.py. All functions take the model's
(B, N, H, Dh) layout. On a CUDA tensor the dispatcher launches the
hand-written kernel (vitax_torch/csrc/flash_attn_fwd.cu) or raises; on a
CPU tensor it runs the plain version. There is no fallback from the card
to the plain version, and no backward yet: the kernel serves the eval
forward only.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from vitax_torch.ops import _build

KERNEL = "flash_attn_fwd"
# head dims the kernel is instantiated for (csrc/flash_attn_fwd.cu dispatch_dh)
SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 128, 160)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense attention core, (B, N, H, Dh) -> (B, N, H, Dh): f32 scores,
    softmax, probabilities cast to the input type, then PV in that type
    (vitax/ops/attention.py reference_attention and the model's dense path)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attention_fwd_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, in A1's order (vitax/ops/attention.py
    _fwd4_kernel): f32 scores, max, exp, normalise, cast to the input type,
    PV with f32 accumulation. Returns o (B, N, H, Dh) in the input type and
    lse (B, H, N) float32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pn = (p / l).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", pn.float(), v.float()).to(q.dtype)
    return o, (m + torch.log(l))[..., 0]


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"{KERNEL}: q, k, v on different devices ({q.device}, {k.device}, {v.device})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{KERNEL}: takes float32 or bfloat16 q, k, v of one type, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"{KERNEL}: q, k, v must share one (B, N, H, Dh) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, n, h, dh = q.shape
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{KERNEL}: head dim {dh} not built (supported: {SUPPORTED_HEAD_DIMS})")
    if min(b, n, h) < 1:
        raise ValueError(f"{KERNEL}: empty input {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{KERNEL}: {name}'s head axis must be contiguous, strides {x.stride()}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(f"{KERNEL}: forward only; the backward kernel comes with the training "
                           f"slice (run under torch.no_grad() or torch.inference_mode())")


def flash_attn_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on strided (B, N, H, Dh) CUDA views.
    Returns (o contiguous (B, N, H, Dh) in the input type, lse (B, H, N) f32)."""
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL}: CUDA tensors only, got {q.device}")
    _check_kernel_inputs(q, k, v)
    b, n, h, dh = q.shape
    lib = _build.load(KERNEL)
    fn = lib.vitax_flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty((b, n, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 9)(*(s for x in (q, k, v) for s in x.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 _DTYPE_CODES[q.dtype], b, n, h, dh, strides, float(scale), stream)
    _build.check(lib, KERNEL, err)
    _build.LAUNCHES[KERNEL] += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, H, Dh) attention returning (o, lse (B, H, N)), the port's
    flash4_with_lse. A CUDA tensor goes to the kernel or raises; a CPU
    tensor goes to the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return flash_attn_fwd_cuda(q, k, v, scale)
    if q.device.type == "cpu":
        return attention_fwd_with_lse(q, k, v, scale)
    raise ValueError(f"{KERNEL}: no path for device {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The attention core the model plugs in: (B, N, H, Dh) -> (B, N, H, Dh)."""
    return flash_attention_fwd(q, k, v)[0]


def make_attention_impl(cfg, device) -> Optional[Callable]:
    """The attention core for this config on `device`, mirroring
    vitax/ops/attention.py _tpu_kernel's use_flash_attention policy: None
    (the model's dense path) when the flag is off, else the flash dispatcher.
    On the card the kernel must have the head dim built; that is checked
    here, once, instead of at the first request."""
    if not cfg.use_flash_attention:
        return None
    dh = cfg.embed_dim // cfg.num_heads
    if torch.device(device).type == "cuda" and dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"use_flash_attention: the {KERNEL} kernel has no head dim {dh} "
                         f"(supported: {SUPPORTED_HEAD_DIMS}); pass --no_flash_attention")
    return flash_attention
