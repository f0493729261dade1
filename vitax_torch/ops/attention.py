"""Attention core: the Hopper flash-attention kernels and their plain versions.

Counterpart of vitax/ops/attention.py. All functions take the model's
(B, N, H, Dh) layout. On a CUDA tensor a dispatcher launches the
hand-written kernel (vitax_torch/csrc/flash_attn_fwd.cu for the forward,
flash_attn_bwd.cu for the backward) or raises; on a CPU tensor it runs the
plain version. There is no fallback from the card to the plain version.
`flash4_with_lse` is the differentiable core (the port of the JAX
package's custom-VJP flash4_with_lse): an autograd Function whose forward
and backward are those dispatchers.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from vitax_torch.ops import _build

KERNEL = "flash_attn_fwd"
BWD_KERNEL = "flash_attn_bwd"
# head dims the kernels are instantiated for (dispatch_dh in csrc/flash_attn_{fwd,bwd}.cu)
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


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """float32 for bf16/f32 inputs (the kernels' accumulation type); float64
    stays float64, so the plain path can be gradchecked."""
    return torch.promote_types(x.dtype, torch.float32)


def attention_fwd_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel, in A1's order
    (vitax/ops/attention.py _fwd4_kernel): f32 scores, max, exp, normalise,
    cast to the input type, PV with f32 accumulation. Returns o (B, N, H, Dh)
    in the input type and lse (B, H, N) float32."""
    acc = _acc_dtype(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pn = (p / l).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", pn.to(acc), v.to(acc)).to(q.dtype)
    return o, (m + torch.log(l))[..., 0]


def attention_bwd_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                           lse: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor],
                           scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel, in A2's order and at A2's cast
    points (vitax/ops/attention.py _bwd4_kernel :318-345): P = exp(S - lse)
    from f32 scores; P and dO rounded to the input type for dV = P^T dO;
    dP = dO V^T; delta = rowsum(dO * O) in f32; dS = P (dP - delta + dlse)
    * scale, rounded to the input type for dQ = dS K and dK = dS^T Q; every
    product accumulates in f32. dlse None means zero. Returns dq, dk, dv
    (B, N, H, Dh) in the input type."""
    acc = _acc_dtype(q)
    dt = q.dtype
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    p = torch.exp(s - lse.to(acc)[..., None])                                # (B, H, Nq, Nk)
    dob = do.to(dt).to(acc)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).to(acc), dob)
    dp = torch.einsum("bqhd,bkhd->bhqk", dob, v.to(acc))
    delta = (do.to(acc) * o.to(acc)).sum(dim=-1).transpose(1, 2)            # (B, H, Nq)
    g = dp - delta[..., None]
    if dlse is not None:
        g = g + dlse.to(acc)[..., None]
    ds = (p * g * scale).to(dt).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(acc))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc))
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_kernel_inputs(kernel: str, **xs: torch.Tensor) -> None:
    """The (B, N, H, Dh) operands a kernel takes: one CUDA device, one type
    (float32 or bfloat16), one shape, a built head dim, a contiguous head
    axis."""
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
    for name, x in xs.items():
        if x.stride(3) != 1:
            raise ValueError(f"{kernel}: {name}'s head axis must be contiguous, strides {x.stride()}")


def flash_attn_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper forward kernel on strided (B, N, H, Dh) CUDA views.
    Returns (o contiguous (B, N, H, Dh) in the input type, lse (B, H, N) f32)."""
    _check_kernel_inputs(KERNEL, q=q, k=k, v=v)
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
    """The forward dispatcher, (B, N, H, Dh) -> (o, lse (B, H, N)), not
    differentiable. A CUDA tensor goes to the kernel or raises; a CPU
    tensor goes to the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return flash_attn_fwd_cuda(q, k, v, scale)
    if q.device.type == "cpu":
        return attention_fwd_with_lse(q, k, v, scale)
    raise ValueError(f"{KERNEL}: no path for device {q.device}")


def flash_attn_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor],
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the Hopper backward kernel (one call = the delta pre-pass, the
    dK/dV kernel and the dQ kernel) on strided (B, N, H, Dh) CUDA views.
    dlse None means zero. Returns dq, dk, dv contiguous (B, N, H, Dh) in the
    input type."""
    _check_kernel_inputs(BWD_KERNEL, q=q, k=k, v=v, o=o, do=do)
    b, n, h, dh = q.shape
    for name, x in (("lse", lse), ("dlse", dlse)):
        if x is not None and (x.shape != (b, h, n) or x.dtype != torch.float32
                              or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{BWD_KERNEL}: {name} must be contiguous float32 ({b}, {h}, {n}) on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    lib = _build.load(BWD_KERNEL)
    fn = lib.vitax_flash_attn_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dq, dk, dv = (torch.empty((b, n, h, dh), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 15)(*(s for x in (q, k, v, o, do) for s in x.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), None if dlse is None else dlse.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                 _DTYPE_CODES[q.dtype], b, n, h, dh, strides, float(scale), stream)
    _build.check(lib, BWD_KERNEL, err)
    _build.LAUNCHES[BWD_KERNEL] += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor],
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward dispatcher: a CUDA tensor goes to the kernel or raises;
    a CPU tensor goes to the plain version."""
    if q.device.type == "cuda":
        return flash_attn_bwd_cuda(q, k, v, o, lse, do, dlse, scale)
    if q.device.type == "cpu":
        return attention_bwd_with_lse(q, k, v, o, lse, do, dlse, scale)
    raise ValueError(f"{BWD_KERNEL}: no path for device {q.device}")


class _Flash4WithLse(torch.autograd.Function):
    """(o, lse) from the forward dispatcher; the backward dispatcher takes
    both cotangents. Saves (q, k, v, o, lse), as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
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
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, dlse, ctx.scale)
        return dq, dk, dv, None


def flash4_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, H, Dh) attention returning (o, lse (B, H, N)), differentiable
    in both outputs: the port of vitax's flash4_with_lse."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Flash4WithLse.apply(q, k, v, float(scale))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The attention core the model plugs in: (B, N, H, Dh) -> (B, N, H, Dh)."""
    return flash4_with_lse(q, k, v)[0]


def make_attention_impl(cfg, device) -> Optional[Callable]:
    """The attention core for this config on `device`, mirroring
    vitax/ops/attention.py _tpu_kernel's use_flash_attention policy: None
    (the model's dense path) when the flag is off, else the flash dispatcher.
    On the card the kernels must have the head dim built; that is checked
    here, once, instead of at the first step or request."""
    if not cfg.use_flash_attention:
        return None
    dh = cfg.embed_dim // cfg.num_heads
    if torch.device(device).type == "cuda" and dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"use_flash_attention: the {KERNEL} kernel has no head dim {dh} "
                         f"(supported: {SUPPORTED_HEAD_DIMS}); pass --no_flash_attention")
    return flash_attention
