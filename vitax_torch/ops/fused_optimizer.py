"""Fused clip+AdamW: the Hopper kernel and its plain version.

Counterpart of vitax/ops/fused_optimizer.py. The update runs in two
phases, as there:

- phase 1, plain PyTorch on the card: one global-norm reduction over every
  grad leaf (`global_norm`). It feeds the clip scale and the `grad_norm`
  metric.
- phase 2, the kernel (vitax_torch/csrc/fused_adamw.cu): clip-multiply,
  the AdamW moments, bias correction, decoupled weight decay and the
  parameter step in one pass over every element of every leaf, one launch
  per optimizer step, updating params, mu and nu in place.

The per-step scalars [clip_scale, lr, 1 - b1^t, 1 - b2^t] are a 4-float
tensor computed on the params' device from the global norm and the step
count (`step_scalars`), so the step never waits on the host. On a CUDA
tensor the dispatcher launches the kernel or raises; on a CPU tensor it
runs the plain version `clip_adamw_`, which is also the kernel's oracle on
the card. Numerics follow optax's chain(clip_by_global_norm, adamw) op for
op, with the JAX fused kernel's one deviation: the clip multiplies by the
precomputed clip_norm / norm where optax divides, then multiplies.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence, Tuple

import torch

from vitax_torch.ops import _build

KERNEL = "fused_adamw"

Hparams = Tuple[float, float, float, float]     # (b1, b2, eps, weight_decay)


def fused_optimizer_active(cfg, device) -> bool:
    """Whether the update on `device` launches the kernel: on a CUDA device
    it does, and on the CPU the dispatcher runs the plain version, whatever
    --fused_optimizer says. `off` is kept for the JAX package's flags, and
    raises on a CUDA device: the plain update does not run on the card."""
    on_card = torch.device(device).type == "cuda"
    if on_card and cfg.fused_optimizer == "off":
        raise ValueError("--fused_optimizer off: the port's update on the card is the fused clip+AdamW "
                         "kernel; the plain version runs on the CPU only (--device cpu)")
    return on_card


def global_norm(grads: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (optax.global_norm), an
    f32 scalar on the grads' device; one multi-tensor reduction. Sharded
    grads pass their local shards (padding is not in them) and `group`,
    the process group of the fsdp dim: the squared local norm is summed
    over it, so a dp replica is not counted twice. Without a group the
    norm is the local one."""
    norms = torch._foreach_norm(list(grads))
    norm = torch.linalg.vector_norm(torch.stack(norms))
    if group is None:
        return norm
    import torch.distributed as dist
    sq = norm * norm
    dist.all_reduce(sq, group=group)
    return sq.sqrt()


def step_scalars(count: torch.Tensor, grad_norm: torch.Tensor, schedule: Callable,
                 clip_norm: float, b1: float, b2: float) -> torch.Tensor:
    """[clip_scale, lr, 1 - b1^t, 1 - b2^t] as float32 (4,) on count's
    device, t = count + 1; lr is the schedule at the pre-increment count,
    where optax's scale_by_schedule reads it (vitax fused_clip_adamw). The
    bias corrections are computed in float64 and rounded once: in float32,
    one ulp of b2^t is 2e-5 of 1 - b2^t at t = 3, and XLA's float32 pow is
    that far off there."""
    t = (count + 1).to(torch.float64)
    lr = schedule(count).to(torch.float32)
    bc1 = (1.0 - torch.pow(b1, t)).float()
    bc2 = (1.0 - torch.pow(b2, t)).float()
    norm = grad_norm.to(torch.float32)
    if clip_norm and clip_norm > 0:
        clip_scale = torch.where(norm < clip_norm, torch.ones_like(norm), clip_norm / norm)
    else:
        clip_scale = torch.ones_like(norm)
    return torch.stack([clip_scale, lr, bc1, bc2])


@torch.no_grad()
def clip_adamw_(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                scal: torch.Tensor, hparams: Hparams) -> None:
    """Plain version of the kernel, in place on params, mu and nu, in
    optax's operand order (vitax/ops/fused_optimizer.py :120-127)."""
    b1, b2, eps, wd = hparams
    clip, lr, bc1, bc2 = scal.unbind(0)
    neg_lr = -lr
    for p, g, m, v in zip(params, grads, mu, nu):
        g = g * clip
        m.copy_((1.0 - b1) * g + b1 * m)
        v.copy_((1.0 - b2) * (g * g) + b2 * v)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p
        p.copy_(p + neg_lr * upd)


def _check_leaves(params, grads, mu, nu, scal) -> None:
    if not (len(params) == len(grads) == len(mu) == len(nu)) or not params:
        raise ValueError(f"{KERNEL}: params, grads, mu, nu must be equal-length, non-empty lists, got "
                         f"{len(params)}, {len(grads)}, {len(mu)}, {len(nu)}")
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL}: CUDA tensors only, got {dev}")
    for i, leaf in enumerate(zip(params, grads, mu, nu)):
        for name, x in zip(("param", "grad", "mu", "nu"), leaf):
            if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
                raise ValueError(f"{KERNEL}: leaf {i} {name} must be contiguous float32 on {dev}, "
                                 f"got {x.dtype} on {x.device}, contiguous={x.is_contiguous()}")
            if x.shape != leaf[0].shape:
                raise ValueError(f"{KERNEL}: leaf {i} {name} shape {tuple(x.shape)} != param "
                                 f"shape {tuple(leaf[0].shape)}")
    if scal.shape != (4,) or scal.dtype != torch.float32 or scal.device != dev or not scal.is_contiguous():
        raise ValueError(f"{KERNEL}: scal must be a contiguous float32 (4,) tensor on {dev}, "
                         f"got {scal.dtype} {tuple(scal.shape)} on {scal.device}")


def fused_adamw_cuda(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                     mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                     scal: torch.Tensor, hparams: Hparams) -> None:
    """One launch of the Hopper kernel over every leaf, in place on params,
    mu and nu. The leaf table (pointers, sizes, first block) is built on
    the host and copied to the card from pinned memory without a sync."""
    _check_leaves(params, grads, mu, nu, scal)
    b1, b2, eps, wd = hparams
    lib = _build.load(KERNEL)
    lib.vitax_fused_adamw_chunk.argtypes = []
    lib.vitax_fused_adamw_chunk.restype = ctypes.c_int64
    chunk = lib.vitax_fused_adamw_chunk()
    rows, block0 = [], 0
    for p, g, m, v in zip(params, grads, mu, nu):
        n = p.numel()
        if n == 0:
            continue
        rows.append((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n, block0))
        block0 += -(-n // chunk)
    if not rows:
        return
    dev = params[0].device
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    fn = lib.vitax_fused_adamw
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p] + \
        [ctypes.c_float] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(table.data_ptr(), len(rows), block0, scal.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2,
                 eps, wd, stream)
    _build.check(lib, KERNEL, err)
    _build.LAUNCHES[KERNEL] += 1


def fused_clip_adamw(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                     mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                     count: torch.Tensor, *, grad_norm: torch.Tensor, schedule: Callable,
                     clip_norm: float, weight_decay: float, b1: float, b2: float,
                     eps: float) -> torch.Tensor:
    """One clip+AdamW step over every leaf, in place on params, mu and nu;
    returns the incremented count. `grad_norm` is the phase-1 global norm
    of `grads`. A CUDA tensor goes to the kernel or raises; a CPU tensor
    goes to the plain version."""
    scal = step_scalars(count, grad_norm, schedule, clip_norm, b1, b2)
    hparams = (float(b1), float(b2), float(eps), float(weight_decay))
    dev = params[0].device
    if dev.type == "cuda":
        fused_adamw_cuda(params, grads, mu, nu, scal, hparams)
    elif dev.type == "cpu":
        clip_adamw_(params, grads, mu, nu, scal, hparams)
    else:
        raise ValueError(f"{KERNEL}: no path for device {dev}")
    return count + 1
