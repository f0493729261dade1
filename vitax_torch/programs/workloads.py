"""Workload pieces of the scenario registry (vitax/programs/workloads.py).

- The head/backbone split: the `head` Linear (models/vit.py) is the one
  partition every transfer workload splits on.
- The masked optimizers, on the fused clip+AdamW kernel where vitax runs
  optax: the probe's trains the head only (moments for the head's leaves
  only, the backbone never written, the clip scale from the norm of every
  grad, as vitax's step clips before the masked chain); the finetune's
  multiplies the backbone's updates by --backbone_lr_mult after AdamW, a
  per-leaf multiplier in the kernel's leaf table.
- `warm_start_from_npz`: a consolidated npz export (quantized ones
  dequantized to f32) over the fresh state, leaf by leaf, in the export's
  keys and layouts, with the head re-initialized on --reinit_head or a new
  --num_classes and a loud failure on any other key or shape mismatch.
- `load_teacher` and `make_distill_step`: a frozen eval-mode teacher tower
  and the student's train step in one step, loss (1-alpha)*CE +
  alpha*T^2*KL(teacher||student) in f32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Iterable, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from vitax_torch import distributed
from vitax_torch.checkpoint.consolidate import load_npz
from vitax_torch.checkpoint.convert import jax_param_shapes, params_from_jax
from vitax_torch.config import Config
from vitax_torch.models.vit import VisionTransformer, build_model
from vitax_torch.ops.attention import make_attention_impl
from vitax_torch.parallel.mesh import tensor_shard
from vitax_torch.parallel.sharding import apply_fsdp, average_over_sp, local_shard, reshard, sp_group
from vitax_torch.train.state import AdamW, TrainState, build_optimizer, local
from vitax_torch.train.step import (UpdateTimer, _make_update_fn, _needs_dropout, dropout_seeds, prepare_images,
                                    seed_indices, shard_seeds)
from vitax_torch.utils.logging import master_print

# the classifier head's module name (models/vit.py VisionTransformer.head)
HEAD_NAME = "head"

Params = Union[nn.Module, Dict[str, torch.Tensor]]


def is_head(name: str) -> bool:
    """Is this parameter ("head.weight", "params/head/kernel") the head's?"""
    return HEAD_NAME in name.replace("/", ".").split(".")


def _named(params: Params) -> Iterable[Tuple[str, torch.Tensor]]:
    return params.named_parameters() if isinstance(params, nn.Module) else params.items()


def head_mask(params: Params) -> Dict[str, bool]:
    """{name: True on the classifier head's leaves}."""
    return {n: is_head(n) for n, _ in _named(params)}


def backbone_mask(params: Params) -> Dict[str, bool]:
    """{name: True on every non-head (backbone) leaf}."""
    return {n: not is_head(n) for n, _ in _named(params)}


def frozen_fraction(params: Params) -> float:
    """Fraction of parameter elements in the backbone (the frozen partition
    under --task probe), global under FSDP2."""
    frozen = total = 0
    for n, p in _named(params):
        total += p.numel()
        frozen += 0 if is_head(n) else p.numel()
    return frozen / total if total else 0.0


def _backbone_mult(mult: float, name: str) -> float:
    return 1.0 if is_head(name) else mult


def make_finetune_optimizer(cfg: Config, max_iteration: int) -> Tuple[AdamW, Callable]:
    """The train optimizer, the backbone's updates times
    cfg.backbone_lr_mult when it is not 1 (optax's masked scale after
    AdamW); the moments cover every leaf, as the train task's."""
    optimizer, schedule = build_optimizer(cfg, max_iteration)
    if cfg.backbone_lr_mult != 1.0:
        optimizer = dataclasses.replace(optimizer, lr_mult=functools.partial(_backbone_mult, cfg.backbone_lr_mult))
    return optimizer, schedule


def make_probe_optimizer(cfg: Config, max_iteration: int) -> Tuple[AdamW, Callable]:
    """The linear probe's optimizer: AdamW over the head's leaves only;
    the backbone has no moments and is never written (bitwise frozen)."""
    optimizer, schedule = build_optimizer(cfg, max_iteration)
    return dataclasses.replace(optimizer, trains=is_head), schedule


def _load_into(model: nn.Module, flat: Dict[str, torch.Tensor]) -> None:
    """Fill the model's params from export leaves (npz keys, JAX layouts),
    one key at a time: the leaf moved to the params' device, converted
    there (params_from_jax), each param it holds copied in (cast to the
    param's type, cut to the rank's shard of a DTensor)."""
    from torch.distributed.tensor import DTensor
    device = next(model.parameters()).device
    params = dict(model.named_parameters())
    with torch.no_grad():
        for key, leaf in flat.items():
            for name, src in params_from_jax({key: leaf.to(device)}).items():
                p = params[name]
                local(p).copy_(local_shard(src, p) if isinstance(p, DTensor) else src)


def warm_start_from_npz(cfg: Config, state: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """Overwrite the params of a freshly initialized state from the
    consolidated npz export cfg.init_npz, leaf by leaf, in the export's
    keys (scanned or unscanned blocks, as the file has them).

    Under FSDP2 each leaf is cut to the rank's shard. Non-head leaves
    must match by key and shape: an unknown export key, a
    missing key or a shape mismatch raises ValueError with vitax's message.
    Head leaves keep their fresh init on --reinit_head or when the export's
    shape differs (a new --num_classes). The moments stay at their fresh
    zeros. Returns (state, the kind "finetune" event's payload: init_npz,
    loaded, reinit, frozen_frac)."""
    flat_npz = load_npz(cfg.init_npz)
    scanned = any(k.startswith("params/blocks/") for k in flat_npz)
    fresh = jax_param_shapes(state.model.named_parameters(), scanned)
    unknown = sorted(set(flat_npz) - set(fresh))
    if unknown:
        raise ValueError(
            f"--init_npz {cfg.init_npz} carries keys absent from this model: {unknown[:5]}"
            f"{'...' if len(unknown) > 5 else ''} — the export was consolidated from a different architecture "
            f"(check the model shape flags)")
    loaded: Dict[str, torch.Tensor] = {}
    reinit = []
    for key, shape in fresh.items():
        src = flat_npz.get(key)
        if is_head(key) and (cfg.reinit_head or src is None or tuple(src.shape) != shape):
            reinit.append(key)                  # keeps the fresh head init
            continue
        if src is None:
            raise ValueError(
                f"--init_npz {cfg.init_npz} is missing param {key!r}: a partial export cannot warm-start a "
                f"finetune (re-export with vitax.checkpoint.consolidate --params_only)")
        if tuple(src.shape) != shape:
            raise ValueError(
                f"--init_npz {cfg.init_npz} param {key!r} has shape {tuple(src.shape)}, model expects {shape} "
                f"(only the head may differ — pass --reinit_head for a new --num_classes)")
        loaded[key] = src
    _load_into(state.model, loaded)
    info = {"init_npz": cfg.init_npz, "loaded": len(loaded), "reinit": sorted(reinit),
            "frozen_frac": frozen_fraction(state.model) if cfg.task == "probe" else 0.0}
    master_print(f"warm start: {info['loaded']} leaves from {cfg.init_npz}"
                 + (f", head re-initialized ({len(reinit)} leaves)" if reinit else ""))
    return state, info


def load_teacher(cfg: Config, device, mesh=None) -> VisionTransformer:
    """The distillation teacher: a VisionTransformer of the student's
    config with float32 params from the consolidated npz cfg.teacher_npz
    (quantized exports dequantized), in eval mode with no grad; under
    FSDP2 sharded with the student's policy (bf16 gathers). It is never in
    the optimizer, the checkpoint or the grad norm. Under sp it runs every
    token on each rank of the group (no token shard, the unsharded core):
    the same logits on each, at S times the teacher's work."""
    device = torch.device(device)
    flat = load_npz(cfg.teacher_npz)
    teacher = build_model(cfg, "meta", attention_impl=make_attention_impl(cfg, device),
                          tensor_shard=tensor_shard(mesh))
    if mesh is not None:
        apply_fsdp(teacher, cfg, mesh)
    teacher.to_empty(device=device)
    want = jax_param_shapes(teacher.named_parameters(), any(k.startswith("params/blocks/") for k in flat))
    differ = sorted(k for k in set(want) | set(flat) if want.get(k) != (tuple(flat[k].shape) if k in flat else None))
    if differ:
        raise ValueError(f"--teacher_npz {cfg.teacher_npz} does not hold this model's params: {differ[:5]}"
                         f"{'...' if len(differ) > 5 else ''} differ in key or shape (check the model shape flags)")
    _load_into(teacher, flat)
    master_print(f"distill: teacher params from {cfg.teacher_npz}")
    return teacher.requires_grad_(False).eval()


DISTILL_METRICS = ("kl", "ce", "teacher_top1", "student_top1")


def make_distill_step(cfg: Config, optimizer: AdamW, device, teacher: nn.Module, mesh=None) -> Callable[..., tuple]:
    """distill_step(state, batch, time_update=False) -> (state, metrics):
    the teacher's eval-mode logits without grad, then the student's train
    step (its dropout seeds, recompute, grad norm and fused update) on

        loss = (1 - alpha) * CE(student, labels)
               + alpha * T^2 * KL(softmax(teacher / T) || softmax(student / T))

    in float32, with vitax's operand order and its 1e-20 inside the
    teacher's log. Metrics: make_train_step's, and kl, ce, teacher_top1
    and student_top1 (device tensors, global means under a mesh)."""
    device = torch.device(device)
    update = _make_update_fn(cfg, optimizer, device, mesh)
    dropout = _needs_dropout(cfg)
    att_index, gen_index = seed_indices(cfg, mesh)
    sp = sp_group(mesh)
    alpha, temp = cfg.distill_alpha, cfg.distill_temp

    def distill_step(state: TrainState, batch: Dict[str, torch.Tensor], time_update: bool = False):
        model = state.model
        model.zero_grad(set_to_none=True)
        images = prepare_images(batch["image"])
        labels = batch["label"]
        with torch.no_grad():
            t_logits = teacher(images).float()
        reshard(teacher)                        # a forward without a backward leaves ZeRO-2's and DP's gathers
        t_soft = torch.softmax(t_logits / temp, dim=-1)
        seeds = shard_seeds(dropout_seeds(cfg, state.step, 0), att_index, gen_index) if dropout else None
        logits = model(images, seeds).float()
        ce = F.cross_entropy(logits, labels)
        s_log_soft = torch.log_softmax(logits / temp, dim=-1)
        kl = (temp * temp) * torch.mean(torch.sum(t_soft * (torch.log(t_soft + 1e-20) - s_log_soft), dim=-1))
        loss = (1.0 - alpha) * ce + alpha * kl
        loss.backward()
        average_over_sp(state.grads(), sp)
        stats = torch.stack([loss.detach(), ce.detach(), kl.detach(),
                             (t_logits.argmax(dim=-1) == labels).float().mean(),
                             (logits.detach().argmax(dim=-1) == labels).float().mean()])
        if mesh is not None:                    # the global batch's means (an sp group's ranks hold one)
            stats = distributed.all_reduce_sum(stats) / distributed.process_count()
        metrics = {"loss": stats[0], **dict(zip(("ce", "kl", "teacher_top1", "student_top1"), stats[1:])),
                   "images": cfg.batch_size, "tokens": cfg.batch_size * cfg.num_patches}
        if time_update:
            with UpdateTimer(device) as metrics["opt_update"]:
                metrics["grad_norm"] = update(state, state.grads())
        else:
            metrics["grad_norm"] = update(state, state.grads())
        metrics["lr_step"] = state.step
        return state, metrics

    return distill_step
