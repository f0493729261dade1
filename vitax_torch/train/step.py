"""Train and eval steps (vitax/train/step.py).

One train step: forward in cfg.dtype over the float32 master weights, CE
mean over float32 logits, backward (recomputing each block under
grad_ckpt), with K-microbatch accumulation in float32 when
grad_accum_steps > 1, then one global norm that feeds both the clip and
the grad_norm metric, then clip+AdamW through fused_clip_adamw: the Hopper
kernel on the card, its plain version on the CPU. Nothing in the step reads a
value back to the host: metrics stay tensors on the device until the loop
fetches them at a log step.

Under dropout (any rate above 0) each microbatch's forward gets
DropoutSeeds from `dropout_seeds(cfg, step, k)`, a function on the host of
(cfg.seed, the pre-step count, the microbatch index): the counterpart of
the JAX step's fold_in(fold_in(key(seed + 1), step), k) and the model's
per-block rng split, with seeds of the port's own. The same run, or a
resume at the same step, draws the same masks.

Under FSDP2 (a `mesh`), each rank's step runs on its slice of the global
batch: its loss is the local mean, FSDP2's reduce-scatter (or, for DP,
all-reduce) averages the grads over the ranks, the grad norm sums the
local shards' squares over the fsdp dim, and the loss metric is
all-reduced to the global mean. Every dropout seed of a rank is folded
with its batch shard index (ops/attention.py fold_shard_seed), so the
attention masks are vitax's for that shard, and the proj, mlp and pos
masks differ between ranks. grad_accum_steps > 1 reduce-scatters each
microbatch's grads and accumulates them sharded in float32, as vitax's
scan keeps its f32 accumulators sharded: grads never stand unsharded
across microbatches.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vitax_torch import distributed
from vitax_torch.config import Config
from vitax_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from vitax_torch.models.vit import DropoutSeeds
from vitax_torch.ops.attention import fold_shard_seed
from vitax_torch.ops.fused_optimizer import fused_clip_adamw, fused_optimizer_active, global_norm
from vitax_torch.parallel.mesh import batch_shard
from vitax_torch.parallel.sharding import fsdp_group
from vitax_torch.train.state import AdamW, TrainState

Batch = Dict[str, torch.Tensor]


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """ToTensor + Normalize for uint8 (B, H, W, 3) batches, on their device:
    f32 / 255, minus the ImageNet mean, over its std. Float inputs pass
    through unchanged."""
    if images.dtype != torch.uint8:
        return images
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std


def _needs_dropout(cfg: Config) -> bool:
    return (cfg.pos_dropout > 0) or (cfg.att_dropout > 0) or (cfg.mlp_dropout > 0)


def dropout_seeds(cfg: Config, step: int, k: int) -> DropoutSeeds:
    """The uint32 dropout seeds of microbatch k of the step taken at count
    `step`: one per block, and one for pos dropout, from numpy's
    SeedSequence over (cfg.seed + 1, step, k) (the JAX loop keys dropout
    with key(seed + 1)). Pure host arithmetic: no device read-back."""
    words = np.random.SeedSequence((cfg.seed + 1, step, k)).generate_state(cfg.num_blocks + 1, np.uint32)
    return DropoutSeeds(blocks=tuple(int(w) for w in words[1:]), pos=int(words[0]))


def shard_seeds(seeds: DropoutSeeds, index: int) -> DropoutSeeds:
    """`seeds` with the rank's batch shard index folded into each one
    (fold_shard_seed; index 0 leaves them as they are)."""
    if index == 0:
        return seeds
    return DropoutSeeds(blocks=tuple(fold_shard_seed(index, s) for s in seeds.blocks),
                        pos=fold_shard_seed(index, seeds.pos))


def _microbatch_split(batch: Batch, k_steps: int) -> List[Batch]:
    """K microbatches with the strided assignment of vitax's split:
    microbatch k holds samples k, k + K, k + 2K, ... (views, no copy)."""
    return [{name: x[k::k_steps] for name, x in batch.items()} for k in range(k_steps)]


def _make_update_fn(cfg: Config, optimizer: AdamW, device, mesh=None) -> Callable:
    """update(state, grads) -> grad_norm: one global-norm reduction feeds the
    clip and the metric; clip+AdamW updates the params, mu and nu in place
    and advances state.count and state.step. Sharded, both run on the
    rank's local shards."""
    fused_optimizer_active(cfg, device)       # raises for --fused_optimizer off on the card
    group = fsdp_group(mesh)

    def update(state: TrainState, grads: List[torch.Tensor]) -> torch.Tensor:
        _, params, mu, nu = state.leaves()
        grad_norm = global_norm(grads, group)
        state.count = fused_clip_adamw(
            params, grads, mu, nu, state.count, grad_norm=grad_norm,
            schedule=optimizer.schedule, clip_norm=optimizer.clip_grad_norm,
            weight_decay=optimizer.weight_decay, b1=optimizer.b1, b2=optimizer.b2,
            eps=optimizer.eps)
        state.step += 1
        return grad_norm

    return update


def make_train_step(cfg: Config, optimizer: AdamW, device, mesh=None) -> Callable[[TrainState, Batch], tuple]:
    """train_step(state, batch) -> (state, metrics): metrics `loss` and
    `grad_norm` are device tensors, `lr_step` the post-step count (the
    reference logs lr after lr_scheduler.step()), `images` and `tokens` the
    step's work counts (the global batch's). The state is updated in place
    and returned. Under dropout, microbatch k of the step at count
    `state.step` runs with dropout_seeds(cfg, state.step, k), folded with
    the rank's batch shard index under a `mesh` (the batch is then the
    rank's slice of the global batch)."""
    update = _make_update_fn(cfg, optimizer, device, mesh)
    k_steps = cfg.grad_accum_steps
    dropout = _needs_dropout(cfg)
    shard, ranks = batch_shard(mesh)

    def seeds_for(step: int, k: int) -> Optional[DropoutSeeds]:
        return shard_seeds(dropout_seeds(cfg, step, k), shard) if dropout else None

    def loss_fn(model, batch: Batch, seeds: Optional[DropoutSeeds]) -> torch.Tensor:
        logits = model(prepare_images(batch["image"]), seeds)
        return F.cross_entropy(logits.float(), batch["label"])

    def train_step(state: TrainState, batch: Batch):
        model = state.model
        model.zero_grad(set_to_none=True)
        if k_steps == 1:
            loss = loss_fn(model, batch, seeds_for(state.step, 0))
            loss.backward()
            loss = loss.detach()
        else:
            # per-microbatch backward, grads summed in float32 in p.grad
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for k, mb in enumerate(_microbatch_split(batch, k_steps)):
                loss_k = loss_fn(model, mb, seeds_for(state.step, k))
                loss_k.backward()
                loss = loss + loss_k.detach()
            loss = loss * (1.0 / k_steps)
            for g in state.grads():
                g.mul_(1.0 / k_steps)
        if ranks > 1:                        # the global batch's mean
            loss = distributed.all_reduce_sum(loss) / ranks
        grad_norm = update(state, state.grads())
        metrics = {"loss": loss, "grad_norm": grad_norm, "lr_step": state.step,
                   "images": cfg.batch_size, "tokens": cfg.batch_size * cfg.num_patches}
        return state, metrics

    return train_step


def make_eval_step(cfg: Config) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """eval_step(state, batch) -> {"correct", "correct_top5"}: prediction
    counts over the batch, device tensors (top-5 clamps to the class count)."""
    k5 = min(5, cfg.num_classes)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        logits = state.model(prepare_images(batch["image"]))
        label = batch["label"]
        pred = logits.argmax(dim=-1)
        top5 = logits.topk(k5, dim=-1).indices
        return {"correct": (pred == label).sum(),
                "correct_top5": (top5 == label[:, None]).any(dim=-1).sum()}

    return eval_step
