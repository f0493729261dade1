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

Under MoE (cfg.moe_experts > 0) the loss is CE plus moe_aux_weight times
the Switch load-balance loss, E * sum over blocks and experts of
frac_tokens * mean_prob, over the number of blocks (vitax/train/step.py
aux_from_frac_prob), its ingredients the model's per-block values,
averaged over the global batch before the product: under a mesh an
all-reduce over every rank (differentiable; `batch_mean`). With
grad_accum_steps > 1 they are averaged over the
microbatches too before the product, as vitax's accum_loss_moe
differentiates through its microbatch scan: each microbatch's forward
runs under one non-reentrant checkpoint that returns (CE, fracs, probs)
and keeps only its inputs, and one backward of the combined objective
recomputes each microbatch. Under expert parallelism (the mesh's "ep"
dim) the grads are brought to the global mean after the backward
(parallel/sharding.py average_over_ep) and the norm sums the expert
leaves' squares over the ep group too. Under sp the ingredients are
means over the rank's token slice and under tp the ranks of a group hold
the same ones: every process holds as many tokens, so their mean over the
processes is vitax's mean over the global (B, N) either way. Under sp the
pool's all-reduce hands each rank S times its tokens' CE cotangent and
average_over_sp divides the grads by S, while the all-reduce of
`batch_mean` hands each rank the aux's whole cotangent of the mean; the
grads then sum to vitax's for CE and aux alike (the router's and the
experts' among them).

Under sequence parallelism (the mesh's "sp" dim) the S ranks of an sp
group run the same batch rows on different token slices (models/vit.py).
After the backward (and the microbatches) the step averages their grad
shards over the group (parallel/sharding.py average_over_sp), so each
ends the step with vitax's grads and the grad norm over the fsdp dim
counts every element once. The loss is the same on every rank of a group,
so the global mean sums it over every process and divides by their count.
The seeds (`seed_indices`): the ring's attention seed folds the batch
shard only, as vitax's ring folds (dp, fsdp) and not sp (its masks are
decided at global token coordinates); Ulysses' folds the linearized
(batch, sp) index, as vitax's does; the proj, mlp and pos generators fold
(batch, sp) under either, so the token shards draw different masks.

Under tensor parallelism (the mesh's "tp" dim, models/vit.py) the T ranks
of a tp group run the same rows on different heads and MLP features.
Their grads need no reduction over the group: each holds its own shard of
the Megatron leaves and identical grads of the replicated ones. The grad
norm sums the Megatron leaves' squares over the tp group before the
fsdp sum, the replicated leaves counting once (ops/fused_optimizer.py
global_norm). The attention seed folds the tp index last, as vitax's
shard_map folds (*BATCH_AXES, "tp"); the generators do not fold it.

Under pipeline parallelism (the mesh's "pp" dim, a stage model) the step
runs the --pp_schedule (parallel/pipeline.py GPipe, pipeline_1f1b.py
1F1B) over the rank's rows split contiguously into --pp_microbatches,
each microbatch's backward inside it. After it the replicated leaves'
grads are summed over the stages (parallel/sharding.py average_over_pp,
a no-op elsewhere), then averaged over sp and ep as above, and the grad
norm sums the block leaves' squares over the stages. Microbatch k's dropout seeds are
`pp_seeds`: dropout_seeds(cfg, step, k) for every global block, folded
with vitax's pipeline shard index (the rank's linearized (dp, fsdp, ep,
sp) coordinate, which vitax folds into its pipeline key), attention and
generators alike. Only the last stage holds a loss: the metric's global
mean sums it over the processes and divides by those of one stage; under
MoE the aux the schedule formed (identical on every rank) is added.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vitax_torch import distributed
from vitax_torch.config import Config
from vitax_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from vitax_torch.models.vit import DropoutSeeds
from vitax_torch.ops.attention import fold_shard_seed, sp_core
from vitax_torch.ops.fused_optimizer import fused_clip_adamw, fused_optimizer_active, global_norm
from vitax_torch.parallel.mesh import batch_shard, dim_size, pipe_shard, pp_shard_index, sp_shard, tp_shard
from vitax_torch.parallel.sharding import (average_over_ep, average_over_pp, average_over_sp, ep_group, expert_flags,
                                           fsdp_group, pp_flags, pp_group, sp_group, tp_flags, tp_group)
from vitax_torch.train.state import AdamW, TrainState

Batch = Dict[str, torch.Tensor]
# the normalization constants on each device, made there once: a tensor made
# from host values is a blocking copy, which would stall every step's launches
_NORM: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """ToTensor + Normalize for uint8 (B, H, W, 3) batches, on their device:
    f32 / 255, minus the ImageNet mean, over its std. Float inputs pass
    through unchanged."""
    if images.dtype != torch.uint8:
        return images
    consts = _NORM.get(images.device)
    if consts is None:
        consts = _NORM[images.device] = (torch.as_tensor(IMAGENET_MEAN, device=images.device),
                                         torch.as_tensor(IMAGENET_STD, device=images.device))
    mean, std = consts
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


def shard_seeds(seeds: DropoutSeeds, index: int, gen_index: Optional[int] = None) -> DropoutSeeds:
    """`seeds` with the rank's shard index folded into each one
    (fold_shard_seed; index 0 leaves them as they are): `index` into the
    attention seeds, `gen_index` (default `index`) into the pos seed and
    the proj/mlp generators' seeds, given apart as `gens` when the two
    differ."""
    gen_index = index if gen_index is None else gen_index
    if index == gen_index == 0:
        return seeds
    blocks = tuple(fold_shard_seed(index, s) for s in seeds.blocks)
    gens = None if gen_index == index else tuple(fold_shard_seed(gen_index, s) for s in seeds.blocks)
    return DropoutSeeds(blocks=blocks, pos=fold_shard_seed(gen_index, seeds.pos), gens=gens)


def pp_seeds(cfg: Config, step: int, k: int, index: int) -> DropoutSeeds:
    """Microbatch k's dropout seeds of the step at count `step` on a
    pipeline rank whose pipeline shard index is `index`
    (parallel/mesh.py pp_shard_index): dropout_seeds(cfg, step, k), one
    a global block, with the index folded into every seed."""
    return shard_seeds(dropout_seeds(cfg, step, k), index)


def seed_indices(cfg: Config, mesh) -> tuple:
    """(attention index, generator index) that shard_seeds folds: the batch
    shard's, but under an sp core the generators fold (batch, sp)
    linearized, and so does Ulysses' attention seed; under tp the
    attention seed folds the tp index last ((batch, tp) for the ring and
    the unsharded core, (batch, sp, tp) for Ulysses, vitax's axis orders),
    the generators never (the activations they mask are replicated over tp)."""
    index, _ = batch_shard(mesh)
    s, count = sp_shard(mesh)
    t, tp = tp_shard(mesh)
    kind = sp_core(cfg, count, tp)
    gen = index if kind is None else index * count + s
    return (gen if kind == "ulysses" else index) * tp + t, gen


def aux_from_frac_prob(fracs: torch.Tensor, probs: torch.Tensor, cfg: Config) -> torch.Tensor:
    """The Switch load-balance loss from the (L, E) per-block ingredients:
    the mean over blocks of E * sum_e(frac_e * prob_e)
    (vitax/train/step.py:54-63)."""
    return cfg.moe_experts * (fracs * probs).sum() / cfg.num_blocks


def batch_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """A rank's mean over its tokens to the global batch's: the mean over
    every process, differentiable (the all-reduce's backward sums the
    cotangents). As it is without a mesh. MoE calls it on its
    load-balance ingredients: every process holds as many tokens (its
    batch rows, under sp its slice of their tokens), and the ranks of a tp
    group hold the same values, so the mean over the processes is the
    mean over the global batch's tokens."""
    if mesh is None:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t) / distributed.process_count()


def _microbatch_split(batch: Batch, k_steps: int) -> List[Batch]:
    """K microbatches with the strided assignment of vitax's split:
    microbatch k holds samples k, k + K, k + 2K, ... (views, no copy)."""
    return [{name: x[k::k_steps] for name, x in batch.items()} for k in range(k_steps)]


def _make_update_fn(cfg: Config, optimizer: AdamW, device, mesh=None) -> Callable:
    """update(state, grads) -> grad_norm: one global-norm reduction over
    every param's grad feeds the clip and the metric; clip+AdamW updates
    the params with moments (all of them, or the probe's head), their mu
    and nu in place, each step times the optimizer's lr_mult of its leaf,
    and advances state.count and state.step. Sharded, both run on the
    rank's local shards."""
    fused_optimizer_active(cfg, device)       # raises for --fused_optimizer off on the card
    group, ep, tp, pp = fsdp_group(mesh), ep_group(mesh), tp_group(mesh), pp_group(mesh)

    def update(state: TrainState, grads: List[torch.Tensor]) -> torch.Tensor:
        names, params, mu, nu = state.leaves()
        grad_norm = global_norm(grads, group, expert_flags(state.model) if ep is not None else None, ep,
                                tp_flags(state.model) if tp is not None else None, tp,
                                pp_flags(state.model) if pp is not None else None, pp)
        if len(names) != len(grads):          # the probe: the head's grads, clipped by every grad's norm
            trained = set(names)
            grads = [g for (n, _), g in zip(state.model.named_parameters(), grads) if n in trained]
        if state.staged:                      # B writes in place: a staged snapshot's copies land first
            stream = torch.cuda.current_stream()
            for ready in state.staged:
                stream.wait_event(ready)
            state.staged.clear()
        state.count = fused_clip_adamw(
            params, grads, mu, nu, state.count, grad_norm=grad_norm,
            schedule=optimizer.schedule, clip_norm=optimizer.clip_grad_norm,
            weight_decay=optimizer.weight_decay, b1=optimizer.b1, b2=optimizer.b2,
            eps=optimizer.eps, lr_mults=[optimizer.lr_mult(n) for n in names])
        state.step += 1
        return grad_norm

    return update


class UpdateTimer:
    """The seconds of one update(...) call: CUDA events around it on the
    card, read only once a later fetch has waited for the step (the events
    launch nothing), or the host clock on the CPU, where the call returns
    when done."""

    def __init__(self, device: torch.device):
        self._events = ((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                        if device.type == "cuda" else None)
        self._t0 = self._seconds = 0.0

    def __enter__(self) -> "UpdateTimer":
        if self._events is not None:
            self._events[0].record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record()
        else:
            self._seconds = time.perf_counter() - self._t0

    def seconds(self) -> float:
        if self._events is None:
            return self._seconds
        start, end = self._events
        end.synchronize()  # vtx: ignore[VTX101] read on the log step only, after its fetch waited for the step
        return start.elapsed_time(end) / 1e3


def make_train_step(cfg: Config, optimizer: AdamW, device, mesh=None) -> Callable[..., tuple]:
    """train_step(state, batch, time_update=False) -> (state, metrics):
    metrics `loss` and `grad_norm` are device tensors, `lr_step` the
    post-step count (the reference logs lr after lr_scheduler.step()),
    `images` and `tokens` the step's work counts (the global batch's), and
    with time_update `opt_update` an UpdateTimer around the step's update
    (the global norm and clip+AdamW: the loop's opt_update_s). The state is
    updated in place and returned. Under dropout, microbatch k of the step
    at count `state.step` runs with dropout_seeds(cfg, state.step, k),
    folded with the rank's batch shard index under a `mesh` (the batch is
    then the rank's slice of the global batch; `seed_indices` under sp,
    `pp_seeds` on a pipeline stage)."""
    device = torch.device(device)
    update = _make_update_fn(cfg, optimizer, device, mesh)
    pipeline = _pipeline_backward(cfg, device, mesh) if pipe_shard(mesh) is not None else None
    k_steps = cfg.grad_accum_steps
    dropout = _needs_dropout(cfg)
    att_index, gen_index = seed_indices(cfg, mesh)
    sp, ep, pp = sp_group(mesh), ep_group(mesh), pp_group(mesh)
    stages = dim_size(mesh, "pp")
    moe = cfg.moe_experts > 0

    def seeds_for(step: int, k: int) -> Optional[DropoutSeeds]:
        return shard_seeds(dropout_seeds(cfg, step, k), att_index, gen_index) if dropout else None

    def moe_terms(model, image: torch.Tensor, label: torch.Tensor, seeds: Optional[DropoutSeeds]):
        """(CE, fracs (L, E), probs (L, E)) of one forward, rank-local means."""
        logits, (fracs, probs) = model(prepare_images(image), seeds, with_aux=True)
        return F.cross_entropy(logits.float(), label), torch.stack(fracs), torch.stack(probs)

    def moe_objective(ce, fracs, probs) -> torch.Tensor:
        return ce + cfg.moe_aux_weight * aux_from_frac_prob(batch_mean(fracs, mesh), batch_mean(probs, mesh), cfg)

    def loss_fn(model, batch: Batch, seeds: Optional[DropoutSeeds]) -> torch.Tensor:
        if moe:
            return moe_objective(*moe_terms(model, batch["image"], batch["label"], seeds))
        logits = model(prepare_images(batch["image"]), seeds)
        return F.cross_entropy(logits.float(), batch["label"])

    def train_step(state: TrainState, batch: Batch, time_update: bool = False):
        model = state.model
        model.zero_grad(set_to_none=True)
        aux = None
        if pipeline is not None:
            loss, aux = pipeline(state, batch)
        elif moe and k_steps > 1:
            # the aux couples the microbatches: one backward through all of them
            terms = [checkpoint(moe_terms, model, mb["image"], mb["label"], seeds_for(state.step, k),
                                use_reentrant=False)
                     for k, mb in enumerate(_microbatch_split(batch, k_steps))]
            ces, fracs, probs = (torch.stack(t) for t in zip(*terms))
            loss = moe_objective(ces.mean(), fracs.mean(dim=0), probs.mean(dim=0))
            loss.backward()
            loss = loss.detach()
        elif k_steps == 1:
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
        average_over_pp(model, pp)
        average_over_sp(state.grads(), sp)
        if ep is not None:
            average_over_ep(state.grads(), expert_flags(model), ep)
        if mesh is not None:    # the global batch's mean: an sp or tp group's ranks hold one loss, the last stage's
            loss = distributed.all_reduce_sum(loss) / (distributed.process_count() // stages)
        if aux is not None:     # the pipeline's MoE aux, the same on every rank
            loss = loss + cfg.moe_aux_weight * aux
        metrics = {"loss": loss, "images": cfg.batch_size, "tokens": cfg.batch_size * cfg.num_patches}
        if time_update:
            with UpdateTimer(device) as metrics["opt_update"]:
                metrics["grad_norm"] = update(state, state.grads())
        else:
            metrics["grad_norm"] = update(state, state.grads())
        metrics["lr_step"] = state.step
        return state, metrics

    return train_step


def _pipeline_backward(cfg: Config, device: torch.device, mesh) -> Callable[[TrainState, Batch], tuple]:
    """backward(state, batch) -> (loss, aux) on a pipeline stage: the
    --pp_schedule's forwards and backwards over the rank's microbatches;
    the loss is the rank's mean CE on the last stage and 0 on the others,
    aux the MoE aux (None when dense)."""
    from vitax_torch.parallel.pipeline import Hop, Stage, check_batch, gpipe_step, microbatches
    from vitax_torch.parallel.pipeline_1f1b import one_f_one_b_step
    pipe = pipe_shard(mesh)
    m = check_batch(cfg, mesh, pipe)
    run = one_f_one_b_step if cfg.pp_schedule == "1f1b" else gpipe_step
    hop, dropout, index = Hop(pipe, device), _needs_dropout(cfg), pp_shard_index(mesh)

    def backward(state: TrainState, batch: Batch) -> tuple:
        step = state.step
        stage = Stage(state.model, cfg, pipe, hop, microbatches(prepare_images(batch["image"]), m),
                      microbatches(batch["label"], m), lambda k: pp_seeds(cfg, step, k, index) if dropout else None)
        aux = run(stage)
        return stage.loss, aux

    return backward


def make_eval_step(cfg: Config, mesh=None) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """eval_step(state, batch) -> {"correct", "correct_top5"}: prediction
    counts over the batch, device tensors (top-5 clamps to the class count).
    Under sp and tp the ranks of a group hold the same logits: only sp and
    tp index 0 count, so a sum over every process counts each row once. On
    a pipeline stage the batch runs through the stages' forwards
    (parallel/pipeline.py pipeline_logits) and only the last stage counts."""
    k5 = min(5, cfg.num_classes)
    pipe = pipe_shard(mesh)
    counts = sp_shard(mesh)[0] == 0 and tp_shard(mesh)[0] == 0 and (pipe is None or pipe.last)
    logits_of = None
    if pipe is not None:
        from vitax_torch.parallel.pipeline import Hop, Stage, check_batch, microbatches, pipeline_logits
        m = check_batch(cfg, mesh, pipe)

        def logits_of(model, images):
            hop = Hop(pipe, images.device)
            return pipeline_logits(Stage(model, cfg, pipe, hop, microbatches(images, m), None, lambda k: None))

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        images = prepare_images(batch["image"])
        logits = state.model(images) if logits_of is None else logits_of(state.model, images)
        label = batch["label"]
        if logits is None:                      # a pipeline stage before the last: no logits, no counts
            zero = torch.zeros((), dtype=torch.int64, device=label.device)
            return {"correct": zero, "correct_top5": zero}
        pred = logits.argmax(dim=-1)
        top5 = logits.topk(k5, dim=-1).indices
        return {"correct": (pred == label).sum() * counts,
                "correct_top5": (top5 == label[:, None]).any(dim=-1).sum() * counts}

    return eval_step
