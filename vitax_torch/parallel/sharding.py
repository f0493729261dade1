"""FSDP2 over the ViT (vitax/parallel/sharding.py), in torch's idiom.

vitax states ZeRO-3 as a PartitionSpec per parameter and lets GSPMD emit
the gathers; here `apply_fsdp` wraps the model with FSDP2's `fully_shard`:
one unit a Block, then the root.

- ZeRO-3 (default): each unit gathers its params before use and frees
  them after its forward, and again for the backward (recomputed under
  grad_ckpt); grads are reduce-scattered.
- ZeRO-2 (`--no_reshard_after_forward`): gathered params stay live from
  the forward through the backward; grads and AdamW state stay sharded.
- DP (`--run_without_fsdp`): HSDP over the (dp, fsdp) mesh with a shard
  group of 1: params replicated (gathered once a step and kept, as they
  are whole anyway), grads all-reduced over dp.

Under sequence parallelism FSDP2 runs on the (dp, fsdp) slice of the mesh
that holds the rank, so each sp rank keeps the same shards as its peers:
params are replicated over "sp", as vitax's specs replicate them. The sp
ranks of one batch shard see different tokens, so their grads differ;
`average_over_sp` averages the local grad shards over the sp group after
the backward (the step calls it before the grad norm), which with the
model's pool (an all-reduce whose backward sums) gives every rank vitax's
grads. It is one all-reduce a leaf, after FSDP2's reduce-scatter and not
overlapped with the backward (HSDP with (dp, sp) as the replicate dim
would overlap it, at the price of a mesh whose layout no longer follows
the ranks' order).

Expert parallelism (the mesh's "ep" dim, models/moe.py): dense params
are replicated over "ep" as over "sp", and their grads averaged over the
ep group after the backward (`average_over_ep`, the same one all-reduce a
leaf as sp's). Each MoE expert leaf (w1, b1, w2, b2) becomes, before
FSDP2 wraps it, a DTensor sharded on its experts dim over the ep group
(`shard_experts`), whose rank keeps E/ep experts for good; each MoeMlp
is then an FSDP2 unit of its own, which shards those local experts over
"fsdp" (FSDP2's TP/EP composition: its params are DTensors on the
(fsdp, ep) or (dp, fsdp, ep) mesh). An expert's grad already sums every
ep peer's tokens through the all-to-all's backward, so the step scales it
by 1/ep instead of averaging it, and the grad norm sums expert squares
over the ep group too (ops/fused_optimizer.py global_norm). At ep 1 the
expert leaves are plain params of their Block's unit. Under tp an
expert leaf is not a Megatron leaf (vitax's rule table puts no "tp" on
it): its DTensor lies on the "ep" sub-mesh only, replicated over "tp",
beside the Block unit's Megatron DTensors on the "tp" sub-mesh; the ep
group is the ranks of one tp index, so each tp index holds every expert
once.

Tensor parallelism (the mesh's "tp" dim, parallel/tensor_parallel.py):
each Megatron leaf (qkv and fc1 weight and bias, the attention proj's and
fc2's weights) becomes, before FSDP2 wraps it, a DTensor on the "tp"
sub-mesh with vitax's contiguous placement (`shard_tp`): torch dim 0 of
a column leaf, dim 1 of a row leaf, the rank keeping its 1/tp for good.
FSDP2 then shards that local tensor over "fsdp" (its TP composition, as
for the experts): a weight on its other dim, the rule table's; a 1-D
column bias on dim 0 again, which FSDP2 states as a _StridedShard of
its fsdp dim (`local_shard` takes it). The other leaves are replicated
over "tp", the MoE's router and experts among them: the model computes
them alike on every tp rank (it reduces the row-parallel partials before
they meet a replicated leaf, and runs the whole MoE on every tp rank), so
their grads need no tp reduction, and the grad norm sums the squares of
the tp leaves over the tp group and counts the replicated ones, experts
included, once (ops/fused_optimizer.py global_norm).

Pipeline parallelism (the mesh's "pp" dim, parallel/pipeline.py): a
stage model holds its stage's blocks only, and FSDP2 wraps it as any
model, on the (dp, fsdp) slice that holds the rank, a unit a block, so
ZeRO-3 gathers each block just in time inside the stage; the schedule
calls the root's `stage_forward` (an FSDP2 forward method, so the root's
lazy init, gathers and backward hooks run as under forward). The
embedding, the final norm and the head are replicated over "pp": only the
first stage uses the embedding and only the last the norm and head, so
after the backward `average_over_pp` sums their grads over the pp group
(a stage that never used a leaf gives zeros), leaving them equal on every
stage; the block leaves belong to one stage each, and the grad norm sums
their squares over the pp group (ops/fused_optimizer.py global_norm,
`pp_flags`).

Placements (`placement`) follow the rule table (parallel/rules.py): each
leaf shards its rule's dim over "fsdp". A leaf with no divisible dim is
replicated in vitax; FSDP2 shards every leaf, so it takes Shard(0),
padded. FSDP2 keeps every local shard contiguous, whatever its dim, so
the fused optimizer takes the local tensors as they are.

Communication precision (`comm_policies`, vitax's cast_to_compute and
CommPrecision): a unit's MixedPrecisionPolicy gathers its params in
--param_gather_dtype (bf16 by default: the cast of a shard commutes with
the gather) and reduces grads in --grad_reduce_dtype (f32 by default);
master params, grads and moments stay f32. vitax never casts the leaves
under KEEP_F32_PARAMS, consumed in f32 by the model (every LayerNorm's
weight and bias, the head). A policy covers a whole unit, so each of those
modules is a unit of its own with an f32 policy, nested in its Block or
the root. No unit casts its forward inputs: the model casts what it
computes on, so every op sees the dtype it sees unwrapped.

`init_sharded` (vitax's init_sharded_params) fills a model wrapped on the
meta device: for each leaf in init_params' order, the whole leaf is drawn
from the same generator on the run's device (the host under
--shard_on_cpu) and only the rank's shard is kept, so the params are
bitwise those of the unsharded build_model at every mesh, and one leaf is
resident at a time. A pipeline stage draws the other stages' leaves in
their turn too, into a scratch tensor it drops, so its own are the whole
model's leaf for leaf.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vitax_torch.models.moe import EXPERT_LEAVES, MoeMlp
from vitax_torch.models.vit import _DTYPES, build_model, init_leaves
from vitax_torch.parallel.mesh import dim_size
from vitax_torch.parallel.rules import is_expert_leaf, rule_pspec, tp_dim
from vitax_torch.parallel.tensor_parallel import tp_local

# Parameters the model consumes in float32 (vitax KEEP_F32_PARAMS): the head
# computes in f32 and LayerNorm folds its f32 scale in before the cast, so
# a bf16 gather would change the math. A module named so is its own unit.
KEEP_F32_PARAMS = ("head", "router", "norm", "norm1", "norm2")

def comm_policies(cfg):
    """(policy of the Block and root units, policy of the KEEP_F32_PARAMS
    units): params gathered in the resolved gather dtype (None: no cast,
    f32), grads reduced in --grad_reduce_dtype; the f32 units gather and
    reduce in f32. No unit casts its forward inputs."""
    from torch.distributed.fsdp import MixedPrecisionPolicy
    gather = torch.bfloat16 if cfg.comm_cast_active else None
    return (MixedPrecisionPolicy(param_dtype=gather, reduce_dtype=_DTYPES[cfg.grad_reduce_dtype],
                                 cast_forward_inputs=False),
            MixedPrecisionPolicy(param_dtype=None, reduce_dtype=torch.float32, cast_forward_inputs=False))


def placement(name: str, shape: Tuple[int, ...], fsdp: int, ep: int = 1, tp: int = 1):
    """The FSDP2 placement of one parameter over an fsdp dim of size `fsdp`
    (vitax param_pspec): Shard(d) on the dim its rule puts "fsdp" on, else
    Shard(0) (FSDP2 pads where vitax replicates; on a tp leaf that is its
    tp dim, shared). An expert leaf at ep > 1 has dim 0 over "ep": with no
    fsdp dim it takes Shard(1) at fsdp 1 and is refused above."""
    from torch.distributed.tensor import Shard
    spec = rule_pspec(name, tuple(shape), fsdp, ep, tp)
    if "fsdp" in spec:
        return Shard(spec.index("fsdp"))
    if "ep" in spec:
        if fsdp > 1:
            raise ValueError(f"{name} {tuple(shape)}: no dim past the experts divides over fsdp {fsdp}")
        return Shard(1)
    return Shard(0)


def _f32_modules(model: nn.Module):
    """Submodules named in KEEP_F32_PARAMS, innermost first."""
    named = [(n, m) for n, m in model.named_modules() if n and n.split(".")[-1] in KEEP_F32_PARAMS]
    return [m for _, m in sorted(named, key=lambda nm: -nm[0].count("."))]


def shard_experts(model: nn.Module, mesh) -> None:
    """Each MoeMlp's expert leaves as DTensor params sharded on the experts
    dim over the mesh's "ep" dim, the rank keeping its E/ep experts (on
    the meta device, shapes only). No-op at ep 1."""
    from torch.distributed.tensor import DTensor, Shard
    ep = dim_size(mesh, "ep")
    if ep == 1:
        return
    ep_mesh, index = mesh["ep"], mesh.get_local_rank("ep")
    for module in model.modules():
        if isinstance(module, MoeMlp):
            for name in EXPERT_LEAVES:
                p = getattr(module, name)
                mine = p.detach().chunk(ep, dim=0)[index].contiguous()
                setattr(module, name, nn.Parameter(DTensor.from_local(
                    mine, ep_mesh, [Shard(0)], run_check=False, shape=p.shape, stride=p.stride())))


def shard_tp(model: nn.Module, mesh) -> None:
    """Each Megatron leaf (rules.tp_dim) as a DTensor param sharded
    contiguously over the mesh's "tp" dim, the rank keeping its 1/tp (on
    the meta device, shapes only). The blocks must run tensor-parallel
    (built with a tensor_shard). No-op at tp 1."""
    from torch.distributed.tensor import DTensor, Shard
    tp = dim_size(mesh, "tp")
    if tp == 1:
        return
    if any(getattr(b.attn, "tensor_shard", None) is None for b in model.blocks):
        raise ValueError(f"tp {tp}: the model's blocks were built without a tensor_shard (build_model(..., "
                         f"tensor_shard=parallel.mesh.tensor_shard(mesh)))")
    tp_mesh, index = mesh["tp"], mesh.get_local_rank("tp")
    for name, p in list(model.named_parameters()):
        dim = tp_dim(name, p.dim())
        if dim is None:
            continue
        module = model.get_submodule(name.rpartition(".")[0])
        mine = tp_local(name, p.detach(), tp, index).contiguous()
        setattr(module, name.rpartition(".")[2], nn.Parameter(DTensor.from_local(
            mine, tp_mesh, [Shard(dim)], run_check=False, shape=p.shape, stride=p.stride())))


def apply_fsdp(model: nn.Module, cfg, mesh) -> nn.Module:
    """Shard `model` (built on the meta device, or on its device) over
    `mesh` in place: an f32 unit for each KEEP_F32_PARAMS module, at ep >
    1 a unit each MoeMlp (its experts sharded over "ep" first), a unit a
    Block (its Megatron leaves sharded over "tp" first), then the root.
    FSDP over the "fsdp" dim for ZeRO-3 and ZeRO-2 when dp is 1, HSDP over
    both dims otherwise. Returns the model."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    hsdp = cfg.run_without_fsdp or dim_size(mesh, "dp") > 1
    ep, tp = dim_size(mesh, "ep"), dim_size(mesh, "tp")
    shard_experts(model, mesh)
    shard_tp(model, mesh)
    names: Dict[int, str] = {id(p): n for n, p in model.named_parameters()}

    def placement_fn(p: nn.Parameter):
        return placement(names[id(p)], tuple(p.shape), dim_size(mesh, "fsdp"), ep, tp)

    compute, f32 = comm_policies(cfg)
    common = dict(mesh=mesh["dp", "fsdp"] if hsdp else mesh["fsdp"],
                  reshard_after_forward=cfg.reshard_after_forward and not cfg.run_without_fsdp,
                  shard_placement_fn=placement_fn)
    for module in _f32_modules(model):
        fully_shard(module, mp_policy=f32, **common)
    for module in model.modules() if ep > 1 else ():
        if isinstance(module, MoeMlp):          # its DTensor experts, apart from the Block's plain params
            fully_shard(module, mp_policy=compute, **common)
    blocks = list(model.blocks)
    # a recomputed block under dots_attn_saveable runs in two calls around
    # its core, from outside its forward (models/vit.py remat_block): each
    # gathers the block's params as its forward would. A forward without
    # grad (an eval) makes the same two calls inside the block's forward,
    # and under ZeRO-3 gathers once more for the second
    split = cfg.grad_ckpt and cfg.remat_policy == "dots_attn_saveable"
    for block in blocks:
        fully_shard(block, mp_policy=compute, **common)
        for method in ("attention_inputs", "finish") if split else ():
            register_fsdp_forward_method(block, method)
    fully_shard(model, mp_policy=compute, **common)
    if getattr(model, "pipe_shard", None) is not None:       # the pipeline's entry: the root's hooks run
        register_fsdp_forward_method(model, "stage_forward")
    if cfg.gather_overlap == "on":
        # explicit prefetch: block k+1's gather is issued at block k's forward,
        # block k-1's at block k's backward
        for a, b in zip(blocks, blocks[1:]):
            a.set_modules_to_forward_prefetch([b])
            b.set_modules_to_backward_prefetch([a])
    return model


def reshard(model: nn.Module) -> None:
    """Every FSDP2 unit of `model` back to its shards. A forward without a
    backward (an eval) leaves ZeRO-2's and DP's gathered params in place of
    the sharded ones; no-op unwrapped."""
    from torch.distributed.fsdp import FSDPModule
    for module in model.modules():
        if isinstance(module, FSDPModule):
            module.reshard()


def local_shard(full: torch.Tensor, dtensor) -> torch.Tensor:
    """This rank's shard of `full` under `dtensor`'s placements, in
    DTensor's (torch.chunk) split, empty chunks past the last. A strided
    shard (FSDP2's fsdp dim over a tp-sharded dim, split_factor > 1) cuts
    the piece the later mesh dims leave, as FSDP2 cut the tp-local tensor."""
    mesh, coord = dtensor.device_mesh, dtensor.device_mesh.get_coordinate()
    placements = list(enumerate(dtensor.placements))
    strided = [(i, p) for i, p in placements if getattr(p, "split_factor", 1) > 1]
    out = full
    for i, p in [ip for ip in placements if ip not in strided] + strided:
        dim = getattr(p, "dim", None)
        if dim is None:                         # Replicate
            continue
        chunks = torch.chunk(out, mesh.size(i), dim=dim)
        out = chunks[coord[i]] if coord[i] < len(chunks) else out.narrow(dim, 0, 0)
    return out


@torch.no_grad()
def init_sharded(model: nn.Module, cfg, device: torch.device) -> None:
    """Fill a model sharded by apply_fsdp and given storage (to_empty) with
    the unsharded init from cfg.seed: each leaf drawn whole, in
    init_params' order from one generator on `device` (or the host under
    --shard_on_cpu), and the rank's shard kept. A pipeline stage walks the
    whole model's leaves (a meta build), drawing those it does not hold
    into scratch."""
    from torch.distributed.tensor import DTensor
    draw_on = torch.device("cpu") if cfg.shard_on_cpu else torch.device(device)
    gen = torch.Generator(device=draw_on)
    gen.manual_seed(cfg.seed)
    if getattr(model, "pipe_shard", None) is None:
        leaves = init_leaves(model)
    else:
        whole = build_model(cfg, "meta")
        held, names = dict(model.named_parameters()), {id(p): n for n, p in whole.named_parameters()}
        leaves = ((held.get(names[id(p)], p), fill) for p, fill in init_leaves(whole))
    for param, fill in leaves:
        if param.device.type == "meta":         # another stage's leaf: its draws, then dropped
            fill(torch.empty(param.shape, dtype=param.dtype, device=draw_on), gen)
            continue
        if not isinstance(param, DTensor):
            fill(param, gen)
            continue
        full = torch.empty(param.shape, dtype=param.dtype, device=draw_on)
        fill(full, gen)
        param.to_local().copy_(local_shard(full, param))
        del full


def fsdp_group(mesh) -> Optional[object]:
    """The process group of the "fsdp" dim when it shards (size > 1)."""
    if dim_size(mesh, "fsdp") == 1:
        return None
    return mesh.get_group("fsdp")


def ep_group(mesh) -> Optional[object]:
    """The process group of the "ep" dim when it has more than one rank."""
    if dim_size(mesh, "ep") == 1:
        return None
    return mesh.get_group("ep")


def tp_group(mesh) -> Optional[object]:
    """The process group of the "tp" dim when it has more than one rank."""
    if dim_size(mesh, "tp") == 1:
        return None
    return mesh.get_group("tp")


def expert_flags(model: nn.Module) -> list:
    """For each parameter in named_parameters order, whether it is an MoE
    expert leaf (the rule table's expert rule)."""
    return [is_expert_leaf(n) for n, _ in model.named_parameters()]


def tp_flags(model: nn.Module) -> list:
    """For each parameter in named_parameters order, whether it is a
    Megatron leaf (sharded over "tp" at tp > 1); never an expert leaf,
    which the rule table's expert rule takes first."""
    return [tp_dim(n, p.dim()) is not None for n, p in model.named_parameters()]


def average_over_ep(grads, expert, group) -> None:
    """Under expert parallelism, each grad (its local shard) to the mean
    over every batch rank, in place: a dense grad, which FSDP2 averaged
    over (dp, fsdp), summed over the ep group (one all-reduce a leaf, all
    issued before the first wait); an expert grad, which already sums its
    ep peers' tokens, not reduced; then every grad times 1/ep. No-op
    without a group."""
    if group is None:
        return
    import torch.distributed as dist
    pairs = [(g, e) for g, e in zip(grads, expert) if g is not None]
    works = [dist.all_reduce(g, group=group, async_op=True) for g, e in pairs if not e]
    for work in works:
        work.wait()
    torch._foreach_mul_([g for g, _ in pairs], 1.0 / dist.get_world_size(group))


def pp_group(mesh) -> Optional[object]:
    """The process group of the "pp" dim when it has more than one stage."""
    if dim_size(mesh, "pp") == 1:
        return None
    return mesh.get_group("pp")


def pp_flags(model: nn.Module) -> list:
    """For each parameter in named_parameters order, whether it is a block
    leaf (held by one pipeline stage; the others are replicated over pp)."""
    return [n.startswith("blocks.") for n, _ in model.named_parameters()]


def average_over_pp(model: nn.Module, group) -> None:
    """Under pipeline parallelism, each replicated leaf's grad (its local
    shard; zeros where this stage never used the leaf) summed over the pp
    group in place, one all-reduce a leaf, all issued before the first
    wait: the stage that used it holds its grad, the others add zeros, and
    every stage ends with the same bits. The block leaves are left alone.
    No-op without a group."""
    if group is None:
        return
    import torch.distributed as dist
    from vitax_torch.train.state import local
    grads = []
    for (name, p), block in zip(model.named_parameters(), pp_flags(model)):
        if block:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(local(p.grad))
    works = [dist.all_reduce(g, group=group, async_op=True) for g in grads]
    for work in works:
        work.wait()


def sp_group(mesh) -> Optional[object]:
    """The process group of the "sp" dim when it has more than one rank."""
    if dim_size(mesh, "sp") == 1:
        return None
    return mesh.get_group("sp")


def average_over_sp(grads, group) -> None:
    """Average each grad (its local shard) over the sp group, in place: a
    SUM all-reduce a leaf, all issued before the first wait, then 1/S. The
    ranks of the group end with equal grads, so the grad norm over the
    fsdp dim counts each element once. No-op without a group."""
    if group is None:
        return
    import torch.distributed as dist
    grads = [g for g in grads if g is not None]         # a probe's frozen leaves have none
    works = [dist.all_reduce(g, group=group, async_op=True) for g in grads]
    for work in works:
        work.wait()
    torch._foreach_mul_(grads, 1.0 / dist.get_world_size(group))
