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
resident at a time.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vitax_torch.models.vit import _DTYPES, init_leaves
from vitax_torch.parallel.rules import rule_pspec

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


def placement(name: str, shape: Tuple[int, ...], fsdp: int):
    """The FSDP2 placement of one parameter over an fsdp dim of size `fsdp`
    (vitax param_pspec): Shard(d) on the dim its rule puts "fsdp" on, else
    Shard(0) (FSDP2 pads where vitax replicates)."""
    from torch.distributed.tensor import Shard
    spec = rule_pspec(name, tuple(shape), fsdp)
    return Shard(spec.index("fsdp") if "fsdp" in spec else 0)


def _f32_modules(model: nn.Module):
    """Submodules named in KEEP_F32_PARAMS, innermost first."""
    named = [(n, m) for n, m in model.named_modules() if n and n.split(".")[-1] in KEEP_F32_PARAMS]
    return [m for _, m in sorted(named, key=lambda nm: -nm[0].count("."))]


def apply_fsdp(model: nn.Module, cfg, mesh) -> nn.Module:
    """Shard `model` (built on the meta device, or on its device) over
    `mesh` in place: an f32 unit for each KEEP_F32_PARAMS module, a unit a
    Block, then the root. FSDP over the "fsdp" dim for ZeRO-3 and ZeRO-2
    when dp is 1, HSDP over both dims otherwise. Returns the model."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    hsdp = cfg.run_without_fsdp or mesh.size(0) > 1
    names: Dict[int, str] = {id(p): n for n, p in model.named_parameters()}

    def placement_fn(p: nn.Parameter):
        return placement(names[id(p)], tuple(p.shape), mesh.size(1))

    compute, f32 = comm_policies(cfg)
    common = dict(mesh=mesh if hsdp else mesh["fsdp"],
                  reshard_after_forward=cfg.reshard_after_forward and not cfg.run_without_fsdp,
                  shard_placement_fn=placement_fn)
    for module in _f32_modules(model):
        fully_shard(module, mp_policy=f32, **common)
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
    DTensor's (torch.chunk) split, empty chunks past the last."""
    from torch.distributed.tensor import Shard
    mesh, coord = dtensor.device_mesh, dtensor.device_mesh.get_coordinate()
    out = full
    for i, p in enumerate(dtensor.placements):
        if isinstance(p, Shard):
            chunks = torch.chunk(out, mesh.size(i), dim=p.dim)
            out = chunks[coord[i]] if coord[i] < len(chunks) else out.narrow(p.dim, 0, 0)
    return out


@torch.no_grad()
def init_sharded(model: nn.Module, cfg, device: torch.device) -> None:
    """Fill a model sharded by apply_fsdp and given storage (to_empty) with
    the unsharded init from cfg.seed: each leaf drawn whole, in
    init_params' order from one generator on `device` (or the host under
    --shard_on_cpu), and the rank's shard kept."""
    from torch.distributed.tensor import DTensor
    draw_on = torch.device("cpu") if cfg.shard_on_cpu else torch.device(device)
    gen = torch.Generator(device=draw_on)
    gen.manual_seed(cfg.seed)
    for param, fill in init_leaves(model):
        if not isinstance(param, DTensor):
            fill(param, gen)
            continue
        full = torch.empty(param.shape, dtype=param.dtype, device=draw_on)
        fill(full, gen)
        param.to_local().copy_(local_shard(full, param))
        del full


def fsdp_group(mesh) -> Optional[object]:
    """The process group of the "fsdp" dim when it shards (size > 1)."""
    if mesh is None or mesh.size(1) == 1:
        return None
    return mesh.get_group("fsdp")
