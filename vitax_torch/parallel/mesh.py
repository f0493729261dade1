"""The device mesh (vitax/parallel/mesh.py): one process per card, the
processes arranged as a `DeviceMesh` with dims ("dp", "fsdp", "tp", "sp",
"pp", "ep"), vitax's six in vitax's order.

- "dp":   pure data parallelism (params replicated across it);
- "fsdp": ZeRO-3: params, grads and AdamW moments sharded across it; it
          carries the batch too;
- "tp":   tensor parallelism (Megatron column/row placements,
          parallel/tensor_parallel.py): the qkv/fc1 and proj/fc2 weights are
          sharded across it, each rank runs H/tp whole heads and 1/tp of the
          MLP hidden; its ranks read the same batch rows (vitax's
          BATCH_AXES leave "tp" out);
- "sp":   sequence parallelism: the token axis of the activations is
          sharded across it (ring or Ulysses attention, parallel/); params
          are replicated across it and its ranks read the same batch rows
          (vitax's BATCH_AXES leave "sp" out);
- "pp":   pipeline parallelism (parallel/pipeline.py): stage s of S holds
          blocks [s L/S, (s + 1) L/S); the embedding, the final norm and
          the head are replicated across it, and its ranks read the same
          batch rows (vitax replicates the batch over "pp");
- "ep":   expert parallelism (models/moe.py): it carries the batch like
          dp, dense params are replicated across it, and each of its ranks
          holds E/ep experts of every MoE block.

The reference's FSDP is mesh (1, n, 1, 1, 1, 1); its --run_without_fsdp
DP baseline (n, 1, 1, 1, 1, 1). The ranks fill the mesh row-major with
"ep" fastest, then "pp", "sp" and "tp", as vitax reshapes its devices over
(dp, fsdp, tp, sp, pp, ep), so rank r holds the batch rows, the token
slice, the heads, the stage and the experts that vitax's device r holds.
The ranks of one batch shard are therefore not neighbours in general
(those of a tp group sit sp * pp * ep apart), so every shard index here
is computed from the rank's coordinates. An ep group under tp is the
ranks that share the tp index and every other coordinate (consecutive
ranks: ep is fastest), so its all-to-alls and average_over_ep pair the
ranks that hold the experts of one tp index. `resolve_mesh_shape` is vitax's, so its
errors are vitax's. MoE runs under sp, under tp and under tp beside ep;
Config.validate refuses what vitax has no green reference for (item 11):
pp beside tp, and MoE under sp beside ep > 1, which `mesh_sizes` also
refuses where a -1 size resolves to it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from vitax_torch import distributed

MESH_DIMS = ("dp", "fsdp", "tp", "sp", "pp", "ep")    # the port's DeviceMesh (vitax/parallel/mesh.py:37)
BATCH_DIMS = ("dp", "fsdp", "ep")         # the dims that carry the global batch (vitax BATCH_AXES)


def resolve_mesh_shape(cfg, n_devices: Optional[int] = None) -> Tuple[int, ...]:
    """Resolve (dp, fsdp, tp, sp, pp, ep) against the device count (default:
    the process count, one card each), as vitax resolves it. One axis may
    be -1 (= all remaining devices). `--run_without_fsdp` forces everything
    onto dp (the reference's pure-DP baseline)."""
    n = n_devices if n_devices is not None else distributed.process_count()
    dp, fsdp, tp, sp = cfg.dp_size, cfg.fsdp_size, cfg.tp_size, cfg.sp_size
    pp = getattr(cfg, "pp_size", 1)
    ep = getattr(cfg, "ep_size", 1)

    if cfg.run_without_fsdp:
        if fsdp not in (-1, 1):
            raise ValueError("--run_without_fsdp is incompatible with --fsdp_size > 1")
        fsdp = 1
        if dp == 1 and tp == 1 and sp == 1 and pp == 1 and ep == 1:
            dp = -1  # default DP baseline: all devices data-parallel

    if pp > 1:
        if fsdp == 1 and dp == 1:
            dp = -1
        elif dp == -1 and fsdp == -1:
            fsdp = 1

    sizes = [dp, fsdp, tp, sp, pp, ep]
    n_auto = sum(1 for s in sizes if s == -1)
    if n_auto > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {sizes}")
    fixed = math.prod(s for s in sizes if s != -1)
    if n_auto == 1:
        if n % fixed != 0:
            raise ValueError(f"device count {n} not divisible by fixed mesh axes {sizes}")
        sizes[sizes.index(-1)] = n // fixed
    elif fixed != n:
        raise ValueError(f"mesh {sizes} does not cover {n} devices")
    return tuple(sizes)


def mesh_sizes(cfg, n_devices: Optional[int] = None) -> Tuple[int, ...]:
    """The sizes of MESH_DIMS: vitax's resolved sizes. A tp, sp, pp or ep
    size resolved from -1 is held to what Config.validate holds a given
    one to."""
    sizes = resolve_mesh_shape(cfg, n_devices)
    tp, sp, pp, ep = sizes[2], sizes[3], sizes[4], sizes[5]
    if getattr(cfg, "moe_experts", 0) > 0 and sp > 1 and ep > 1:
        raise ValueError(cfg.sp_ep_refusal(sp, ep))
    if tp > 1 and cfg.tp_size == -1:
        cfg.check_tp(tp)
    if pp > 1 and cfg.pp_size == -1:
        dataclasses.replace(cfg, pp_size=pp).check_pp()
    return sizes


def build_mesh(cfg, device: torch.device):
    """The ("dp", "fsdp", "tp", "sp", "pp", "ep") DeviceMesh over every process,
    on `device`'s type; the process group must be up
    (distributed.maybe_initialize)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type, mesh_sizes(cfg), mesh_dim_names=MESH_DIMS)


def dim_size(mesh, dim: str) -> int:
    """The size of mesh dim `dim` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(MESH_DIMS.index(dim))


def linear_index(coords, sizes, dims) -> int:
    """The row-major index of the coordinates of `dims` (a subset of
    MESH_DIMS, in the order given), as vitax linearizes shard_map axes."""
    index = 0
    for dim in dims:
        i = MESH_DIMS.index(dim)
        index = index * sizes[i] + coords[i]
    return index


def batch_shard(mesh) -> Tuple[int, int]:
    """(index, count): this rank's slice of the global batch, the
    counterpart of vitax's batch_pspec P(("dp", "fsdp", "ep")). The index is the
    rank's linearized coordinate over BATCH_DIMS; a loader takes the
    batch's rows index::count, and `fold_shard_seed` folds it into the
    dropout seeds. The ranks of one sp group share it. Without a mesh:
    (0, 1)."""
    if mesh is None:
        return 0, 1
    sizes = tuple(mesh.shape)
    return (linear_index(mesh.get_coordinate(), sizes, BATCH_DIMS),
            math.prod(dim_size(mesh, d) for d in BATCH_DIMS))


def sp_shard(mesh) -> Tuple[int, int]:
    """(index, count): this rank's place in its sp group, whose token slice
    is [index * N / count, (index + 1) * N / count). Without a mesh: (0, 1)."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank("sp"), dim_size(mesh, "sp")


def tp_shard(mesh) -> Tuple[int, int]:
    """(index, count): this rank's place in its tp group, whose heads are
    [index * H / count, (index + 1) * H / count). Without a mesh: (0, 1)."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank("tp"), dim_size(mesh, "tp")


def rank_coordinates(rank: int, sizes: Tuple[int, ...]) -> Tuple[int, ...]:
    """The coordinates over MESH_DIMS of `rank` in a row-major mesh of `sizes`."""
    coords = []
    for size in reversed(sizes):
        coords.append(rank % size)
        rank //= size
    return tuple(reversed(coords))


def data_shard(cfg) -> Tuple[int, int]:
    """(index, count) of the rows this process reads of each global batch,
    from the process group alone (the loaders are built before the mesh):
    the batch shard of `batch_shard`, the rank's linearized (dp, fsdp, ep)
    coordinate."""
    rank, world = distributed.process_index(), distributed.process_count()
    if world == 1:
        return 0, 1
    sizes = mesh_sizes(cfg, world)
    return (linear_index(rank_coordinates(rank, sizes), sizes, BATCH_DIMS),
            math.prod(sizes[MESH_DIMS.index(d)] for d in BATCH_DIMS))


class TokenShard(NamedTuple):
    """The token slice a rank's model runs on: its index in the sp group,
    the group's size and its process group."""
    index: int
    count: int
    group: object


def token_shard(cfg, mesh) -> Optional[TokenShard]:
    """The rank's TokenShard when sp shards the tokens, else None: sp 1, or
    a token count sp does not divide, which leaves the tokens whole on
    every rank (vitax/train/loop.py _token_sharding; its attention core is
    then the unsharded one)."""
    index, count = sp_shard(mesh)
    if count == 1 or cfg.num_patches % count:
        return None
    return TokenShard(index, count, mesh.get_group("sp"))


class ExpertShard(NamedTuple):
    """The experts a rank's MoE blocks hold: its index in the ep group, the
    group's size (each rank holds E / count experts, [index E / count,
    (index + 1) E / count)) and its process group."""
    index: int
    count: int
    group: object


def expert_shard(mesh) -> Optional[ExpertShard]:
    """The rank's ExpertShard when ep shards the experts (size > 1), else None."""
    if dim_size(mesh, "ep") == 1:
        return None
    return ExpertShard(mesh.get_local_rank("ep"), dim_size(mesh, "ep"), mesh.get_group("ep"))


class TensorShard(NamedTuple):
    """The heads and MLP features a rank's blocks hold: its index in the tp
    group, the group's size (each rank runs heads [index H / count, (index
    + 1) H / count) and the same slice of the MLP hidden) and its process
    group."""
    index: int
    count: int
    group: object


def tensor_shard(mesh) -> Optional[TensorShard]:
    """The rank's TensorShard when tp shards the blocks (size > 1), else None."""
    if dim_size(mesh, "tp") == 1:
        return None
    return TensorShard(mesh.get_local_rank("tp"), dim_size(mesh, "tp"), mesh.get_group("tp"))


class PipeShard(NamedTuple):
    """The rank's pipeline stage: its index, the stage count, the pp
    process group, and the global ranks of the previous and the next
    stage's rank at the same other coordinates (None past either end)."""
    index: int
    count: int
    group: object
    prev: Optional[int]
    next: Optional[int]

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.count - 1

    def layers(self, num_blocks: int) -> range:
        """The global block indices this stage holds."""
        per = num_blocks // self.count
        return range(self.index * per, (self.index + 1) * per)


def pipe_shard(mesh) -> Optional[PipeShard]:
    """The rank's PipeShard when pp splits the blocks (size > 1), else None."""
    count = dim_size(mesh, "pp")
    if count == 1:
        return None
    import torch.distributed as dist
    group, index = mesh.get_group("pp"), mesh.get_local_rank("pp")

    def peer(i: int) -> Optional[int]:
        return dist.get_global_rank(group, i) if 0 <= i < count else None
    return PipeShard(index, count, group, peer(index - 1), peer(index + 1))


def pp_shard_index(mesh) -> int:
    """vitax's pipeline shard index: the rank's linearized (dp, fsdp, ep,
    sp) coordinate (vitax/parallel/pipeline.py:273-283), which its
    pipeline folds into the step's dropout key. 0 without a mesh."""
    if mesh is None:
        return 0
    return linear_index(mesh.get_coordinate(), tuple(mesh.shape), ("dp", "fsdp", "ep", "sp"))
